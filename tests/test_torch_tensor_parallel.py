"""The port's tensor parallelism over a ``model`` axis on the CPU: the rule
against the JAX package's ``infer_param_shardings`` leaf for leaf (the lite
cascade and a dim-64 default cascade, shapes only, at `min_shard_dim` 32
and 128); the train step over gloo groups of 2 (``model 2``) and 4
(``data 2 x model 2``) processes (``tests/torch_mesh_workers.py``), alone
and composed with ZeRO-1, against the port's one-device step (float32:
losses 1e-5 relative, parameters and EMA 1e-5 relative L2) and, with
clip-50 SGD at the same injected draws, against the JAX package's step on
its {data 4, model 2} mesh of 8 virtual devices at the limits of its own
test (rtol 2e-4, ``tests/test_parallel.py:81-109``); per-process bytes
against the plan's reckoning; ``sample(mesh=)`` against ``sample()``
(rtol 5e-5, atol 5e-6, ``test_parallel.py:716-736``); two stage groups
with a model axis serving through the pipeline and training the cascade
against one device; ``fsdp_plan`` and an
uneven model axis refused; sharded dumps restored across ``{data 2}``,
``{data 1, model 2}``, ``{data 2, model 2}`` and one device; and a
``MinimagenTrain`` run on ``{data 2, model 2}`` whose U-Net checkpoints the
JAX package reads.

The test cascade (BaseTest + SuperTest, dim 8) is split at `TP_MIN` = 2 so
that its every kernel whose output divides splits, the stems' included; the
JAX test's dim-64 U-Net is split by the default rule (128)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_mesh_workers as W
from jax.sharding import Mesh as JMesh
from test_torch_parallel import _flat, _jax_draws, _rel_l2
from test_torch_parallel_plan import _jax_shapes, _kinds, _random_state

from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu.training import load_unet_checkpoint as jax_load_unet_checkpoint
from minimagen_tpu_torch import checkpoint as tckpt
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.checkpoint import flax_unet_tree, unet_state_dict
from minimagen_tpu_torch.generate import lite_imagen
from minimagen_tpu_torch.models.imagen import Imagen
from minimagen_tpu_torch.models.unet import Base, Super
from minimagen_tpu_torch.parallel import checkpoint as pckpt
from minimagen_tpu_torch.parallel import collectives
from minimagen_tpu_torch.parallel import mesh as pmesh
from minimagen_tpu_torch.parallel.collectives import Group

WORLDS = (2, 4)
JAX_KEY = 11
LOSS_RTOL = PARAM_REL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's processes' results and the TP harness run (all at
    once), and meanwhile the JAX package's TP step (clip-50 SGD, two steps)
    with its losses and parameters (flattened in the port's order)."""
    run_dir = str(tmp_path_factory.mktemp("tp_run") / "training_tp")
    ref = JImagen(unets=[J.BaseTest(), J.SuperTest()], **W.IMAGEN_KW)
    ours = W.cascade_imagen()
    key = jax.random.PRNGKey(JAX_KEY)
    draws = [_jax_draws(ref, key, step, W.BATCH) for step in range(2)]
    jobs = {w: ("torch_mesh_workers:scenarios", w,
                {"run": ["tp_scenarios"] + (["tp_stage_scenarios"] if w == 4 else []),
                 "jax_draws": draws}, {}) for w in WORLDS}
    jobs["harness"] = ("torch_mesh_workers:harness_run", 4,
                       {"run_dir": run_dir, "zero1": "on", "model_parallel": 2}, {})
    wait = W.start(jobs)
    params = {f"unet_{i}": jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                                  flax_unet_tree(u))
              for i, u in enumerate(ours.unets)}
    mesh = jmesh.make_mesh(model_parallel=2)  # {'data': 4, 'model': 2}
    shardings = jmesh.infer_param_shardings(params, mesh, min_shard_dim=W.TP_MIN)
    opt = optax.chain(optax.clip_by_global_norm(50.0), optax.sgd(1e-2))
    state = jmesh.create_train_state(jmesh.place_params(params, shardings), opt)
    step = jmesh.make_train_step(ref, opt, mesh=mesh, donate=False)
    losses = []
    for i in range(2):
        state, l_ = step(state, jmesh.shard_batch(W.batch(seed=10 + i), mesh), key)
        losses.append(np.asarray(l_))
    names = [[n for n, _ in u.named_parameters()] for u in ours.unets]
    jax_params = _flat(unet_state_dict(jax.tree_util.tree_map(np.asarray,
                                                              state.params[f"unet_{i}"]))[n]
                       for i in range(2) for n in names[i])
    results = wait()
    return {"results": results, "run_dir": run_dir,
            "jax": {"losses": np.stack(losses), "params": jax_params}}


def _tp(runs, world, rank=0):
    return runs["results"][world][rank]["tp_scenarios"]


# --------------------------------------------------------------------------- #
# the rule, without processes                                                  #
# --------------------------------------------------------------------------- #
def _cascade(name):
    with torch.device("meta"):
        if name == "lite":
            return lite_imagen(device="meta")
        return Imagen(unets=[Base(dim=64), Super(dim=64)], image_sizes=(64, 128),
                      timesteps=1000, cond_drop_prob=0.15, text_encoder_name="t5_base",
                      device="meta")


@pytest.mark.parametrize("min_shard_dim", [32, 128])
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["lite", "default dim 64"])
def test_the_rule_is_infer_param_shardings(name, model, min_shard_dim):
    """Every parameter's split axis under ``model_axes`` is the JAX rule's
    on the same tree (through the checkpoints' layout mapping), and the
    kernels split are the weights of Dense, Conv and Conv2d modules."""
    imagen = _cascade(name)
    jax_mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(8 // model, model), ("data", "model"))
    tree = {f"unet_{i}": _jax_shapes(u) for i, u in enumerate(imagen.unets)}
    shardings = jmesh.infer_param_shardings(tree, jax_mesh, min_shard_dim=min_shard_dim)
    axes = iter(pmesh.model_axes(imagen.unets, model, min_shard_dim))
    split = 0
    for s, unet in enumerate(imagen.unets):
        kernels = pmesh.kernel_names(unet)
        for pname, p in unet.named_parameters():
            path = pname.split(".")
            path[-1] = "kernel" if path[-1] == "weight" else path[-1]
            node = shardings[f"unet_{s}"]
            for k in path:
                node = node[k]
            spec = tuple(node.spec)
            want = spec.index("model") if "model" in spec else None
            axis = next(axes)
            got = None if axis is None else pmesh.jax_axes(pname, p.dim()).index(axis)
            assert got == want, pname
            assert axis is None or pname in kernels
            split += axis is not None
    assert split > 0


def _fake_mesh(data, model, index):
    """The mesh of process `index` of a data x model grid, without a
    process group (process r at data index r // model, model index r %
    model)."""
    cpu = torch.device("cpu")
    d, m = divmod(index, model)
    data_g = Group(None, tuple(range(m, data * model, model)), d, "gloo", cpu)
    if model == 1:
        return pmesh.Mesh(data_g)
    model_g = Group(None, tuple(range(d * model, d * model + model)), m, "gloo", cpu)
    return pmesh.Mesh(data_g, model_g, Group(None, tuple(range(data * model)), index, "gloo", cpu))


def test_fsdp_and_an_uneven_model_axis_are_refused():
    imagen = W.cascade_imagen()
    mesh = _fake_mesh(2, 2, 0)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.is_leader
    assert not _fake_mesh(2, 2, 1).is_leader
    with pytest.raises(ValueError, match="pure data-parallel mesh"):
        pmesh.fsdp_plan(imagen.unets, mesh)
    with pytest.raises(ValueError, match="do not divide by model_parallel=2"):
        pmesh.make_mesh(Group(None, (0, 1, 2), 0, "gloo", torch.device("cpu")), model_parallel=2)


# --------------------------------------------------------------------------- #
# the spawned groups                                                           #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world", WORLDS)
def test_processes_sit_on_the_jax_grid(runs, world):
    """Rank r at data index r // 2 and model index r % 2 (``mesh.py:47``)."""
    for r in range(world):
        out = _tp(runs, world, r)
        assert out["shape"] == {"data": world // 2, "model": 2}
        assert out["coords"] == (r // 2, r % 2)


@pytest.mark.parametrize("world", WORLDS)
def test_the_tp_step_matches_the_one_device_step(runs, world):
    out = _tp(runs, world)
    modes = ("tp", "tp_zero1") if world > 2 else ("tp",)
    for opt in ("sgd", "adam"):
        for mode in modes if opt == "adam" else ("tp",):
            got, one = out[f"{opt}_{mode}"], out[f"{opt}_one"]
            np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
            assert _rel_l2(got["params"], one["params"]) <= PARAM_REL, (opt, mode)
            if opt == "adam":
                assert _rel_l2(got["ema"], one["ema"]) <= PARAM_REL, mode


@pytest.mark.parametrize("world", WORLDS)
def test_the_tp_step_matches_the_jax_tp_step(runs, world):
    tp, jax_run = _tp(runs, world)["sgd_tp"], runs["jax"]
    np.testing.assert_allclose(tp["losses"], jax_run["losses"], rtol=2e-4)
    np.testing.assert_allclose(tp["params"], jax_run["params"], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_state(runs, world):
    first = _tp(runs, world)
    for r in range(1, world):
        other = _tp(runs, world, r)
        for key in ("adam_tp", "sgd_tp"):
            for kind in ("params", "losses"):
                np.testing.assert_array_equal(other[key][kind], first[key][kind])


@pytest.mark.parametrize("world", WORLDS)
def test_per_process_bytes_are_the_plans(runs, world):
    """Parameters split over ``model``; under ZeRO-1 the moments, the
    accumulators and the EMA split over ``data`` within each block."""
    out = _tp(runs, world)
    tp = out["bytes_tp"]
    assert tp["measured"] == tp["reckoned"] < tp["one_device"] and tp["split"] > 0
    assert tp["data_split"] == 0
    if world > 2:
        z = out["bytes_tp_zero1"]
        assert z["measured"] == z["reckoned"] < tp["measured"] and z["data_split"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sample_on_a_model_axis_matches_sample(runs, world):
    out = _tp(runs, world)
    jax_unet, cascade = out["jax_unet"], out["cascade"]
    assert jax_unet["split"] > 0  # placed by sample(mesh=) itself, by the default rule
    np.testing.assert_allclose(jax_unet["mesh"], jax_unet["one"], rtol=5e-5, atol=5e-6)
    assert cascade["placed"] > 0 and cascade["stems"] == ["GatheredStem"] * 2
    assert cascade["mesh"].shape == (W.BATCH, 16, 16, 3)
    np.testing.assert_allclose(cascade["mesh"], cascade["one"], rtol=5e-5, atol=5e-6)


def test_stage_groups_with_a_model_axis_serve_and_train(runs):
    """Two stage groups of {data 1, model 2} (``make_stage_meshes(2,
    model_parallel=2)``): the pipelined server's images and the cascade
    trainer's losses and weights against one device's."""
    ranks = [runs["results"][4][r]["tp_stage_scenarios"] for r in range(4)]
    assert [r["stage"] for r in ranks] == [0, 0, 1, 1]
    assert ranks[0]["groups"] == [[0, 1], [2, 3]]
    assert all(r["shape"] == {"data": 1, "model": 2} and r["placed"] > 0 for r in ranks)
    for r in ranks[2:]:
        for got, want in zip(r["served"], r["reference"]):
            np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-6)
    for r in ranks:
        t = r["trainer"]
        np.testing.assert_allclose(t["losses"][:, r["stage"]], t["ref_losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["params"], t["ref_params"], rtol=2e-4, atol=1e-6)


def test_a_tp_runs_unet_checkpoint_is_read_by_the_jax_package(runs):
    """``MinimagenTrain`` on {data 2, model 2} (ZeRO-1 on the blocks): every
    process saw the same losses; process 0 wrote whole tensors, which the
    JAX package reads, equal to every process's gathered weights; the dump
    records both axes and restores on one device."""
    run_dir, ranks = runs["run_dir"], runs["results"]["harness"]
    assert [r["shape"] for r in ranks] == [{"data": 2, "model": 2}] * 4
    for r in ranks:
        assert r["summary"]["final_step"] == r["summary"]["adam_count"] == 4
        np.testing.assert_array_equal(r["summary"]["history"][-1]["valid"],
                                      ranks[0]["summary"]["history"][-1]["valid"])
    imagen = W.cascade_imagen()
    for i in range(2):
        template = jax.tree_util.tree_map(lambda t: t.numpy(), flax_unet_tree(imagen.unets[i]))
        tree = jax_load_unet_checkpoint(os.path.join(run_dir, "tmp", f"unet_{i}_tmp.ckpt"),
                                        template)
        got = unet_state_dict(jax.tree_util.tree_map(np.asarray, tree))
        for r in ranks:
            want = r["weights"][f"unet_{i}"]
            assert set(got) == set(want)
            for name, w in want.items():
                np.testing.assert_array_equal(got[name].numpy(), w)
    root = os.path.join(run_dir, "tmp", ttrain.SHARDED_STATE_DIR)
    (dump,) = os.listdir(root)
    manifest = json.load(open(os.path.join(root, dump, "manifest.json")))
    assert manifest["mesh"] == {"data": 2, "model": 2} and manifest["world_size"] == 4
    assert any(leaf["model_axis"] is not None and leaf["axis"] is not None
               for leaf in manifest["leaves"])
    state = ttrain.create_train_state(W.cascade_imagen(), ttrain.make_optimizer(1e-4), ema=True)
    ttrain.load_dump(root, state)
    ema = {(i, n): t for (i, n), t in zip(state.names, state.ema_params)}
    for i in range(2):
        for name, w in ranks[0]["weights"][f"unet_{i}"].items():
            np.testing.assert_array_equal(ema[(i, name)].numpy(), w)


# --------------------------------------------------------------------------- #
# sharded dumps across mesh shapes, without processes                          #
# --------------------------------------------------------------------------- #
@pytest.fixture
def no_group(monkeypatch):
    """Meshes without a process group: the init's broadcast left out (every
    process builds seed 0's cascade), a barrier ends at once, and every
    process of a save agrees on the dump's name."""
    monkeypatch.setattr(pmesh, "broadcast_params", lambda params, mesh: None)
    monkeypatch.setattr(collectives, "barrier", lambda group: None)
    monkeypatch.setattr(collectives, "broadcast_object", lambda obj, group, src=0: "dump_000001")


SHAPES = [(2, 1), (1, 2), (2, 2)]


def _tp_state(opt, shape, index):
    imagen = W.cascade_imagen()
    if shape is None:
        return ttrain.create_train_state(imagen, opt, ema=True), None
    mesh = _fake_mesh(*shape, index)
    plan = pmesh.zero1_plan(imagen.unets, mesh, min_size=1, min_shard_dim=W.TP_MIN)
    return ttrain.create_train_state(imagen, opt, ema=True, mesh=mesh, plan=plan), mesh


@pytest.mark.parametrize("src", SHAPES)
def test_a_dump_restores_across_mesh_shapes(tmp_path, no_group, src):
    """A one-device state loaded into every process of a `src` mesh
    (ZeRO-1, and split over ``model`` where it has one) and dumped; the
    dump read into every process of each mesh shape and into one device:
    every tensor is the one-device state's part."""
    opt = ttrain.make_optimizer(1e-3, accum_iter=2)
    one = _random_state(opt)
    tckpt.save_train_state(str(tmp_path / "s.ckpt"), one)
    root = str(tmp_path / "sharded")
    n = src[0] * src[1]
    for index in reversed(range(n)):  # process 0 writes the manifest once the others are there
        state, _ = _tp_state(opt, src, index)
        tckpt.load_train_state(str(tmp_path / "s.ckpt"), state)
        pckpt.save_sharded_state(root, state)
    dump = os.path.join(root, "dump_000001")
    assert sorted(os.listdir(dump)) == ["manifest.json"] + [f"rank_{r:05d}.ckpt" for r in range(n)]
    assert json.load(open(os.path.join(dump, "manifest.json")))["mesh"] == dict(
        zip(("data", "model"), src))
    for dst in SHAPES + [None]:
        for index in range(dst[0] * dst[1] if dst else 1):
            state, mesh = _tp_state(opt, dst, index)
            pckpt.load_sharded_state(root, state)
            assert (state.step, state.opt_state.count, state.opt_state.mini_step) == (6, 3, 1)
            for kind, tensors in _kinds(state).items():
                for i, (got, want) in enumerate(zip(tensors, _kinds(one)[kind])):
                    part = want if mesh is None else state.plan.part(i, want, mesh, got.shape)
                    assert torch.equal(got, part), (dst, index, kind, i)
            for i, (got, want) in enumerate(zip(state.param_targets(), one.params)):
                part = want.detach() if mesh is None else state.plan.part(
                    i, want.detach(), mesh, got.shape)
                assert torch.equal(got, part), (dst, index, "params", i)
            if mesh is not None and mesh.model_size > 1:
                assert any(a is not None for a in state.plan.model_axes)
                assert any(p.shape != s for p, s in zip(state.params, state.shapes))
