"""The port's data-parallel, ZeRO-1 and FSDP steps and mesh sampling on the
CPU, over gloo groups of 2 and 4 processes (``tests/torch_mesh_workers.py``
runs in each; one group per world size runs every scenario, both groups at
once while this process runs the JAX reference), against the
port's one-device step and sample and, for data parallelism, the JAX
package's mesh step on its 8 virtual devices at the same injected draws
(rtol 2e-4, atol 1e-6, as ``tests/test_parallel.py`` holds its own).

Tolerances: a step whose update is linear in the gradients (clip-50 SGD)
is held element by element; with Adam (lr 1e-4, as the JAX package's
ZeRO-1 test, accumulation 2, EMA) the losses are held to 2e-4 relative and
the parameters and EMA to 1e-5 relative L2, not element by element: Adam's
m / sqrt(v) turns float32 reduction-order noise in near-zero gradients into
updates of up to lr (on this model the update itself differs by ~1%
relative L2 between any two reduction orders). Over two processes a
gradient's sum has one order, so there the sharded steps are held to the
bits of plain data parallelism.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_mesh_workers as W

from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch.checkpoint import flax_unet_tree, unet_state_dict

WORLDS = (2, 4)
JAX_KEY = 11


def _jax_draws(ref, key, step, b):
    """The draws of the JAX train step at `step` (mesh.py:346-347 and
    imagen.py:1164,1232-1243), as numpy arrays per stage."""
    keys = jax.random.split(jax.random.fold_in(key, step), ref.num_unets)
    draws = []
    for i, size in enumerate(ref.image_sizes):
        times_key, aug_key, p_key = jax.random.split(keys[i], 3)
        noise_key, lowres_key, drop_key = jax.random.split(p_key, 3)
        shape = (b, size, size, ref.channels)
        d = {"times": ref.noise_schedulers[i].sample_random_times(times_key, b),
             "noise": jax.random.normal(noise_key, shape, jnp.float32),
             "keep_mask": jax.random.uniform(drop_key, (b,)) < 1.0 - ref.cond_drop_prob}
        if i > 0:
            aug = ref.lowres_noise_schedule.sample_random_times(aug_key, 1)
            d["lowres_aug_times"] = jnp.repeat(aug, b)
            d["lowres_noise"] = jax.random.normal(lowres_key, shape, jnp.float32)
        draws.append({k: np.asarray(v) for k, v in d.items()})
    return draws


def _flat(tensors):
    return np.concatenate([np.asarray(t, np.float32).ravel() for t in tensors])


def _rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture(scope="module")
def runs():
    """Each world's processes' results, and the JAX mesh step's losses and
    parameters (flattened in the port's order)."""
    ref = JImagen(unets=[J.BaseTest(), J.SuperTest()], **W.IMAGEN_KW)
    ours = W.cascade_imagen()
    key = jax.random.PRNGKey(JAX_KEY)
    draws = [_jax_draws(ref, key, step, W.BATCH) for step in range(2)]
    wait = W.start({w: ("torch_mesh_workers:scenarios", w,
                        {"run": ["train_scenarios", "sample_scenarios", "init_scenarios"],
                         "jax_draws": draws}, {})
                    for w in WORLDS})
    # the JAX reference meanwhile: clip-50 SGD, two data-parallel steps
    params = {f"unet_{i}": jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                                  flax_unet_tree(u))
              for i, u in enumerate(ours.unets)}
    opt = optax.chain(optax.clip_by_global_norm(50.0), optax.sgd(1e-2))
    mesh = jmesh.make_mesh()
    state = jmesh.create_train_state(params, opt, mesh=mesh)
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
    return {"results": results, "jax": {"losses": np.stack(losses), "params": jax_params}}


def _train(runs, world, rank=0):
    return runs["results"][world][rank]["train_scenarios"]


def _sample(runs, world, rank=0):
    return runs["results"][world][rank]["sample_scenarios"]


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_step_matches_the_jax_mesh_step(runs, world):
    dp, jax_run = _train(runs, world)["sgd_dp"], runs["jax"]
    np.testing.assert_allclose(dp["losses"], jax_run["losses"], rtol=2e-4)
    np.testing.assert_allclose(dp["params"], jax_run["params"], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["dp", "zero1", "fsdp"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_steps_match_the_one_device_step(runs, world, mode):
    out = _train(runs, world)
    for opt in ("sgd", "adam"):
        np.testing.assert_allclose(out[f"{opt}_{mode}"]["losses"], out[f"{opt}_one"]["losses"],
                                   rtol=2e-4)
    np.testing.assert_allclose(out[f"sgd_{mode}"]["params"], out["sgd_one"]["params"],
                               rtol=2e-4, atol=1e-6)
    adam, one = out[f"adam_{mode}"], out["adam_one"]
    assert _rel_l2(adam["params"], one["params"]) <= 1e-5
    assert _rel_l2(adam["ema"], one["ema"]) <= 1e-5
    if world == 2:  # a sum of two is the same in any order: the same bits as plain DP
        for opt in ("sgd", "adam"):
            np.testing.assert_array_equal(out[f"{opt}_{mode}"]["params"],
                                          out[f"{opt}_dp"]["params"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_state(runs, world):
    ranks = [_train(runs, world, r) for r in range(world)]
    for mode in ("dp", "zero1", "fsdp"):
        for r in ranks[1:]:
            for key in ("params", "losses"):
                np.testing.assert_array_equal(r[f"adam_{mode}"][key], ranks[0][f"adam_{mode}"][key])


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
@pytest.mark.parametrize("world", WORLDS)
def test_the_largest_shards_hold_one_nth(runs, world, mode):
    shards = _train(runs, world)[f"shards_{mode}"]
    kinds = ("mu", "nu", "ema") + (("params",) if mode == "fsdp" else ())
    for kind in kinds:
        local, full = shards[kind]
        assert full > 0 and local * world == full, (kind, local, full)
    if mode == "fsdp":
        assert shards["param_data_at_rest"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_chained_steps_equal_single_steps(runs, world):
    out = _train(runs, world)
    np.testing.assert_array_equal(out["chained"]["params"], out["single"]["params"])
    np.testing.assert_allclose(out["chained"]["mean"], out["single"]["losses"][:2].mean(0),
                               rtol=1e-6)
    np.testing.assert_array_equal(out["chained"]["mean2"], out["single"]["losses"][2])


@pytest.mark.parametrize("n", [W.BATCH, 6])
@pytest.mark.parametrize("world", WORLDS)
def test_eval_step_on_the_mesh(runs, world, n):
    ev = _train(runs, world)[f"eval_{n}"]
    assert ev["mesh"].shape == (2,)
    np.testing.assert_allclose(ev["mesh"], ev["one"], rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sample_matches_one_device(runs, world):
    out = _sample(runs, world)
    assert out["mesh"].shape == (W.BATCH, 16, 16, 3)
    np.testing.assert_allclose(out["mesh"], out["one"], atol=1e-5)
    np.testing.assert_allclose(out["ddpm_mesh"], out["ddpm_one"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sample_pads_and_trims(runs, world):
    out = _sample(runs, world)
    assert [o.shape[0] for o in out["three"]] == [3, 3]
    np.testing.assert_allclose(out["three"][-1], out["explicit"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_state_serves_directly(runs, world):
    out = _sample(runs, world)
    assert out["fsdp_at_rest"] < sum(p.numel() for p in W.cascade_imagen().unets[0].parameters())
    np.testing.assert_allclose(out["fsdp"], out["mesh"], atol=1e-6)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
@pytest.mark.parametrize("world", WORLDS)
def test_a_mesh_train_state_starts_from_process_0s_parameters(runs, world, mode):
    """Each process built its cascade from another seed; the state made on
    the mesh holds process 0's (seed 0's) parameters and EMA on every one."""
    want = np.concatenate([p.detach().numpy().ravel() for p in W.cascade_imagen().unets.parameters()])
    for r in range(world):
        got = runs["results"][world][r]["init_scenarios"][mode]
        np.testing.assert_array_equal(got["params"], want)
        np.testing.assert_array_equal(got["ema"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_whole_sample(runs, world):
    ranks = [_sample(runs, world, r) for r in range(world)]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["mesh"], ranks[0]["mesh"])
