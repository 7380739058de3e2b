"""The port's sharding plans against the JAX package's, without processes:
for the test, lite and default cascades (shapes only, on the meta device),
at data sizes 2, 4 and 8 and the rule's default and smallest `min_size`,
every parameter's sharded axis under ``parallel.mesh.zero1_plan`` /
``fsdp_plan`` is the axis of ``zero1_shardings`` / ``fsdp_shardings`` (on
the 8 virtual devices' sub-meshes), through the checkpoints' weight-carry
mapping (HWIO and (in, out) JAX kernels). Also the mesh's rows, the
refusals (a model axis that does not divide the world, FSDP on a model axis, uneven training batches, NCCL on a shared
card, a process group with no card), ``spawn``'s failure report, the
multi-host helpers outside a launcher, ``sample``'s `device` argument, a
one-device dump restored into each process's blocks, and the sharded
dumps: written at 2 processes and restored at 4 and on one device, a dump
cut short while saving never read, a rank file of another step refused.

Where a test plays several processes in this one (a mesh without a
process group), every process builds seed 0's cascade, so the
parameters' broadcast from process 0 is the identity and is left out."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import torch_mesh_workers as W
from jax.sharding import Mesh as JMesh

from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import checkpoint as tckpt
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.checkpoint import flax_unet_tree
from minimagen_tpu_torch.generate import default_imagen, lite_imagen
from minimagen_tpu_torch.models.imagen import Imagen
from minimagen_tpu_torch.models.unet import BaseTest, SuperTest
from minimagen_tpu_torch.parallel import checkpoint as pckpt
from minimagen_tpu_torch.parallel import collectives, multihost
from minimagen_tpu_torch.parallel import mesh as pmesh
from minimagen_tpu_torch.parallel.collectives import Group

CASCADES = ("test", "lite", "default")


def _cascade(name):
    """A cascade's shapes: its tensors made on the meta device, no values."""
    with torch.device("meta"):
        if name == "lite":
            return lite_imagen(device="meta")
        if name == "default":
            return default_imagen(device="meta")
        return Imagen(unets=[BaseTest(), SuperTest()], image_sizes=(8, 16), timesteps=25,
                      text_encoder_name="t5_small", device="meta")


@pytest.fixture(scope="module")
def cascades():
    return {name: _cascade(name) for name in CASCADES}


def _mesh(n, rank=0):
    return pmesh.Mesh(Group(None, tuple(range(n)), rank, "gloo", torch.device("cpu")))


def _jax_shapes(unet):
    """The JAX parameter tree of a port U-Net, as shapes."""
    tree = {}
    for name, p in unet.named_parameters():
        path = name.split(".")
        shape = tuple(p.shape)
        if path[-1] == "weight":
            path[-1] = "kernel"
            perm = pmesh.jax_axes(name, p.dim())
            shape = tuple(shape[a] for a in perm)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jax.ShapeDtypeStruct(shape, np.float32)
    return tree


def _jax_axis(sharding):
    spec = tuple(sharding.spec)
    return spec.index("data") if "data" in spec else None


@pytest.mark.parametrize("min_size", [pmesh.MIN_SIZE, 1])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", CASCADES)
def test_plans_shard_the_jax_packages_axes(cascades, name, n, min_size):
    imagen = cascades[name]
    jax_mesh = JMesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
    params = {f"unet_{i}": _jax_shapes(u) for i, u in enumerate(imagen.unets)}
    opt = jmesh.make_optimizer(1e-4)
    z_state, z_grads = jmesh.zero1_shardings(params, opt, jax_mesh, ema=True, min_size=min_size)
    f_state, _ = jmesh.fsdp_shardings(params, opt, jax_mesh, ema=True, min_size=min_size)
    zero1 = pmesh.zero1_plan(imagen.unets, _mesh(n), min_size=min_size)
    fsdp = pmesh.fsdp_plan(imagen.unets, _mesh(n), min_size=min_size)
    assert not zero1.shard_params and fsdp.shard_params and zero1.axes == fsdp.axes
    i = 0
    for s, unet in enumerate(imagen.unets):
        for pname, p in unet.named_parameters():
            path = pname.split(".")
            path[-1] = "kernel" if path[-1] == "weight" else path[-1]
            node_g, node_e, node_p, node_f = (z_grads[f"unet_{s}"], z_state.ema_params[f"unet_{s}"],
                                              z_state.params[f"unet_{s}"], f_state.params[f"unet_{s}"])
            for k in path:
                node_g, node_e, node_p, node_f = node_g[k], node_e[k], node_p[k], node_f[k]
            axis = zero1.axes[i]
            want = None if axis is None else pmesh.jax_axes(pname, p.dim()).index(axis)
            assert want == _jax_axis(node_g) == _jax_axis(node_e) == _jax_axis(node_f), pname
            assert _jax_axis(node_p) is None  # ZeRO-1 keeps the parameters whole
            i += 1
    assert i == len(zero1.axes)
    if name != "test" and min_size == pmesh.MIN_SIZE:
        assert any(a is not None for a in zero1.axes)


def test_jax_axes_follow_the_checkpoint_layout(cascades):
    unet = Imagen(unets=[BaseTest()], image_sizes=(8,), text_encoder_name="t5_small",
                  device="cpu").unets[0]
    tree = flax_unet_tree(unet)
    for name, p in unet.named_parameters():
        node = tree
        path = name.split(".")
        path[-1] = "kernel" if path[-1] == "weight" else path[-1]
        for k in path:
            node = node[k]
        perm = pmesh.jax_axes(name, p.dim())
        assert tuple(node.shape) == tuple(p.shape[a] for a in perm)


@pytest.mark.parametrize("shape", [(), (3,), (4096,), (5, 4096), (3, 3, 64, 128), (64, 63),
                                   (6, 6, 4), (8, 8, 8, 8), (1, 2, 4096)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_the_rule_is_the_jax_packages(shape, n):
    jax_mesh = JMesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
    for min_size in (1, 4096):
        rule = jmesh._zero1_rule(jax_mesh, min_size)
        assert pmesh.zero1_rule(shape, n, min_size) == _jax_axis(
            rule(jax.ShapeDtypeStruct(shape, np.float32)))


def test_rows_split_a_batch():
    assert [_mesh(4, r).rows(8) for r in range(4)] == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                       slice(6, 8)]
    assert [_mesh(4, r).rows(6, even=False) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 5), slice(5, 6)]
    with pytest.raises(ValueError, match="does not divide the data axis"):
        _mesh(4).rows(6)
    batch = {"image": np.arange(8), "mask": np.arange(8) * 2}
    got = pmesh.shard_batch(batch, _mesh(2, 1))
    np.testing.assert_array_equal(got["image"], [4, 5, 6, 7])
    np.testing.assert_array_equal(got["mask"], [8, 10, 12, 14])
    assert pmesh.shard_batch(None, _mesh(2)) is None
    assert _mesh(4).shape == {"data": 4, "model": 1}


def test_tensor_parallelism_is_refused():
    """Where the JAX package refuses a model axis: a world that does not
    divide by it (``mesh.py:46``) and FSDP on it (``mesh.py:223-226``)."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="do not divide by model_parallel=2"):
        pmesh.make_mesh(Group(None, (0, 1, 2), 0, "gloo", cpu), model_parallel=2)
    tp = pmesh.Mesh(_mesh(1).group, Group(None, (0, 1), 0, "gloo", cpu),
                    Group(None, (0, 1), 0, "gloo", cpu))
    with pytest.raises(ValueError, match="pure data-parallel mesh"):
        pmesh.fsdp_plan(W.cascade_imagen().unets, tp)


def test_cast_params():
    out = pmesh.cast_params([torch.ones(2), torch.arange(3)], torch.bfloat16)
    assert out[0].dtype == torch.bfloat16 and out[1].dtype == torch.int64


def test_nccl_and_cuda_meshes_are_refused_without_fallback():
    with pytest.raises(ValueError, match="one device per rank"):
        collectives.spawn("torch_mesh_workers:train_scenarios", 2, backend="nccl",
                          devices=["cuda:0", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="does not fall back"):
            collectives.init_process(0, 1, device="cuda", store=torch.distributed.HashStore())
        assert not torch.distributed.is_initialized()


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] failed(.|\n)*rank 1 fails"):
        collectives.spawn("torch_mesh_workers:fail_on_rank_1", 2, timeout=120)


def test_multihost_without_a_launcher(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        multihost.initialize_distributed()


def test_sample_takes_the_references_device_argument():
    imagen = W.cascade_imagen()
    b = W.batch(2)
    kw = dict(text_embeds=b["encoding"], text_masks=b["mask"], sampler="ddim", sample_steps=1,
              cache_interval=None, generator=torch.Generator().manual_seed(0))
    out = imagen.sample(device="cpu", **kw)
    assert out.shape == (2, 16, 16, 3)
    with pytest.raises(ValueError, match="U-Nets are on cpu"):
        imagen.sample(device="cuda", **kw)


@pytest.fixture
def no_group(monkeypatch):
    """Meshes without a process group: the init's broadcast left out (every
    process builds seed 0's cascade), a barrier ends at once, and every
    process of a save agrees on the dump's name."""
    monkeypatch.setattr(pmesh, "broadcast_params", lambda params, mesh: None)
    monkeypatch.setattr(collectives, "barrier", lambda group: None)
    monkeypatch.setattr(collectives, "broadcast_object", lambda obj, group, src=0: "dump_000001")


def _mesh_state(opt, n, rank, mode, min_size=1):
    imagen = W.cascade_imagen()
    make = pmesh.fsdp_plan if mode == "fsdp" else pmesh.zero1_plan
    mesh = _mesh(n, rank)
    return ttrain.create_train_state(imagen, opt, ema=True, mesh=mesh,
                                     plan=make(imagen.unets, mesh, min_size=min_size)), mesh


def _random_state(opt, step=6):
    """A one-device state with moments, accumulators and EMA drawn from seeds."""
    one = ttrain.create_train_state(W.cascade_imagen(), opt, ema=True)
    with torch.no_grad():
        for i, t in enumerate([*one.params, *one.opt_state.mu, *one.opt_state.nu,
                               *one.ema_params, *one.opt_state.acc_grads]):
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(i + step)))
    one.step, one.opt_state.count, one.opt_state.mini_step = step, step // 2, 1
    return one


def _kinds(state):
    opt = state.opt_state
    return {"mu": opt.mu, "nu": opt.nu, "acc_grads": opt.acc_grads, "ema": state.ema_params}


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_a_dump_of_2_processes_restores_at_4_and_on_one_device(tmp_path, no_group, mode):
    """Two processes' files written, then read into each process of a mesh
    of 4 (whose plan shards some leaves on another axis) and into one
    device: every block is the whole state's block."""
    opt = ttrain.make_optimizer(1e-3, accum_iter=2)
    one = _random_state(opt)
    tckpt.save_train_state(str(tmp_path / "s.ckpt"), one)
    root = str(tmp_path / "sharded")
    for rank in (1, 0):  # process 0 writes the manifest once the other file is there
        state, _ = _mesh_state(opt, 2, rank, mode)
        tckpt.load_train_state(str(tmp_path / "s.ckpt"), state)
        pckpt.save_sharded_state(root, state)
    assert sorted(os.listdir(root)) == ["dump_000001"]
    assert sorted(os.listdir(os.path.join(root, "dump_000001"))) == [
        "manifest.json", "rank_00000.ckpt", "rank_00001.ckpt"]
    axes2 = _mesh_state(opt, 2, 0, mode)[0].plan.axes
    for rank in range(4):
        state, mesh = _mesh_state(opt, 4, rank, mode)
        pckpt.load_sharded_state(root, state)
        assert (state.step, state.opt_state.count, state.opt_state.mini_step) == (6, 3, 1)
        for kind, tensors in _kinds(state).items():
            for i, (got, want) in enumerate(zip(tensors, _kinds(one)[kind])):
                assert torch.equal(got, state.plan.local(i, want, mesh)), (kind, i)
        for i, (got, want) in enumerate(zip(state.local_params(), one.params)):
            assert torch.equal(got, state.plan.local(i, want.detach(), mesh))
    assert any(a not in (b, None) for a, b in zip(state.plan.axes, axes2))
    back = ttrain.create_train_state(W.cascade_imagen(), opt, ema=True)
    pckpt.load_sharded_state(root, back)
    for kind, tensors in _kinds(back).items():
        assert all(torch.equal(a, b) for a, b in zip(tensors, _kinds(one)[kind])), kind
    assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(back.params, one.params))


def test_a_dump_cut_short_while_saving_is_not_read(tmp_path):
    """A newer dump without its manifest (a run that died while saving) is
    passed over for the last complete one, and the next complete save
    removes both."""
    opt = ttrain.make_optimizer(1e-3, accum_iter=2)
    root = str(tmp_path / "sharded")
    first, second = _random_state(opt, 6), _random_state(opt, 8)
    pckpt.save_sharded_state(root, first)
    done = pckpt.save_sharded_state(str(tmp_path / "other"), second)
    os.makedirs(os.path.join(root, "dump_000002"))
    shutil.copy(os.path.join(done, "rank_00000.ckpt"), os.path.join(root, "dump_000002"))
    state = ttrain.create_train_state(W.cascade_imagen(), opt, ema=True)
    pckpt.load_sharded_state(root, state)
    assert state.step == 6
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, first.opt_state.mu))
    pckpt.save_sharded_state(root, second)
    assert sorted(os.listdir(root)) == ["dump_000003"]
    pckpt.load_sharded_state(root, state)
    assert state.step == 8
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, second.opt_state.mu))


def test_a_rank_file_of_another_step_is_refused(tmp_path):
    opt = ttrain.make_optimizer(1e-3, accum_iter=2)
    dump = pckpt.save_sharded_state(str(tmp_path / "a"), _random_state(opt, 6))
    other = pckpt.save_sharded_state(str(tmp_path / "b"), _random_state(opt, 8))
    shutil.copy(os.path.join(other, "rank_00000.ckpt"), os.path.join(dump, "rank_00000.ckpt"))
    state = ttrain.create_train_state(W.cascade_imagen(), opt, ema=True)
    with pytest.raises(ValueError, match="of step 8, the manifest of step 6"):
        pckpt.load_sharded_state(str(tmp_path / "a"), state)
    with pytest.raises(FileNotFoundError, match="no complete sharded dump"):
        pckpt.load_sharded_state(str(tmp_path / "none"), state)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_a_one_device_dump_restores_into_each_processs_blocks(tmp_path, no_group, mode):
    """``load_train_state`` of a one-device ``train_state.ckpt`` into the
    state of each process of a mesh of 2 (no collective runs): every block
    is the file's block, the parameters whole where the plan keeps them
    whole."""
    opt = ttrain.make_optimizer(1e-3, accum_iter=2)
    one = ttrain.create_train_state(W.cascade_imagen(), opt, ema=True)
    with torch.no_grad():
        for i, t in enumerate([*one.opt_state.mu, *one.opt_state.nu, *one.ema_params,
                               *one.opt_state.acc_grads]):
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(i)))
    one.step, one.opt_state.count, one.opt_state.mini_step = 6, 3, 1
    tckpt.save_train_state(str(tmp_path / "s.ckpt"), one)
    for rank in range(2):
        state, mesh = _mesh_state(opt, 2, rank, mode)
        tckpt.load_train_state(str(tmp_path / "s.ckpt"), state)
        assert (state.step, state.opt_state.count, state.opt_state.mini_step) == (6, 3, 1)
        for kind in ("mu", "nu", "acc_grads"):
            for i, (got, want) in enumerate(zip(getattr(state.opt_state, kind),
                                                getattr(one.opt_state, kind))):
                assert torch.equal(got, state.plan.local(i, want, mesh))
        for i, (got, want) in enumerate(zip(state.local_params(), one.params)):
            assert torch.equal(got, state.plan.local(i, want.detach(), mesh))
        if mode == "zero1":
            assert all(torch.equal(p.detach(), q.detach())
                       for p, q in zip(state.params, one.params))
        assert any(a is not None for a in state.plan.axes)

