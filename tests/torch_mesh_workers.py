"""What each process of a multi-process test runs (``parallel.collectives.
spawn`` targets). It imports the port and numpy only: the tests compute the
JAX package's numbers in their own process and pass them in as arrays.

Every function takes the process's group and a spec dict and returns a dict
of numpy arrays and numbers, which the test compares."""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.data.collate import DataLoader, MinimagenCollator
from minimagen_tpu_torch.data.dataset import SyntheticCaptionedImages
from minimagen_tpu_torch.models.imagen import Imagen
from minimagen_tpu_torch.models.unet import BaseTest, SuperTest, UnetConfig
from minimagen_tpu_torch.parallel import cascade, collectives, multihost, pipeline, tensor
from minimagen_tpu_torch.parallel import mesh as pmesh

IMAGEN_KW = dict(image_sizes=(8, 16), timesteps=25, cond_drop_prob=0.15,
                 text_encoder_name="t5_small")
BATCH, L, DIM = 8, 4, 512
# the test cascade's kernels are at most 64 wide: split every kernel whose
# output divides by the model size, the stem's included
TP_MIN = 2


def start(jobs):
    """Run ``collectives.spawn(target, world, (spec,), **kw)`` for every
    job {key: (target, world, spec, kw)} at once, each from a thread; returns
    wait(), which gives {key: the ranks' results} or raises the first
    failure."""
    results, errors = {}, []

    def run(key, target, world, spec, kw):
        try:
            results[key] = collectives.spawn(target, world, (spec,), **{"timeout": 400, **kw})
        except Exception as e:  # noqa: BLE001 - raised by wait()
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,) + tuple(job)) for k, job in jobs.items()]
    for t in threads:
        t.start()

    def wait():
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise TimeoutError("a spawned group did not end")
        return results

    return wait


def cascade_imagen() -> Imagen:
    """The BaseTest + SuperTest cascade at 8 -> 16 px, float32, from seed 0
    (every process and the test build the same weights)."""
    torch.manual_seed(0)
    return Imagen(unets=[BaseTest(), SuperTest()], device="cpu", **IMAGEN_KW)


def batch(n: int = BATCH, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((n, L), bool)
    mask[1::3, 2:] = False
    return {"image": rng.uniform(size=(n, 16, 16, 3)).astype(np.float32),
            "encoding": rng.normal(size=(n, L, DIM)).astype(np.float32), "mask": mask}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


class ClippedSGD(ttrain.ClippedAdam):
    """Clip-50 SGD: an update linear in the gradients, which holds the
    sharded steps to the one-device step element by element (Adam's m /
    sqrt(v) turns reduction-order noise in near-zero gradients into updates
    of up to lr)."""

    def _adam(self, params, grads, state):
        torch._foreach_add_(params, grads, alpha=-self.lr)
        state.count += 1


def _full(state):
    """Every parameter and EMA leaf whole, flattened, as numpy."""
    params = pmesh.full_tensors(state.local_params(), state.plan, state.mesh, state.shapes)
    out = {"params": np.concatenate([t.detach().numpy().ravel() for t in params])}
    if state.ema_params is not None:
        ema = pmesh.full_tensors(state.ema_params, state.plan, state.mesh, state.shapes)
        out["ema"] = np.concatenate([t.numpy().ravel() for t in ema])
    return out


def _plan(mode, imagen, mesh):
    if mode == "zero1":
        return pmesh.zero1_plan(imagen.unets, mesh, min_size=1)
    if mode == "fsdp":
        return pmesh.fsdp_plan(imagen.unets, mesh, min_size=1)
    if mode == "tp":
        return pmesh.replicated_plan(imagen.unets, mesh, min_shard_dim=TP_MIN)
    if mode == "tp_zero1":
        return pmesh.zero1_plan(imagen.unets, mesh, min_size=1, min_shard_dim=TP_MIN)
    return None


def _run(mode, mesh, optimizer, steps, draws=None, ema=None, seed=3):
    """`steps` train steps of a fresh cascade in `mode` ('one': the
    one-device step on the whole batch; 'dp', 'zero1', 'fsdp' on `mesh`)."""
    imagen = cascade_imagen()
    on_mesh = mode != "one"
    state = ttrain.create_train_state(imagen, optimizer, ema=ema is not None,
                                      mesh=mesh if on_mesh else None,
                                      plan=_plan(mode, imagen, mesh) if on_mesh else None)
    step = ttrain.make_train_step(imagen, optimizer, ema_decay=ema or 0.9999,
                                  mesh=mesh if on_mesh else None)
    losses = []
    for i in range(steps):
        b = batch(seed=10 + i)
        if on_mesh:
            b = pmesh.shard_batch(b, mesh)
        d = None if draws is None else [{k: torch.from_numpy(v) for k, v in s.items()}
                                        for s in draws[i]]
        state, l_ = step(state, torch_batch(b), seed=seed, draws=d)
        losses.append(l_.numpy())
    out = {"losses": np.stack(losses), **_full(state)}
    out["state"] = state
    return out


def _shard_sizes(state):
    """(local, full) element counts of the largest sharded moment, EMA and
    parameter leaf."""
    def biggest(tensors):
        pairs = [(t.numel(), int(np.prod(s))) for t, s, a in
                 zip(tensors, state.shapes, state.plan.axes) if a is not None]
        return max(pairs, key=lambda p: p[1]) if pairs else (0, 0)
    out = {"mu": biggest(state.opt_state.mu), "nu": biggest(state.opt_state.nu)}
    if state.ema_params is not None:
        out["ema"] = biggest(state.ema_params)
    if state.plan.shard_params:
        out["params"] = biggest(state.local_params())
        out["param_data_at_rest"] = sum(p.numel() for p, a in zip(state.params, state.plan.axes)
                                        if a is not None)
    return out


def train_scenarios(group, spec):
    """DP, ZeRO-1 and FSDP against the one-device step; DP against the JAX
    mesh step's injected draws; shard sizes; chained steps; the eval step."""
    mesh = pmesh.make_mesh(group)
    out = {"world": mesh.size, "rank": mesh.rank}
    sgd = ClippedSGD(1e-2)
    for mode in ("one", "dp", "zero1", "fsdp"):
        run = _run(mode, mesh, sgd, 2, draws=spec["jax_draws"])
        out[f"sgd_{mode}"] = {k: v for k, v in run.items() if k != "state"}
    adam = ttrain.make_optimizer(1e-4, accum_iter=2)  # the lr of the JAX ZeRO-1 test
    for mode in ("one", "dp", "zero1", "fsdp"):
        run = _run(mode, mesh, adam, 3, ema=0.9)
        out[f"adam_{mode}"] = {k: v for k, v in run.items() if k != "state"}
        if mode in ("zero1", "fsdp"):
            out[f"shards_{mode}"] = _shard_sizes(run["state"])

    # K chained steps against K single steps (ZeRO-1)
    stacked = {k: np.stack([pmesh.shard_batch(batch(seed=s), mesh)[k] for s in (20, 21)])
               for k in ("image", "encoding", "mask")}
    imagen = cascade_imagen()
    opt = ttrain.make_optimizer(1e-3)
    state = ttrain.create_train_state(imagen, opt, mesh=mesh,
                                      plan=_plan("zero1", imagen, mesh))
    chain = ttrain.make_chained_train_step(imagen, opt, mesh=mesh)
    state, mean = chain(state, torch_batch(stacked), 5, 2)
    state, mean2 = chain(state, torch_batch(stacked), 5, 1)
    out["chained"] = {"mean": mean.numpy(), "mean2": mean2.numpy(), **_full(state)}
    imagen = cascade_imagen()
    state = ttrain.create_train_state(imagen, opt, mesh=mesh,
                                      plan=_plan("zero1", imagen, mesh))
    step = ttrain.make_train_step(imagen, opt, mesh=mesh)
    singles = []
    for _ in range(3):
        b = {k: v[state.step % 2] for k, v in stacked.items()}
        state, l_ = step(state, torch_batch(b), 5)
        singles.append(l_.numpy())
    out["single"] = {"losses": np.stack(singles), **_full(state)}

    # the eval step, on even and uneven shards, against one device
    imagen = cascade_imagen()
    one = ttrain.make_eval_step(imagen)
    on_mesh = ttrain.make_eval_step(imagen, mesh)
    for n in (BATCH, 6):
        b = batch(n, seed=30)
        out[f"eval_{n}"] = {
            "one": one(torch_batch(b), 9).numpy(),
            "mesh": on_mesh(torch_batch(pmesh.shard_batch(b, mesh, even=False)), 9).numpy()}
    return out


def sample_scenarios(group, spec):
    """``sample(mesh=)`` against the one-device sample (8 captions; 3
    captions padded), and served straight from an FSDP state."""
    mesh = pmesh.make_mesh(group)
    imagen = cascade_imagen()
    b = batch(seed=40)
    embeds, masks = torch.from_numpy(b["encoding"]), torch.from_numpy(b["mask"])
    kw = dict(cond_scale=3.0, sampler="ddim", sample_steps=3, cache_interval=None)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    out = {"one": imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(),
                                **kw).numpy(),
           "mesh": imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(),
                                 mesh=mesh, **kw).numpy()}
    # three captions over the mesh are the explicit run with the last repeated
    pad = (-3) % mesh.size
    explicit = torch.cat([embeds[:3], embeds[2:3].expand(pad, -1, -1)])
    explicit_m = torch.cat([masks[:3], masks[2:3].expand(pad, -1)])
    out["three"] = imagen.sample(text_embeds=embeds[:3], text_masks=masks[:3], generator=gen(),
                                 mesh=mesh, return_all_stage_outputs=True, **kw)
    out["three"] = [o.numpy() for o in out["three"]]
    out["explicit"] = imagen.sample(text_embeds=explicit, text_masks=explicit_m,
                                    generator=gen(), **kw)[:3].numpy()
    out["ddpm_one"] = imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(),
                                    sampler="ddpm", cond_scale=3.0).numpy()
    out["ddpm_mesh"] = imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(),
                                     sampler="ddpm", cond_scale=3.0, mesh=mesh).numpy()
    # an FSDP state serves directly: its weights gathered one stage at a time
    ttrain.create_train_state(imagen, ttrain.make_optimizer(1e-4), mesh=mesh,
                              plan=pmesh.fsdp_plan(imagen.unets, mesh, min_size=1))
    out["fsdp_at_rest"] = sum(p.numel() for p in imagen.unets[0].parameters())
    out["fsdp"] = imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(),
                                mesh=mesh, **kw).numpy()
    return out


def tp_scenarios(group, spec):
    """Tensor parallelism over a model axis of 2 (world 2: data 1; world 4:
    data 2): the steps alone and under ZeRO-1 against the one-device step
    (clip-50 SGD at the JAX step's draws, Adam with accumulation and EMA),
    per-process bytes against the reckoning, and ``sample(mesh=)`` against
    ``sample()``: the JAX test's one-stage dim-64 U-Net placed by the
    default rule, and the test cascade placed at `TP_MIN`."""
    mesh = pmesh.make_mesh(group, model_parallel=2)
    out = {"shape": mesh.shape, "coords": (mesh.rank, mesh.model_rank)}
    sgd = ClippedSGD(1e-2)
    for mode in ("one", "tp"):
        run = _run(mode, mesh, sgd, 2, draws=spec["jax_draws"])
        out[f"sgd_{mode}"] = {k: v for k, v in run.items() if k != "state"}
    adam = ttrain.make_optimizer(1e-4, accum_iter=2)
    for mode in ("one", "tp") + (("tp_zero1",) if mesh.size > 1 else ()):
        run = _run(mode, mesh, adam, 3, ema=0.9)
        out[f"adam_{mode}"] = {k: v for k, v in run.items() if k != "state"}
        state = run["state"]
        if mode != "one":
            out[f"bytes_{mode}"] = {
                "measured": ttrain.state_bytes(state),
                "reckoned": pmesh.reckon_state_bytes(state.shapes, state.plan, mesh,
                                                     acc_grads=True),
                "one_device": pmesh.reckon_state_bytes(state.shapes, None, None, acc_grads=True),
                "split": sum(a is not None for a in state.plan.model_axes),
                "data_split": sum(a is not None for a in state.plan.axes)}

    # the JAX test's U-Net (test_parallel.py:716-736) placed by sample(mesh=)
    torch.manual_seed(0)
    one_stage = Imagen(unets=[UnetConfig(dim=64, dim_mults=(1, 2), num_resnet_blocks=1,
                                         layer_attns=False, layer_cross_attns=(False, True))],
                       image_sizes=(8,), timesteps=25, cond_drop_prob=0.1,
                       text_encoder_name="t5_small", device="cpu")
    rng = np.random.default_rng(3)
    embeds = torch.from_numpy(rng.normal(size=(4, 4, 512)).astype(np.float32))
    masks = torch.ones(4, 4, dtype=torch.bool)
    kw = dict(cond_scale=2.0, sampler="ddim", sample_steps=4, cache_interval=None)
    gen = lambda: torch.Generator().manual_seed(13)  # noqa: E731
    out["jax_unet"] = {"one": one_stage.sample(text_embeds=embeds, text_masks=masks,
                                               generator=gen(), **kw).numpy(),
                       "mesh": one_stage.sample(text_embeds=embeds, text_masks=masks,
                                                generator=gen(), mesh=mesh, **kw).numpy(),
                       "split": sum(tensor.is_placed(m) for m in one_stage.unets[0].modules()
                                    if not list(m.children()))}
    # the cascade, every kernel that divides split (the stems' too)
    imagen = cascade_imagen()
    b = batch(seed=40)
    embeds, masks = torch.from_numpy(b["encoding"]), torch.from_numpy(b["mask"])
    kw = dict(cond_scale=3.0, sampler="ddim", sample_steps=3, cache_interval=None)
    one = imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(), **kw).numpy()
    placed = tensor.place_model(imagen.unets, mesh, min_shard_dim=TP_MIN)
    out["cascade"] = {"one": one, "placed": placed,
                      "stems": [type(u.init_conv).__name__ for u in imagen.unets],
                      "mesh": imagen.sample(text_embeds=embeds, text_masks=masks,
                                            generator=gen(), mesh=mesh, **kw).numpy()}
    return out


def tp_stage_scenarios(group, spec):
    """World 4 as two stage groups of {data 1, model 2}
    (``make_stage_meshes(2, model_parallel=2)``): the pipelined server and
    the cascade trainer, each stage's kernels split at `TP_MIN`, against
    their one-device counterparts."""
    meshes = cascade.make_stage_meshes(2, model_parallel=2)
    stage = next(s for s, m in enumerate(meshes) if m.rank >= 0)
    out = {"stage": stage, "shape": meshes[stage].shape,
           "groups": [list(m.world.ranks) for m in meshes]}
    imagen = cascade_imagen()
    placed = tensor.place_model([imagen.unets[stage]], meshes[stage], min_shard_dim=TP_MIN)
    reqs = [{"text_embeds": batch(4, seed=s)["encoding"], "text_masks": batch(4, seed=s)["mask"],
             "seed": s} for s in (1, 2)]
    kw = dict(cond_scale=3.0, sampler="ddim", sample_steps=3)
    server = pipeline.CascadePipelineServer(imagen, meshes, cache_interval=None, depth=2, **kw)
    got = list(server.serve(reqs))
    out["placed"] = placed
    if stage == 1:
        ref = cascade_imagen()
        out["served"] = [g.numpy() for g in got]
        out["reference"] = [ref.sample(text_embeds=r["text_embeds"], text_masks=r["text_masks"],
                                       generator=torch.Generator().manual_seed(r["seed"]),
                                       cache_interval=None, **kw).numpy() for r in reqs]
    sgd = ClippedSGD(1e-2)
    imagen = cascade_imagen()
    tensor.place_model([imagen.unets[stage]], meshes[stage], min_shard_dim=TP_MIN)
    trainer = cascade.CascadeParallelTrainer(imagen, sgd, meshes)
    ref_imagen = cascade_imagen()
    ref_state = ttrain.create_train_state(ref_imagen, sgd, stages=(stage,))
    ref_step = cascade.make_stage_train_step(ref_imagen, stage, sgd)
    losses, ref_losses = [], []
    for i in range(2):
        b = batch(seed=50 + i)
        losses.append(trainer.step(b, seed=6))
        ref_state, l_ = ref_step(ref_state, torch_batch(b), 6)
        ref_losses.append(float(l_))
    whole = pmesh.full_tensors(trainer.state.local_params(), trainer.state.plan,
                               trainer.state.mesh, trainer.state.shapes)
    out["trainer"] = {"losses": np.stack(losses), "ref_losses": np.array(ref_losses),
                      "params": np.concatenate([t.detach().numpy().ravel() for t in whole]),
                      "ref_params": np.concatenate([p.detach().numpy().ravel() for p in
                                                    ref_imagen.unets[stage].parameters()])}
    return out


def init_scenarios(group, spec):
    """Each process builds its cascade from its own seed (its rank); a train
    state made on the mesh, plain DP and FSDP, starts from process 0's."""
    mesh = pmesh.make_mesh(group)
    out = {}
    for mode in ("dp", "fsdp"):
        torch.manual_seed(mesh.rank)
        imagen = Imagen(unets=[BaseTest(), SuperTest()], device="cpu", **IMAGEN_KW)
        state = ttrain.create_train_state(imagen, ttrain.make_optimizer(1e-4), ema=True,
                                          mesh=mesh, plan=_plan(mode, imagen, mesh))
        out[mode] = _full(state)
    return out


def multihost_scenarios(group, spec):
    """The environment rendezvous (torchrun's or the JAX package's), the
    global mesh and ``global_batch_from_local``."""
    mesh = multihost.make_global_mesh()
    out = {"shape": mesh.shape, "rank": mesh.rank, "initialized": multihost.initialize_distributed()}
    b = batch(2, seed=mesh.rank)
    out["same"] = multihost.global_batch_from_local(b, mesh) is b
    try:
        multihost.global_batch_from_local(batch(2 + mesh.rank), mesh)
        out["uneven"] = "accepted"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def pipeline_scenarios(group, spec):
    """The pipelined server and the cascade trainer against their
    one-device counterparts."""
    meshes = cascade.make_stage_meshes(2)
    imagen = cascade_imagen()
    out = {"stage": next(s for s, m in enumerate(meshes) if m.rank >= 0),
           "groups": [list(m.group.ranks) for m in meshes]}
    reqs = [{"text_embeds": batch(4, seed=s)["encoding"], "text_masks": batch(4, seed=s)["mask"],
             "seed": s} for s in (1, 2, 3)]

    def reference(req, **kw):
        return imagen.sample(text_embeds=req["text_embeds"], text_masks=req["text_masks"],
                             generator=torch.Generator().manual_seed(req["seed"]),
                             cache_interval=None, **kw).numpy()

    for name, kw in (("ddim", dict(cond_scale=3.0, sampler="ddim", sample_steps=3)),
                     ("budgets", dict(cond_scale=3.0, sampler="ddim", sample_steps=(4, 2),
                                      sr_start_noise_levels=0.5)),
                     ("ddpm", dict(cond_scale=3.0, sampler="ddpm"))):
        server = pipeline.CascadePipelineServer(imagen, meshes, cache_interval=None, depth=2, **kw)
        got = list(server.serve(reqs if name == "ddim" else reqs[:1]))
        out[name] = [None if g is None else g.numpy() for g in got]
        if out["stage"] == 1:
            out[name + "_ref"] = [reference(r, **kw) for r in (reqs if name == "ddim" else reqs[:1])]

    # the cascade trainer against the one-device stage step
    sgd = ClippedSGD(1e-2)
    trainer = cascade.CascadeParallelTrainer(cascade_imagen(), sgd, meshes)
    ref_imagen = cascade_imagen()
    stage = trainer.stage
    ref_state = ttrain.create_train_state(ref_imagen, sgd, stages=(stage,))
    ref_step = cascade.make_stage_train_step(ref_imagen, stage, sgd)
    losses, ref_losses = [], []
    for i in range(2):
        b = batch(seed=50 + i)
        losses.append(trainer.step(b, seed=6))
        ref_state, l_ = ref_step(ref_state, torch_batch(b), 6)
        ref_losses.append(float(l_))
    out["trainer"] = {"losses": np.stack(losses), "ref_losses": np.array(ref_losses),
                      "params": np.concatenate([p.detach().numpy().ravel() for p in
                                                trainer.imagen.unets[stage].parameters()]),
                      "ref_params": np.concatenate([p.detach().numpy().ravel() for p in
                                                    ref_imagen.unets[stage].parameters()]),
                      "keys": sorted(trainer.params)}
    return out


def harness_run(group, spec):
    """A ``MinimagenTrain`` run on the mesh: 8 synthetic items, global batch
    2, checkpoints and validation every 2 batches, EMA, ZeRO-1 (or as
    `spec` says)."""
    mesh = pmesh.make_mesh(group, model_parallel=spec.get("model_parallel", 1))
    args = ttrain.load_testing_parameters(ttrain.get_minimagen_parser().parse_args([]))
    args.IMG_SIDE_LEN, args.EPOCHS, args.CHCKPT_NUM, args.MAX_NUM_WORDS = 16, 1, 2, 8
    args.EMA, args.ZERO1 = 0.9, spec.get("zero1", "on")
    imagen = cascade_imagen()
    tensor.place_model(imagen.unets, mesh, min_shard_dim=TP_MIN)  # a model axis: split
    ds = SyntheticCaptionedImages(num_items=8, side_length=16, encoder_name="t5_small",
                                  max_length=8, device="cpu")
    loader = lambda **kw: DataLoader(ds, batch_size=2, collate_fn=MinimagenCollator(max_length=8),  # noqa: E731
                                     **kw)
    run_dir = spec["run_dir"]
    if mesh.rank == 0:
        training_dir = ttrain.create_directory(run_dir)
    collectives.barrier(mesh.group)
    training_dir = ttrain.create_directory(run_dir)
    summary = ttrain.MinimagenTrain("run", args, imagen.unet_configs, imagen, loader(),
                                    loader(shuffle=False), training_dir, mesh=mesh)
    with pmesh.gathered(imagen.unets.parameters()):  # FSDP weights rest as shards
        whole = pmesh.full_tensors(  # tensor-parallel blocks gathered whole
            [p.detach() for p in imagen.unets.parameters()],
            pmesh.replicated_plan(imagen.unets, mesh), mesh,
            [pmesh.full_shape(p) for p in imagen.unets.parameters()])
    whole = iter(whole)
    weights = {f"unet_{i}": {n: next(whole).numpy().copy() for n, _ in u.named_parameters()}
               for i, u in enumerate(imagen.unets)}
    return {"summary": summary, "weights": weights, "rank": mesh.rank,
            "model_rank": mesh.model_rank, "shape": mesh.shape}


def fail_on_rank_1(group, spec=None):
    """Rank 1 raises; rank 0 waits in a collective (ended by spawn)."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails")
    collectives.barrier(group)


def scenarios(group, spec):
    """Each function named in ``spec['run']``, in order, in one group:
    {name: its result}."""
    return {name: globals()[name](group, spec) for name in spec["run"]}


def cli_run(group, spec):
    """The train CLI (``-test``, one epoch) and the inference CLI with
    ``--MESH data``, in ``spec['cwd']``: every process runs both, as under
    torchrun."""
    from minimagen_tpu_torch import inference, train  # noqa: PLC0415

    os.chdir(spec["cwd"])
    summary = train.main(["-test", "-e", "1", "--MESH", "data", "--DEVICE", "cpu", "-ts", "mesh"])
    pixels = inference.main(["-d", "training_mesh", "-c", "a red square", "--SAMPLER", "ddim",
                             "--SAMPLE_STEPS", "4", "--SEED", "3", "--DEVICE", "cpu",
                             "--MESH", "data"])
    return {"summary": summary, "pixels": pixels, "rank": group.rank}
