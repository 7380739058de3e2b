"""Time the port's attention and GroupNorm kernels at the lite paths' heaviest
shapes, and guided sampling steps of the lite cascade, to compare two
checkouts on one card.

    python minimagen_tpu_torch/ab_times.py --root PATH [--reps 50]

imports ``minimagen_tpu_torch`` from the checkout at PATH (so this file can
time an older tree), builds its kernels and prints one JSON line: the
card, the root, per kernel and bf16 shape the median CUDA-event time of
`reps` launches in ms, and per lite stage the host ms per guided DDIM step
(8 captions, 16 rows, random weights and text encodings: the time does not
depend on their values), the median of `reps` // 10 runs of 5 steps, each
ending in a synchronize. Run it for trees A and B in turns (A, B, B, A)
within one call: the card and its neighbours then stay the same.
"""
import argparse
import json
import os
import statistics
import sys
import time

# (kernel, shape): attention (b, h, n, j), GroupNorm (b, h, w, c, with scale-shift)
SHAPES = [("mqa_forward", (16, 8, 1024, 1025)), ("mha_forward", (16, 8, 1024, 259)),
          ("mqa_backward", (16, 8, 1024, 1025)), ("mha_backward", (16, 8, 1024, 259)),
          ("group_norm_forward", (16, 256, 256, 32, False)),
          ("group_norm_forward", (16, 256, 256, 32, True)),
          ("group_norm_forward", (16, 64, 64, 64, True)),
          ("group_norm_backward", (16, 256, 256, 32, False)),
          ("group_norm_backward", (16, 64, 64, 64, True))]


def median_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launcher(kernel, shape, gen):
    """A no-argument call of `kernel` on seeded bf16 inputs of `shape`."""
    import torch
    from minimagen_tpu_torch.ops import flash_attention as fa
    from minimagen_tpu_torch.ops import group_norm as gn

    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    if kernel.startswith(("mqa", "mha")):
        kind = kernel[:3]
        b, h, n, j = shape
        q = rnd(b, h, n, 64) * 0.125
        kv = (b, j, 64) if kind == "mqa" else (b, h, j, 64)
        k, v, g = rnd(*kv), rnd(*kv), rnd(b, h, n, 64)
        if kernel.endswith("forward"):
            return lambda: fa.attention_forward_kernel(kind, q, k, v)
        out, lse = fa.attention_forward_kernel(kind, q, k, v, with_lse=True)
        return lambda: fa.attention_backward_kernel(kind, q, k, v, None, out, g, lse)
    b, h, w, c, with_ss = shape
    x, gamma, beta = rnd(b, h, w, c), rnd(c) * 0.2 + 1.0, rnd(c) * 0.1
    scale, shift = (rnd(b, 1, 1, c) * 0.3, rnd(b, 1, 1, c) * 0.3) if with_ss else (None, None)
    kw = dict(groups=8, silu=True)
    if kernel.endswith("forward"):
        return lambda: gn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    _, mean, rstd = gn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    g = rnd(b, h, w, c)
    return lambda: gn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)


def step_ms(stage, runs, steps=5):
    """Host ms per guided DDIM step of lite stage `stage` at 8 captions."""
    import torch
    from minimagen_tpu_torch.generate import lite_imagen

    torch.manual_seed(0)
    imagen = lite_imagen(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    size = imagen.image_sizes[stage]
    embeds = torch.randn(8, 16, imagen.text_embed_dim, generator=gen, device="cuda")
    masks = torch.ones(8, 16, dtype=torch.bool, device="cuda")
    kw = {}
    if stage:
        kw = dict(lowres_cond_img=torch.rand(8, size, size, 3, generator=gen, device="cuda"),
                  lowres_noise_times=torch.full((8,), 200, device="cuda"))
    init = torch.randn(8, size, size, 3, generator=gen, device="cuda")

    def run():
        imagen.sample_stage(stage, embeds, masks, 3.0, init_noise=init, sampler="ddim",
                            sample_steps=steps, **kw)
        torch.cuda.synchronize()

    run()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(times)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="checkout whose minimagen_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from minimagen_tpu_torch.ops import kernels

    kernels.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {f"{k} {s}": median_ms(launcher(k, s, gen), args.reps) for k, s in SHAPES}
    steps = {f"lite stage {i} host ms/step": step_ms(i, max(1, args.reps // 10)) for i in (0, 1)}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "root": args.root,
                      "package": os.path.dirname(kernels.__file__), "median_ms": times,
                      "steps": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
