"""How far the JAX package's own draws move the quality rows that
``chip_smoke.py`` holds the port to. The committed rows of
``assets/lite_ckpt/eval/metrics.json`` are single draws of the reference
(``tools/flagship_quality_eval.py``: ``eval_holdout`` at key 23, ``eval_sr``
at key 3); the port draws its noise from another generator, so only the
spread over draws compares. Run as a script, this file samples the committed
lite cascade with the JAX package on the CPU as those two functions do
(DDIM-50, cond_scale 3, no caching), at the keys given, and the sr rows
also on the port's numpy draws (``quality.numpy_noise``), which
``chip_smoke.py`` gives the port on the card:

    JAX_PLATFORMS=cpu python tests/test_torch_quality_witness.py \\
        --holdout 23 24 25 26 --sr 3 4 --sr-numpy 3 [--float32]

and prints one JSON line: per key, the colour distance of the base stage
on the held-out captions (``holdout/held`` base) and the PSNR of
super-resolution from start levels 0.2 and 0.4 (``sr/start*``), with the
port's metrics (``minimagen_tpu_torch/quality.py``). The tests run the same
functions on the sampling tests' small cascade pair: the numpy draws give
the port's PSNR, and a key gives one distance."""
import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("MINIMAGEN_TPU_T5_FALLBACK", "1")  # as the tool sets it

from minimagen_tpu.data.dataset import _draw_synthetic, synthetic_combo_caption  # noqa: E402
from minimagen_tpu.models.imagen import Imagen  # noqa: E402
from minimagen_tpu.models.t5 import t5_encode_text  # noqa: E402
from minimagen_tpu.ops.helpers import normalize_neg_one_to_one  # noqa: E402
from minimagen_tpu.ops.resize import resize_image_to  # noqa: E402
from minimagen_tpu_torch.quality import (  # noqa: E402
    SR_ITEMS, SR_LEVELS, color_metric, psnr_db, sr_rows,
)
from test_torch_sampling import pair  # noqa: E402,F401 (a fixture, used by name)

CKPT = os.path.join(REPO, "assets", "lite_ckpt")


def committed_cascade(dtype=jnp.bfloat16):
    """The lite cascade computing in `dtype` with the committed bf16 EMA
    weights cast to its float32 parameters (the tool's
    ``load_run(committed=True)``), and the held-out combos."""
    from __graft_entry__ import _lite_imagen
    from minimagen_tpu.training import load_unet_checkpoint

    imagen = _lite_imagen(dtype=dtype)
    imagen.init_params(jax.random.PRNGKey(0), batch_size=1, text_len=16)
    for i in range(imagen.num_unets):
        template = imagen.params[f"unet_{i}"]
        loaded = load_unet_checkpoint(os.path.join(CKPT, f"unet_{i}_ema_bf16.ckpt"), template)
        imagen.params[f"unet_{i}"] = jax.tree_util.tree_map(
            lambda a, t: np.asarray(a).astype(t.dtype), loaded, template)
    with open(os.path.join(CKPT, "eval", "metrics.json")) as f:
        return imagen, json.load(f)["_config"]["held_combos"]


def _encode(imagen, captions, max_length=16):
    e, m = t5_encode_text(captions, imagen.text_encoder_name, max_length)
    return jnp.asarray(e), jnp.asarray(m)


def held_base_distance(imagen, held, key, steps=50):
    """``eval_holdout``'s base row for the held-out combos at `key`: the
    base stage alone on 8 captions cycling through them."""
    base = Imagen(unets=[imagen.unet_configs[0]], image_sizes=(imagen.image_sizes[0],),
                  timesteps=imagen.noise_schedulers[0].num_timesteps, cond_drop_prob=0.1,
                  text_encoder_name=imagen.text_encoder_name, dtype=imagen.dtype)
    base.params = {"unet_0": imagen.params["unet_0"]}
    caps = [synthetic_combo_caption(held[i % len(held)]) for i in range(8)]
    embeds, masks = _encode(imagen, caps)
    out = base.sample(text_embeds=embeds, text_masks=masks, cond_scale=3.0,
                      key=jax.random.PRNGKey(key), sampler="ddim", sample_steps=steps,
                      cache_interval=None)
    return color_metric(np.asarray(out, np.float32), caps)


def sr_psnr(imagen, key, steps=50):
    """``eval_sr`` at `key`: items 0, 1, 7 and 13 at the last stage's size,
    resized to the one before and super-resolved from each start level."""
    hi, lo = imagen.image_sizes[-1], imagen.image_sizes[-2]
    gt, caps = zip(*[_draw_synthetic(i, hi) for i in SR_ITEMS])
    gt = np.stack(gt)
    embeds, masks = _encode(imagen, list(caps))
    low = resize_image_to(jnp.asarray(gt), lo)
    rows = {}
    for level in SR_LEVELS:
        out = imagen.super_resolve(low, stage=imagen.num_unets - 1, text_embeds=embeds,
                                   text_masks=masks, cond_scale=3.0, sampler="ddim",
                                   sample_steps=steps, start_noise_level=level,
                                   key=jax.random.PRNGKey(key))
        rows[f"sr/start{level}"] = psnr_db(np.asarray(out, np.float32), gt)
    return rows


def sr_psnr_numpy(imagen, seed, steps=50):
    """``eval_sr`` on the port's numpy draws (``quality.numpy_noise``
    seeded `seed` for each level): the augmentation noise, then the initial
    image, in the order of the port's ``super_resolve``."""
    stage = imagen.num_unets - 1
    hi, lo = imagen.image_sizes[-1], imagen.image_sizes[-2]
    gt, caps = zip(*[_draw_synthetic(i, hi) for i in SR_ITEMS])
    gt = np.stack(gt)
    embeds, masks = _encode(imagen, list(caps))
    up = resize_image_to(resize_image_to(jnp.asarray(gt), lo), hi)
    times = imagen.lowres_noise_schedule.get_times(len(gt), imagen.lowres_sample_noise_level)
    rows = {}
    for level in SR_LEVELS:
        rng = np.random.default_rng(seed)
        aug, init_noise = (jnp.asarray(rng.standard_normal(gt.shape, dtype=np.float32))
                           for _ in range(2))
        start_at = imagen._truncation_start(stage, level, "ddim", steps, "time")
        lowres = imagen.lowres_noise_schedule.q_sample(up, times, aug)
        init = imagen.noise_schedulers[stage].q_sample(
            normalize_neg_one_to_one(up), jnp.full((len(gt),), start_at, jnp.int32), init_noise)
        fn = imagen._build_sample_stage(stage, True, "ddim", sample_steps=steps,
                                        start_at=start_at, grid="time", cache_interval=None)
        out = fn(imagen.params[f"unet_{stage}"], jax.random.PRNGKey(0), embeds, masks,
                 jnp.float32(3.0), lowres, times, init)
        rows[f"sr/start{level}"] = psnr_db(np.asarray(out, np.float32), gt)
    return rows


def test_numpy_draws_give_the_ports_psnr(pair):
    """The same numpy draws and weights (float32, 4 steps): the JAX
    package's PSNR equals the port's within 0.01 dB."""
    ours, ref, _ = pair
    theirs = sr_psnr_numpy(ref, 3, steps=4)
    mine = sr_rows(ours, 3, steps=4, numpy_draws=True)
    for name, value in theirs.items():
        assert np.isfinite(value) and abs(value - mine[name]["psnr_db"]) <= 0.01, name


def test_held_base_distance_is_one_number_per_key(pair):
    _, ref, _ = pair
    dists = [held_base_distance(ref, [0, 10, 13], 23, steps=2) for _ in range(2)]
    assert dists[0] == dists[1] and 0.0 <= dists[0] <= 1.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--holdout", type=int, nargs="*", default=[23, 24, 25, 26],
                   help="keys of the held-out base row (the tool's is 23)")
    p.add_argument("--sr", type=int, nargs="*", default=[3, 4],
                   help="keys of the sr rows (the tool's is 3)")
    p.add_argument("--sr-numpy", type=int, nargs="*", default=[3],
                   help="seeds of the port's numpy draws for the sr rows")
    p.add_argument("--float32", action="store_true",
                   help="compute in float32 (default: bf16, as the tool and the card serve)")
    args = p.parse_args(argv)
    imagen, held = committed_cascade(jnp.float32 if args.float32 else jnp.bfloat16)
    out = {"backend": jax.default_backend(), "dtype": str(np.dtype(imagen.dtype)),
           "holdout/held base": {}, "sr": {}, "sr numpy draws": {}}
    for k in args.holdout:
        out["holdout/held base"][k] = held_base_distance(imagen, held, k)
        print(f"holdout/held base, key {k}: {out['holdout/held base'][k]:.4f}", flush=True)
    for k in args.sr:
        out["sr"][k] = sr_psnr(imagen, k)
        print(f"sr, key {k}: {out['sr'][k]}", flush=True)
    for k in args.sr_numpy:
        out["sr numpy draws"][k] = sr_psnr_numpy(imagen, k)
        print(f"sr, numpy draws seeded {k}: {out['sr numpy draws'][k]}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
