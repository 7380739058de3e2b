"""The fewest bytes a clip-Adam-EMA update must move (``ranges/unet_params.py``:
40 a float32 parameter, counted from the U-Nets the benchmark built), at the
card's HBM rate, over the device time of the operations launched inside the
program's ``train.optimizer`` and ``train.ema`` spans, in percent."""
import sys

from portbench import spans, work

RANGES = ("unet_params",)


def read(r):
    c, ranges = spans.charged(r), r.get("ranges")
    counted = dict(ranges.shapes.get("pb.unet_params", ())) if ranges else {}
    device_s = c.device_s(("train.optimizer", "train.ema")) if c and counted else 0.0
    if not device_s:
        return None
    params = sum(n for n, _ in counted.values())
    nbytes = sum(b for _, b in counted.values())
    bound = nbytes / work.PEAK_BYTES_PER_S
    print(f"portbench: optimizer bound {params} parameters, {nbytes} bytes, {bound * 1e3:.6g} ms "
          f"a step, over {device_s * 1e3 / c.units:.6g} device ms a step", file=sys.stderr)
    return 100.0 * bound * c.units / device_s
