"""Device milliseconds per guided call of U-Net 0: the operations launched
inside the benchmark's range around ``imagen.unets[0]``, over its calls."""

RANGES = ("unet0",)


def read(r):
    tr, ranges = r.get("trace"), r.get("ranges")
    calls = ranges.calls.get("pb.unet0", 0) if ranges else 0
    return 1e3 * tr.range_device_s("unet0") / calls if calls else None
