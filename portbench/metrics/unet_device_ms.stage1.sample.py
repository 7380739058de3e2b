"""Device milliseconds per guided call of U-Net 1: the operations launched
inside the benchmark's range around ``imagen.unets[1]``, over its calls."""

RANGES = ("unet1",)


def read(r):
    tr, ranges = r.get("trace"), r.get("ranges")
    calls = ranges.calls.get("pb.unet1", 0) if ranges else 0
    return 1e3 * tr.range_device_s("unet1") / calls if calls else None
