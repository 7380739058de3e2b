"""Sum of the bound times of the GroupNorm modules' calls (normalise,
time scale-shift, SiLU) over the device time of the operations launched
inside them, in percent. Work from the shapes that entered each call."""
import sys

from portbench import work

RANGES = ("group_norm",)


def read(r):
    tr, ranges = r.get("trace"), r.get("ranges")
    shapes = ranges.shapes.get("pb.group_norm") if ranges else None
    device_s = tr.range_device_s("group_norm") if shapes else 0.0
    if not device_s:
        return None
    bound, by = work.group_norm_bound(shapes)
    print(f"portbench: GroupNorm bound {bound:.6g} s ({by}) over {device_s:.6g} device s",
          file=sys.stderr)
    return 100.0 * bound / device_s
