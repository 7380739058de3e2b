"""Sum of the bound times of the attention modules' calls (``Attention``,
``CrossAttention``: projections, norms and the attention kernel) over the
device time of the operations launched inside them, in percent. Work from
the shapes that entered each call (``portbench/work.py``)."""
import sys

from portbench import work

RANGES = ("attention",)


def read(r):
    tr, ranges = r.get("trace"), r.get("ranges")
    shapes = ranges.shapes.get("pb.attention") if ranges else None
    device_s = tr.range_device_s("attention") if shapes else 0.0
    if not device_s:
        return None
    bound, by = work.attention_bound(shapes)
    print(f"portbench: attention bound {bound:.6g} s ({by}) over {device_s:.6g} device s",
          file=sys.stderr)
    return 100.0 * bound / device_s
