"""3 x the forward FLOPs of both stages at the batch (no recompute, no
optimizer FLOPs) per step completed in the window, over the window's time,
as a share of the bf16 dense peak of one H100 SXM."""
from portbench import work


def read(r):
    m = r["measured"]
    return 100.0 * m["flops_per_s"] / work.PEAK_FLOPS if m.get("flops_per_s") else None
