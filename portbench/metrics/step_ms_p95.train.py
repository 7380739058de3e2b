"""95th percentile of the train steps' times in the traced run's window,
each the interval between CUDA events recorded on the stream at the step's
boundaries (no host sync per step)."""
import statistics


def read(r):
    ms = r["measured"].get("step_ms")
    if not ms or len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
