"""Share of the traced window (whole train steps) in which no operation
ran on the card: 100 x (1 - busy / window)."""


def read(r):
    tr = r.get("trace")
    return None if tr is None else 100.0 * (1.0 - tr.busy_s() / tr.window_s)
