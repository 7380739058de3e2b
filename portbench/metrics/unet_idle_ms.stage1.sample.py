"""Idle milliseconds of the card per sampling call charged to U-Net 1's calls:
the program's ``unet.1`` span innermost on the host (``portbench/spans.py``)."""
from portbench import spans


def read(r):
    c = spans.charged(r)
    return None if c is None else c.idle_ms(innermost=("unet.1",))
