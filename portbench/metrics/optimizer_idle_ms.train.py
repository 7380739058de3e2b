"""Idle milliseconds of the card per train step charged to the update: the
program's ``train.optimizer`` (gradient list, clip, Adam) and ``train.ema``
spans (``portbench/spans.py``)."""
from portbench import spans


def read(r):
    c = spans.charged(r)
    return None if c is None else c.idle_ms(under=("train.optimizer", "train.ema"))
