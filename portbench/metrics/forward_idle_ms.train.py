"""Idle milliseconds of the card per train step charged to the forward pass:
the program's ``train.forward`` span and the ``unet.*`` spans under it
(``portbench/spans.py``)."""
from portbench import spans


def read(r):
    c = spans.charged(r)
    return None if c is None else c.idle_ms(under=("train.forward",))
