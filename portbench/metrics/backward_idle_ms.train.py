"""Idle milliseconds of the card per train step charged to the backward
pass: the program's ``train.backward`` span and the autograd Functions'
``attention.backward``, ``group_norm.backward`` and ``stem_conv.backward``
spans under it, on the autograd engine's thread (``portbench/spans.py``)."""
from portbench import spans


def read(r):
    c = spans.charged(r)
    return None if c is None else c.idle_ms(under=("train.backward",))
