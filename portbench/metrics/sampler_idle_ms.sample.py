"""Idle milliseconds of the card per sampling call charged to the sampler's
own host work: the program's ``sample``, ``sample.stage``, ``sample.step``
and ``sample.threshold`` spans innermost on the host (``portbench/spans.py``)."""
from portbench import spans


def read(r):
    c = spans.charged(r)
    return None if c is None else c.idle_ms(
        innermost=("sample", "sample.stage", "sample.step", "sample.threshold"))
