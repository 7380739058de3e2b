"""The port's spans (``utils/profiling.py::span``) on the CPU:

- with no profiler active, ``span`` is one shared null context and records
  nothing;
- under ``torch.profiler``, a guided or unguided two-stage ``Imagen.sample``
  records one ``sample`` holding two ``sample.stage`` spans, each holding
  one ``sample.step`` per step, each step one ``unet.<stage>`` and one
  ``sample.threshold``: one root, nested in time;
- a train step records ``train.step`` holding ``train.forward`` (the
  U-Nets' calls), ``train.backward`` (the autograd Functions' backwards),
  ``train.optimizer`` and ``train.ema``, in that order;
- the buffer keeps every span of many threads at once;
- ``trace`` writes the spans into its Chrome trace on the trace's clock.

On a card (``-m cuda``): the autograd Functions' backward spans come from
the autograd engine's thread, inside ``train.backward``, under a
profiler that records the card alone (as the benchmark's does). This file
imports no JAX, so the card's machine can run it:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.models.imagen import Imagen
from minimagen_tpu_torch.models.unet import UnetConfig
from minimagen_tpu_torch.utils import profiling

# two stages with attention and cross-attention, so that every autograd
# Function (attention, GroupNorm, the stem) runs in a train step
ATTN = UnetConfig(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
                  layer_cross_attns=(False, True), attend_at_middle=True, attn_heads=2)
L, DIM = 4, 32
BACKWARDS = ("attention.backward", "group_norm.backward", "stem_conv.backward")


def _imagen(device="cpu"):
    torch.manual_seed(0)
    return Imagen(unets=[ATTN, ATTN], image_sizes=(8, 16), timesteps=25, cond_drop_prob=0.15,
                  text_encoder_name="t5_small", text_embed_dim=DIM, device=device)


def _text(b=2, device="cpu"):
    g = torch.Generator().manual_seed(1)
    mask = torch.ones(b, L, dtype=torch.bool)
    mask[1:, 2:] = False
    return torch.randn(b, L, DIM, generator=g).to(device), mask.to(device)


def _recorded(fn, activities=(ProfilerActivity.CPU,)):
    profiling.drain_spans()
    with profile(activities=list(activities)):
        out = fn()
    return out, profiling.drain_spans()


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _nested(spans):
    """Every span is closed, shares the first span's root and lies inside
    its parent."""
    for s in spans:
        assert s.end_ns is not None and s.root == 0, s
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p, s)


def test_span_is_a_shared_null_context_without_a_profiler():
    profiling.drain_spans()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        with profiling.span("b"):
            pass
    assert profiling.drain_spans() == []


@pytest.mark.parametrize("sampler,steps", [("ddim", 2), ("dpmpp", 2), ("unipc", 2),
                                           ("ddpm", 25)])
@pytest.mark.parametrize("cond_scale", [3.0, 1.0], ids=["guided", "unguided"])
def test_sample_records_the_cascade_tree(sampler, steps, cond_scale):
    imagen = _imagen()
    enc, mask = _text()
    g = torch.Generator().manual_seed(2)
    _, spans = _recorded(lambda: imagen.sample(
        text_embeds=enc, text_masks=mask, cond_scale=cond_scale, sampler=sampler,
        sample_steps=steps, cache_interval=None, generator=g))
    _nested(spans)
    assert spans[0].name == "sample" and spans[0].parent is None
    stages = _children(spans, 0)
    assert [s.name for s in stages] == ["sample.stage"] * 2
    for stage, s in enumerate(stages):
        i = spans.index(s)
        loop = _children(spans, i)
        assert [t.name for t in loop] == ["sample.step"] * steps
        for step in loop:
            inside = [t.name for t in _children(spans, spans.index(step))]
            assert inside == [f"unet.{stage}", "sample.threshold"]
    assert len(spans) == 1 + 2 + 2 * steps * 3
    assert len({s.thread for s in spans}) == 1


def test_train_step_records_forward_backward_optimizer_ema():
    imagen = _imagen()
    opt = ttrain.make_optimizer(1e-4)
    state = ttrain.create_train_state(imagen, opt, ema=True)
    step_fn = ttrain.make_train_step(imagen, opt, ema_decay=0.99)
    enc, mask = _text(b=2)
    batch = {"image": torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(3)),
             "encoding": enc, "mask": mask}
    (state, losses), spans = _recorded(lambda: step_fn(state, batch, seed=4))
    assert state.step == 1 and bool(torch.isfinite(losses).all())
    _nested(spans)
    assert spans[0].name == "train.step"
    top = _children(spans, 0)
    assert [s.name for s in top] == ["train.forward", "train.backward", "train.optimizer",
                                     "train.ema"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))
    forward, backward = (spans.index(s) for s in top[:2])
    assert [s.name for s in _children(spans, forward)] == ["unet.0", "unet.1"]
    inside = _children(spans, backward)
    assert {s.name for s in inside} == set(BACKWARDS)  # the CPU runs backwards in place
    assert len(spans) == 1 + 4 + 2 + len(inside)


def test_span_buffer_keeps_every_span_of_many_threads():
    buf, n, threads_n = profiling._SpanBuffer(), 500, 16
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n):
                outer, inner = profiling._Span(f"outer{k}"), profiling._Span(f"inner{k}")
                buf.open(outer)
                buf.open(inner)
                buf.close(inner)
                buf.close(outer)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = buf.drain()
    assert len(spans) == 2 * n * threads_n and buf.drain() == []
    for s in spans:
        assert s.end_ns is not None
        if s.name.startswith("inner"):
            p = spans[s.parent]
            assert p.name == "outer" + s.name[5:] and p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        else:
            assert s.parent is None


def test_trace_writes_spans_over_the_operations(tmp_path):
    a = torch.randn(256, 256)
    with profiling.trace(str(tmp_path)):
        with profiling.span("around mm"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    events = json.load(open(profiling.find_trace(str(tmp_path))))["traceEvents"]
    (s,) = [e for e in events if e.get("cat") == "span"]
    (op,) = [e for e in events if e.get("name") == "aten::mm"]
    assert s["name"] == "around mm" and s["tid"] == op["tid"]
    assert s["ts"] < op["ts"] and op["ts"] + op["dur"] < s["ts"] + s["dur"]
    assert 4000 < s["dur"] < 1e6  # microseconds, as the trace's own
    assert profiling.drain_spans() == []


# --------------------------------------------------------------------------- #
# on the card                                                                  #
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backward_spans_come_from_the_autograd_thread_on_card(cuda):
    from minimagen_tpu_torch.generate import lite_imagen  # noqa: PLC0415

    torch.manual_seed(0)
    imagen = lite_imagen(param_dtype=torch.float32, device=cuda)
    opt = ttrain.make_optimizer(1e-4)
    state = ttrain.create_train_state(imagen, opt, ema=True)
    step_fn = ttrain.make_train_step(imagen, opt, ema_decay=0.9995)
    rng = np.random.default_rng(0)
    batch = {"image": torch.tensor(rng.uniform(size=(2, 256, 256, 3)), dtype=torch.float32,
                                   device=cuda),
             "encoding": torch.tensor(rng.normal(size=(2, 8, imagen.text_embed_dim)),
                                      dtype=torch.float32, device=cuda),
             "mask": torch.ones(2, 8, dtype=torch.bool, device=cuda)}
    state, _ = step_fn(state, batch)  # builds the kernels, warms every shape
    torch.cuda.synchronize()
    _, spans = _recorded(lambda: step_fn(state, batch), activities=(ProfilerActivity.CUDA,))
    torch.cuda.synchronize()
    _nested(spans)
    main = threading.get_native_id()
    (backward,) = [s for s in spans if s.name == "train.backward"]
    assert backward.thread == main and spans[backward.parent].name == "train.step"
    inside = [s for s in spans if s.name in BACKWARDS]
    assert {s.name for s in inside} == set(BACKWARDS)
    for s in inside:
        assert s.thread != main and s.root == 0
        assert backward.start_ns <= s.start_ns <= s.end_ns <= backward.end_ns
    print(f"{len(inside)} backward spans on thread(s) {sorted({s.thread for s in inside})}, "
          f"main {main}")
