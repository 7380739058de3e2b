"""The arithmetic of the float32 attention kernels (3xTF32 on the tensor
cores, ``minimagen_tpu_torch/csrc/flash_attention.cu``) on the CPU, against
the JAX package's float32 attention.

The kernels split each float32 operand x into big = tf32(x) and small =
tf32(x - big), tf32 being ``cvt.rna.tf32.f32`` (round the low 13 mantissa
bits to nearest, ties away from zero), and take a product A B as
A_small B_big + A_big B_small + A_big B_big in float32. This file emulates
that in torch (each tf32 product is exact in float32, the sums are float32)
through every product of the forward and backward, with the softmax, the
log-sum-exp, D = rowsum(dO * O) and the dropped-row rule in float32 as in the
kernels, and holds the result within 2e-5 of the largest value (the float32
kernels' limit) against the JAX package's plain XLA attention and its
``jax.vjp``, the reference its own tests use off the TPU. A one-pass TF32
product misses that limit, which is why the kernels split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.ops import attention as jattn

LIMIT = 2e-5  # relative to max(1, the largest reference value), as on the card
DROPPED_ROW_LSE = -1e29  # csrc/flash_attention.cu kDroppedRowLse


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 with its low 13 mantissa bits rounded
    off to nearest, ties away from zero (add half of the dropped range to
    the magnitude's bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_x3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum `eq` in 3xTF32: the small products first, float32 sums."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs) + torch.einsum(eq, ab, bb)


def mm_x1(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum `eq` in one-pass TF32."""
    return torch.einsum(eq, tf32_rna(a), tf32_rna(b))


def kernel_attention(kind, q, k, v, g, bias, mm=mm_x3):
    """(o, dq, dk, dv) as the float32 kernels compute them: every product
    through `mm`, the rest in float32. `bias` (b, j) or None."""
    kv = "bjd" if kind == "mqa" else "bhjd"
    s = mm(f"bhnd,{kv}->bhnj", q, k)
    if bias is not None:
        s = s + bias[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    total = p.sum(-1, keepdim=True)
    o = mm(f"bhnj,{kv}->bhnd", p, v) / total  # the late divide
    lse = m + torch.log(total)
    # the backward: P from the log-sum-exp; a row whose every key is dropped
    # is measured from its floor and gets P = 1/j (dropped_row)
    dropped = lse < DROPPED_ROW_LSE
    floor = torch.where(dropped, lse, torch.zeros_like(lse))
    neg_lse = torch.where(dropped, torch.full_like(lse, -float(np.log(s.shape[-1]))), -lse)
    p = torch.exp(s - floor + neg_lse)
    delta = (g * o).sum(-1, keepdim=True)
    dp = mm(f"bhnd,{kv}->bhnj", g, v)
    ds = p * (dp - delta)
    dq = mm(f"bhnj,{kv}->bhnd", ds, k)
    dk = mm(f"bhnj,bhnd->{kv}", ds, q)
    dv = mm(f"bhnj,bhnd->{kv}", p, g)
    return o, dq, dk, dv


def jax_attention(kind, q, k, v, g, bias):
    """The JAX package's float32 attention (plain XLA) and its gradients."""
    jbias = None if bias is None else jnp.asarray(bias)[:, None, None, :]
    if kind == "mqa":
        fn = lambda a, b, c: jattn.multi_query_attention(a, b, c, attn_bias=jbias)  # noqa: E731
    else:
        fn = lambda a, b, c: jattn._mha_xla_attn(a, b, c, jbias)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (out, *vjp(jnp.asarray(g)))


def _inputs(kind, b, h, n, j, drop, seed=0):
    """Seeded float32 inputs, q pre-scaled; `drop` None (no bias), "quarter"
    (a mask bias dropping about a quarter of the keys, never key 0) or
    "sample" (that, and sample 1 dropping every key)."""
    rng = np.random.default_rng(seed)
    kv = (b, j, 64) if kind == "mqa" else (b, h, j, 64)
    q = (rng.normal(size=(b, h, n, 64)) / 8.0).astype(np.float32)
    k, v = (rng.normal(size=kv).astype(np.float32) for _ in "kv")
    g = rng.normal(size=(b, h, n, 64)).astype(np.float32)
    bias = None
    if drop is not None:
        keep = rng.uniform(size=(b, j)) >= 0.25
        keep[:, 0] = True
        if drop == "sample":
            keep[1] = False
        bias = np.where(keep, 0.0, -1e30).astype(np.float32)
    return q, k, v, g, bias


def _errors(ours, refs):
    """Per output, (max abs difference, limit)."""
    out = []
    for a, r in zip(ours, refs):
        r = np.asarray(r, np.float64)
        assert a.shape == r.shape
        out.append((float(np.abs(a.numpy().astype(np.float64) - r).max()),
                    LIMIT * max(1.0, float(np.abs(r).max()))))
    return out


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # tf32 keeps 10 explicit mantissa bits
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 + 2.0 ** -23, 3.0], dtype=torch.float32)
    want = [1.0, 1.0 + one_ulp, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0 + one_ulp, 3.0]
    assert tf32_rna(x).tolist() == want
    assert (tf32_rna(x).view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    big, small = split(r)
    # big + small recovers x to ~2^-22 relative; big alone to ~2^-11
    assert float(((big.double() + small.double() - r.double()).abs() / r.abs()).max()) < 2.0 ** -21
    assert float(((big.double() - r.double()).abs() / r.abs()).max()) <= 2.0 ** -11


def test_accumulator_columns_as_a_fragments_need_the_permuted_b_rows():
    """Thread (g, t) holds accumulator columns 2t, 2t + 1 of each 8 and the
    tf32 A fragment reads them as columns t, t + 4: the product comes out
    right when B's rows are in the order attention_tf32_split_t_kernel
    writes (column i of each 8 holds row i < 4 ? 2i : 2(i - 4) + 1)."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float64))
    b = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float64))
    perm = [8 * c + (i * 2 if i < 4 else 2 * (i - 4) + 1) for c in range(4) for i in range(8)]
    a_logical = p[:, perm]  # what the A fragments hold, column by logical k
    assert torch.allclose(a_logical @ b[perm], p @ b)
    assert not torch.allclose(a_logical @ b, p @ b)


# (kind, b, h, n, j, drop): multi-query at the self-attention path shape
# (a lone key in the last tile), multi-head with a mask bias at the
# cross-attention path shape, a ragged case (n and j in no tile multiple),
# and a sample whose every key is dropped, for both kinds
CASES = [("mqa", 2, 8, 1024, 1025, None), ("mha", 2, 8, 1024, 259, "quarter"),
         ("mha", 2, 3, 100, 7, "quarter"), ("mqa", 2, 8, 100, 130, "quarter"),
         ("mha", 3, 8, 64, 65, "sample"), ("mqa", 3, 8, 64, 65, "sample")]


@pytest.mark.parametrize("kind,b,h,n,j,drop", CASES)
def test_3xtf32_attention_matches_jax_float32(kind, b, h, n, j, drop):
    q, k, v, g, bias = _inputs(kind, b, h, n, j, drop)
    ours = kernel_attention(kind, *(torch.from_numpy(a) for a in (q, k, v, g)),
                            None if bias is None else torch.from_numpy(bias))
    refs = jax_attention(kind, q, k, v, g, bias)
    for name, (err, lim) in zip(("o", "dq", "dk", "dv"), _errors(ours, refs)):
        assert err <= lim, (name, err, lim)
    if drop == "sample":  # the dropped sample's rows average V over all j keys
        mean_v = v[1].mean(axis=-2)
        np.testing.assert_allclose(ours[0][1].numpy(), np.broadcast_to(
            mean_v[None, None] if kind == "mqa" else mean_v[:, None], ours[0][1].shape),
            rtol=0, atol=LIMIT)


def test_one_pass_tf32_misses_the_float32_limit():
    """The same attention with one TF32 product each: the output or a
    gradient lands outside 2e-5 of the JAX package's float32, by a wide
    margin (TF32 keeps ~3 decimal digits)."""
    q, k, v, g, bias = _inputs("mqa", 2, 8, 1024, 1025, None)
    ours = kernel_attention("mqa", *(torch.from_numpy(a) for a in (q, k, v, g)), None, mm=mm_x1)
    errors = _errors(ours, jax_attention("mqa", q, k, v, g, bias))
    assert max(err / lim for err, lim in errors) > 10.0, errors
