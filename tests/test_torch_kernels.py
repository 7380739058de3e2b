"""The port's CUDA kernels (minimagen_tpu_torch/csrc) and their wrappers.

On the CPU: the wrappers take the plain versions and count no launch, the
build command targets sm_90a with a plain C interface, and the library name
follows the sources' hash. On a card (tests marked ``cuda``, skipped
without one): each kernel against its plain version in float32 and
bfloat16. This file imports no JAX, so the card's machine can run it:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from minimagen_tpu_torch.ops import flash_attention as tflash
from minimagen_tpu_torch.ops import group_norm as tgn
from minimagen_tpu_torch.ops import kernels
from minimagen_tpu_torch.ops import stem_conv as tstem


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(b, h, n, j, d, per_head, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32) * d ** -0.5
    kv_shape = (b, h, j, d) if per_head else (b, j, d)
    return q, rng.normal(size=kv_shape).astype(np.float32), rng.normal(size=kv_shape).astype(np.float32)


def _gn_inputs(b, h, w, c, seed=8):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 3.0 + 0.5).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    ss = tuple((rng.normal(size=(b, 1, 1, c)) * 0.3).astype(np.float32) for _ in range(2))
    return x, gamma, beta, ss


# --------------------------------------------------------------------------- #
# kernel wrappers and the build                                               #
# --------------------------------------------------------------------------- #
def test_wrappers_use_plain_versions_on_cpu_and_do_not_count():
    kernels.reset_launch_counts()
    q, k, v = _qkv(1, 2, 16, 17, 64, per_head=False)
    assert torch.equal(tflash.mqa_flash(_t(q), _t(k), _t(v)), tflash.mqa_plain(_t(q), _t(k), _t(v)))
    q, k, v = _qkv(1, 2, 16, 21, 64, per_head=True)
    assert torch.equal(tflash.mha_flash(_t(q), _t(k), _t(v)), tflash.mha_plain(_t(q), _t(k), _t(v)))
    x, gamma, beta, _ = _gn_inputs(1, 4, 4, 16)
    assert torch.equal(tgn.group_norm_silu(_t(x), _t(gamma), _t(beta), groups=8, silu=True),
                       tgn.group_norm_silu_plain(_t(x), _t(gamma), _t(beta), groups=8, silu=True))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_depth_to_space_bias_uses_plain_version_on_cpu():
    y2 = torch.randn(2, 4, 4, 4 * 8, generator=torch.Generator().manual_seed(0))
    bias = torch.randn(8, generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    assert torch.equal(tstem.depth_to_space_bias(y2, bias, 2),
                       tstem.depth_to_space_bias_plain(y2, bias, 2))
    assert kernels.LAUNCHES["depth_to_space_bias"] == 0


def test_wrapper_checks_run_before_any_build():
    """A bad call raises ValueError from the wrapper's checks; this one
    also shows the GN wrapper rejects indivisible channels."""
    with pytest.raises(ValueError, match="not divisible"):
        tgn.group_norm_silu(torch.zeros(1, 2, 2, 10), torch.ones(10), torch.zeros(10), groups=8)


def test_nvcc_command_builds_all_sources_for_sm90a(monkeypatch):
    monkeypatch.setattr(kernels, "nvcc_executable", lambda: "nvcc")
    cmd = kernels.nvcc_command("out.so")
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-fPIC" in cmd and cmd[cmd.index("-o") + 1] == "out.so"
    cu = sorted(os.path.basename(p) for p in cmd if p.endswith(".cu"))
    assert cu == ["depth_to_space.cu", "flash_attention.cu", "group_norm.cu"]
    assert not any(a.startswith("-I") for a in cmd)  # no PyTorch headers: plain C interface
    for src in kernels.sources():
        assert "torch/" not in open(src).read(), src


def test_library_name_tracks_source_hash(tmp_path, monkeypatch):
    for p in kernels.sources():
        (tmp_path / os.path.basename(p)).write_bytes(open(p, "rb").read())
    monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
    before = kernels.library_path()
    assert before == kernels.library_path()
    (tmp_path / "group_norm.cu").write_text((tmp_path / "group_norm.cu").read_text() + "\n// edit\n")
    assert kernels.library_path() != before


def test_c_signatures_declare_pointer_width_arguments():
    for name, argtypes in kernels.SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, f"{name}: the stream must be a pointer"
    assert kernels.SIGNATURES["mmt_mqa_forward"][:4] == [ctypes.c_void_p] * 4


# --------------------------------------------------------------------------- #
# kernels against their plain versions (need the card)                        #
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tol(dtype, ref):
    scale = max(1.0, float(ref.abs().max()))
    return (2 ** -6 if dtype == torch.bfloat16 else 2e-5) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,j,per_head", [(64, 65, False), (1024, 1025, False),
                                          (256, 259, True), (1024, 261, True), (64, 19, True),
                                          (100, 7, True), (100, 130, False)])
def test_attention_kernels_match_plain_on_card(cuda, dtype, n, j, per_head):
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(4, 8, n, j, 64, per_head))
    fn, plain = (tflash.mha_flash, tflash.mha_plain) if per_head else (tflash.mqa_flash, tflash.mqa_plain)
    out, ref = fn(q, k, v), plain(q, k, v)
    torch.cuda.synchronize()
    assert float((out.float() - ref.float()).abs().max()) <= _tol(dtype, ref.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 64, 64), (4, 8, 8, 256), (2, 256, 256, 32),
                                   (2, 8, 8, 192), (3, 5, 7, 16)])
@pytest.mark.parametrize("with_ss_silu", [True, False])
def test_group_norm_kernel_matches_plain_on_card(cuda, dtype, shape, with_ss_silu):
    x, gamma, beta, ss = _gn_inputs(*shape)
    ss = tuple(_t(s).to(cuda, dtype) for s in ss) if with_ss_silu else None
    x, gamma, beta = _t(x).to(cuda, dtype), _t(gamma).to(cuda, dtype), _t(beta).to(cuda, dtype)
    kw = dict(groups=8, scale_shift=ss, silu=with_ss_silu)
    out = tgn.group_norm_silu(x, gamma, beta, **kw)
    ref = tgn.group_norm_silu_plain(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert float((out.float() - ref.float()).abs().max()) <= _tol(dtype, ref.float())


# --------------------------------------------------------------------------- #
# backward kernels against their plain versions (need the card)               #
# --------------------------------------------------------------------------- #
def _mask_bias_np(b, j, seed=3):
    """A (b, 1, 1, j) float32 bias from a mask that drops about a quarter of
    the keys (never key 0, the null token)."""
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=(b, j)) >= 0.25
    keep[:, 0] = True
    return np.where(keep, 0.0, tflash.NEG_INF).astype(np.float32)[:, None, None, :]


def _attention_case(cuda, dtype, kind, b, n, j, with_bias, seed=5):
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(b, 8, n, j, 64, kind == "mha", seed))
    g = _t(np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)).to(cuda, dtype)
    bias = _t(_mask_bias_np(b, j)).to(cuda) if with_bias else None
    return q, k, v, g, bias


ATTN_BWD_CASES = [("mqa", 2, 64, 65, False), ("mqa", 2, 1024, 1025, False),
                  ("mqa", 2, 100, 130, True), ("mha", 2, 1024, 259, False),
                  ("mha", 2, 256, 261, True), ("mha", 2, 100, 7, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,n,j,with_bias", ATTN_BWD_CASES)
def test_attention_backward_kernels_match_plain_on_card(cuda, dtype, kind, b, n, j, with_bias):
    """Forward (with the bias and the log-sum-exp) and backward kernels
    against the plain versions: bf16 within 2^-6 of the largest output (P
    and dS are rounded to bf16 as tensor-core operands, and D comes from the
    stored bf16 O), float32 within 2e-5 relative."""
    q, k, v, g, bias = _attention_case(cuda, dtype, kind, b, n, j, with_bias)
    plain, plain_bwd = tflash._PLAIN[kind]
    out, lse = tflash.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    grads = tflash.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    refs = (plain(q, k, v, attn_bias=bias), *plain_bwd(q, k, v, g, attn_bias=bias))
    torch.cuda.synchronize()
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        err = float((got.float() - ref.float()).abs().max())
        assert err <= _tol(dtype, ref.float()), (name, err)
    s = torch.einsum("bhnd,bjd->bhnj" if kind == "mqa" else "bhnd,bhjd->bhnj", q.float(), k.float())
    ref_lse = torch.logsumexp(s if bias is None else s + bias, dim=-1)
    assert float((lse - ref_lse).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_attention_backward_is_deterministic_on_card(cuda, kind):
    """dk and dv are summed in a fixed order: two runs give the same bits."""
    q, k, v, g, bias = _attention_case(cuda, torch.bfloat16, kind, 4, 1024, 1025 if kind == "mqa" else 259,
                                       kind == "mha")
    out, lse = tflash.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    first = tflash.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    second = tflash.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_functions_launch_backward_kernels_on_card(cuda):
    """torch.autograd through the wrappers launches each backward kernel
    once, and a masked multi_head_attention takes the biased kernel."""
    from minimagen_tpu_torch.ops import attention as tattn

    kernels.reset_launch_counts()
    q, k, v, g, _ = _attention_case(cuda, torch.bfloat16, "mqa", 2, 64, 65, False)
    q.requires_grad_()
    k.requires_grad_()
    dq, dk = torch.autograd.grad(tflash.mqa_flash(q, k, v), (q, k), g)
    assert dq.shape == q.shape and dk.shape == k.shape
    q, k, v, g, _ = _attention_case(cuda, torch.bfloat16, "mha", 2, 64, 19, False)
    mask = torch.ones(2, 19, dtype=torch.bool, device=cuda)
    mask[1, 10:] = False
    q.requires_grad_()
    out = tattn.multi_head_attention(q, k, v, mask=mask)
    (dq,) = torch.autograd.grad(out, (q,), g)
    ref = tflash.mha_plain(q.detach(), k, v, mask=mask)
    err = float((out.detach().float() - ref.float()).abs().max())
    assert err <= _tol(torch.bfloat16, ref.float())
    x, gamma, beta, ss = _gn_inputs(2, 8, 8, 64)
    x = _t(x).to(cuda, torch.bfloat16).requires_grad_()
    gamma = _t(gamma).to(cuda).requires_grad_()
    y = tgn.group_norm_silu(x, gamma, _t(beta).to(cuda),
                            scale_shift=tuple(_t(s).to(cuda, torch.bfloat16) for s in ss),
                            groups=8, silu=True)
    dx, dgamma = torch.autograd.grad(y, (x, gamma), torch.ones_like(y))
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == torch.float32
    assert {n: kernels.LAUNCHES[n] for n in ("mqa_backward", "mha_backward", "group_norm_backward")} \
        == {"mqa_backward": 1, "mha_backward": 1, "group_norm_backward": 1}
    assert kernels.LAUNCHES["mha_forward"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 64, 64), (4, 8, 8, 256), (2, 256, 256, 32),
                                   (2, 8, 8, 512), (3, 5, 7, 16)])
@pytest.mark.parametrize("with_ss_silu", [True, False])
def test_group_norm_backward_kernel_matches_plain_on_card(cuda, dtype, shape, with_ss_silu):
    """dx, dgamma, dbeta, dscale and dshift against the plain float32 closed
    form at the kernel's own statistics; limits as for the forward, per
    output."""
    x, gamma, beta, ss = _gn_inputs(*shape)
    scale, shift = (_t(s).to(cuda, dtype) for s in ss) if with_ss_silu else (None, None)
    x, gamma, beta = _t(x).to(cuda, dtype), _t(gamma).to(cuda, dtype), _t(beta).to(cuda, dtype)
    g = _t(np.random.default_rng(9).normal(size=shape).astype(np.float32)).to(cuda, dtype)
    kw = dict(groups=8, silu=with_ss_silu)
    _, mean, rstd = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    got = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    ref = tgn.group_norm_silu_bwd_plain(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), got, ref):
        if r is None:
            assert a is None, name
            continue
        err = float((a.float() - r.float()).abs().max())
        assert err <= _tol(dtype, r.float()), (name, err)


# --------------------------------------------------------------------------- #
# kernel 8 and the wide shapes of the Base/Super cascade (need the card)       #
# --------------------------------------------------------------------------- #
# (y2 shape, f): the s2d-4 stem outputs of the lite base (64px, dim 64) and
# SR (256px, dim 32) stems at 16 guided rows, and of Base (64px, dim 512) and
# Super (128px, dim 128) at 8; plus an s2d-2 shape and a channel count that
# is not a multiple of a 16-byte vector
D2S_CASES = [((16, 16, 16, 1024), 4), ((16, 64, 64, 512), 4), ((8, 16, 16, 8192), 4),
             ((8, 32, 32, 2048), 4), ((2, 32, 32, 4 * 64), 2), ((2, 8, 8, 16 * 6), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f", D2S_CASES)
def test_depth_to_space_bias_kernel_is_bit_equal_on_card(cuda, dtype, shape, f):
    """Kernel 8 against its plain version: the same bits (one float32 add of
    two values of the type, rounded once)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    y2 = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    bias = torch.randn(shape[-1] // (f * f), generator=gen, device=cuda).to(dtype)
    kernels.reset_launch_counts()
    out = tstem.depth_to_space_bias(y2, bias, f)
    ref = tstem.depth_to_space_bias_plain(y2, bias, f)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["depth_to_space_bias"] == 1
    assert out.dtype == ref.dtype and torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 1536), (2, 8, 8, 2048), (2, 16, 16, 2560),
                                   (2, 8, 8, 3584)])
def test_group_norm_kernels_above_1024_channels_on_card(cuda, dtype, shape):
    """Forward and backward at Base's widest GroupNorms (channels split over
    blocks), with scale-shift and SiLU; limits as above; two runs give the
    same bits."""
    x, gamma, beta, ss = _gn_inputs(*shape)
    scale, shift = (_t(s).to(cuda, dtype) for s in ss)
    x, gamma, beta = _t(x).to(cuda, dtype), _t(gamma).to(cuda, dtype), _t(beta).to(cuda, dtype)
    g = _t(np.random.default_rng(9).normal(size=shape).astype(np.float32)).to(cuda, dtype)
    kw = dict(groups=8, silu=True)
    y, mean, rstd = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    ref = tgn.group_norm_silu_plain(x, gamma, beta, scale_shift=(scale, shift), **kw)
    got = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    again = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    want = tgn.group_norm_silu_bwd_plain(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    torch.cuda.synchronize()
    assert float((y.float() - ref.float()).abs().max()) <= _tol(dtype, ref.float())
    for name, a, r, b in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), got, want, again):
        err = float((a.float() - r.float()).abs().max())
        assert err <= _tol(dtype, r.float()), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_attention_above_65535_sample_heads_on_card(cuda, kind):
    """batch * heads = 8193 * 8 = 65544 (past the old grid-y limit):
    forward and backward kernels against the plain versions at n 16, j 17."""
    q, k, v, g, _ = _attention_case(cuda, torch.bfloat16, kind, 8193, 16, 17, False)
    plain, plain_bwd = tflash._PLAIN[kind]
    out, lse = tflash.attention_forward_kernel(kind, q, k, v, None, with_lse=True)
    grads = tflash.attention_backward_kernel(kind, q, k, v, None, out, g, lse)
    refs = (plain(q, k, v), *plain_bwd(q, k, v, g))
    torch.cuda.synchronize()
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), refs):
        err = float((got.float() - ref.float()).abs().max())
        assert err <= _tol(torch.bfloat16, ref.float()), (name, err)
