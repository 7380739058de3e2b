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
    """One compile per source (started together by ``build``), each for
    sm_90a with position-independent code, then one link of their objects
    into the shared library."""
    monkeypatch.setattr(kernels, "nvcc_executable", lambda: "nvcc")
    compiles, link = kernels.nvcc_commands("out.so")
    objects = []
    for cmd in compiles:
        assert "-gencode arch=compute_90a,code=sm_90a" in " ".join(cmd)
        assert "-c" in cmd and "-fPIC" in cmd and "-shared" not in cmd
        objects.append(cmd[cmd.index("-o") + 1])
        assert not any(a.startswith("-I") for a in cmd)  # no PyTorch headers: plain C interface
    cu = sorted(os.path.basename(cmd[-1]) for cmd in compiles)
    assert cu == ["depth_to_space.cu", "flash_attention.cu", "group_norm.cu"]
    assert "-shared" in link and link[link.index("-o") + 1] == "out.so"
    assert link[-len(objects):] == objects and len(set(objects)) == 3
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


@pytest.mark.parametrize("b,h,n,j", [(16, 8, 1024, 1025), (2, 8, 100, 101), (3, 1, 5, 7),
                                     (8193, 8, 16, 17)])
def test_backward_scratch_is_sized_by_kind(b, h, n, j):
    """Both types' backwards keep D and a copy of the lse (each q-batch's
    rows rounded up to 32 floats, the whole to 64), so that the dk/dv pass's
    boxes start 16-byte aligned at any row count. The bf16 ones then keep,
    multi-query, at most 4 float32 dk/dv slices per sample, multi-head none
    unless its dk/dv pass splits the rows, then one slice per split and
    (sample, head). The float32 (3xTF32) kernels keep one dk/dv
    slice per split and q-batch (a sample for multi-query, a (sample, head)
    for multi-head) only where the rows split, then the inputs in big and
    small tf32 parts: q and dO, k and v, then K^T, Q^T and dO^T padded to
    64 keys or rows; their forward keeps K and V^T in both parts."""
    pad = lambda x: -(-x // 64) * 64  # noqa: E731
    for kind in ("mqa", "mha"):
        qbatch, rows = (b, h * n) if kind == "mqa" else (b * h, n)
        lse_d = 2 * pad(qbatch * -(-rows // 32) * 32)
        split = 4 * qbatch * rows * 64 + 4 * qbatch * j * 64 + 2 * qbatch * 64 * pad(j) \
            + 4 * qbatch * 64 * pad(rows)
        assert tflash.backward_scratch_floats(kind, torch.float32, b, h, n, j) \
            == lse_d + split
        for splits in (2, tflash.MAX_ROW_SPLITS):
            got = tflash.backward_scratch_floats(kind, torch.float32, b, h, n, j, splits=splits)
            assert got == lse_d + 2 * splits * qbatch * j * 64 + split
        assert tflash.forward_scratch_floats(kind, torch.float32, b, h, n, j) \
            == 2 * qbatch * j * 64 + 2 * qbatch * 64 * pad(j)
        assert tflash.forward_scratch_floats(kind, torch.bfloat16, b, h, n, j) == 0
    mqa_d = 2 * pad(b * -(-h * n // 32) * 32)
    mha_d = 2 * pad(b * h * -(-n // 32) * 32)
    assert mqa_d >= 2 * b * h * n and mha_d >= 2 * b * h * n
    got = tflash.backward_scratch_floats("mqa", torch.bfloat16, b, h, n, j)
    assert got == mqa_d + 2 * tflash.MAX_ROW_SPLITS * b * j * 64
    assert tflash.backward_scratch_floats("mha", torch.bfloat16, b, h, n, j) == mha_d
    for splits in (2, tflash.MAX_ROW_SPLITS):
        got = tflash.backward_scratch_floats("mha", torch.bfloat16, b, h, n, j, splits=splits)
        assert got == mha_d + 2 * splits * b * h * j * 64
    src = open(os.path.join(kernels.CSRC_DIR, "flash_attention.cu")).read()
    assert f"constexpr int kMaxRowSplits = {tflash.MAX_ROW_SPLITS};" in src


def test_every_attention_kernel_falls_in_a_profile_family():
    """Every __global__ kernel of csrc/flash_attention.cu carries a name tag of
    ab_times.ATTENTION_FAMILIES, so the profiles attribute every attention
    launch: the Hopper multi-query and multi-head kernels each a family of
    their own; no bf16 mma.sync kernel is left."""
    import re

    from minimagen_tpu_torch.ab_times import ATTENTION_FAMILIES

    src = open(os.path.join(kernels.CSRC_DIR, "flash_attention.cu")).read()
    names = [re.search(r"(\w+_kernel)\s*\(", src[i:src.index("{", i)]).group(1)
             for i in (m.start() for m in re.finditer(r"__global__", src))]
    assert len(names) >= 7
    for name in names:
        assert [tag for tag in ATTENTION_FAMILIES.values() if tag in name], name
    assert {n for n in names if n.startswith(("mqa_", "mha_"))} == {
        "mqa_fwd_hopper_kernel", "mqa_bwd_dq_hopper_kernel", "mqa_bwd_dkdv_hopper_kernel",
        "mha_fwd_hopper_kernel", "mha_bwd_dq_hopper_kernel", "mha_bwd_dkdv_hopper_kernel"}
    assert not [n for n in names if "bf16" in n] and "mma.sync" not in src


def test_every_group_norm_kernel_falls_in_the_profile_family():
    """Every __global__ kernel of csrc/group_norm.cu carries a tag of
    ab_times.GROUP_NORM_TAGS, so the profiles' GroupNorm family holds every
    GroupNorm launch: the cluster forms and the two streaming sweeps."""
    import re

    from minimagen_tpu_torch.ab_times import FAMILIES, GROUP_NORM_TAGS

    src = open(os.path.join(kernels.CSRC_DIR, "group_norm.cu")).read()
    names = [re.search(r"(\w+_kernel)\s*\(", src[i:src.index("{", i)]).group(1)
             for i in (m.start() for m in re.finditer(r"__global__", src))]
    assert set(names) == {"gn_fwd_cluster_kernel", "gn_fwd_stats_kernel", "gn_fwd_apply_kernel",
                          "gn_bwd_cluster_kernel", "gn_bwd_partial_kernel", "gn_bwd_apply_kernel"}
    for name in names:
        assert [t for t in GROUP_NORM_TAGS if t in name], name
        assert [f for f, tags in FAMILIES.items() if any(t in name for t in tags)] == ["group_norm"]


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


# (n, j) of the bf16 multi-query kernels' edges: n = 64 (a block's 128 rows
# span two heads), n = 100 (a ragged row block across a head boundary), 256
# and 1024; j = n + 1 (a lone key in the last tile) and j one short of
# filling its last tile; each without and with the bias
MQA_EDGES = [(64, 65), (64, 127), (100, 101), (100, 191), (256, 257), (256, 319), (1024, 1025),
             (1024, 1087)]
ATTN_BWD_CASES = [("mqa", 2, 64, 65, False), ("mqa", 2, 1024, 1025, False),
                  ("mqa", 2, 100, 130, True), ("mha", 2, 1024, 259, False),
                  ("mha", 2, 256, 261, True), ("mha", 2, 100, 7, True)]
ATTN_BWD_CASES += [("mqa", 2, n, j, bias) for n, j in MQA_EDGES for bias in (False, True)
                   if ("mqa", 2, n, j, bias) not in ATTN_BWD_CASES]
# (n, j) of the bf16 multi-head kernels' edges: n = 64 (one consumer
# warpgroup), 100 (a ragged row tile), 256 and 1024; j = 7, 19, 21 (the tail
# is the only tile), 64 and 320 (no ragged tail), 65 and 321 (a one-key
# tail), 259 and 261 (the main path's narrow tails); each without and with
# the bias
MHA_EDGES = [(n, j) for n in (64, 100, 256, 1024) for j in (7, 19, 21, 64, 65, 259, 261, 320, 321)]
ATTN_BWD_CASES += [("mha", 2, n, j, bias) for n, j in MHA_EDGES for bias in (False, True)
                   if ("mha", 2, n, j, bias) not in ATTN_BWD_CASES]
# 128 (sample, head)s, as on the lite path: forward blocks that walk 4 row
# blocks of 4 warpgroups each, and 16 of 15 one-warpgroup row blocks (n 960)
ATTN_BWD_CASES += [("mha", 16, 1024, 259, True), ("mha", 16, 1024, 261, False),
                   ("mha", 16, 960, 259, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,n,j,with_bias", ATTN_BWD_CASES)
def test_attention_backward_kernels_match_plain_on_card(cuda, dtype, kind, b, n, j, with_bias):
    """Forward (with the bias, with and without the log-sum-exp) and
    backward kernels against the plain versions: bf16 within 2^-6 of the
    largest output (P and dS are rounded to bf16 as tensor-core operands,
    and D comes from the stored bf16 O), float32 within 2e-5 relative; the
    forward gives the same bits whether or not it writes the log-sum-exp."""
    _check_forward_backward(kind, dtype, *_attention_case(cuda, dtype, kind, b, n, j, with_bias))


def _check_forward_backward(kind, dtype, q, k, v, g, bias):
    """Forward (with and without the log-sum-exp) and backward kernels
    against the plain versions at the limits of `_tol`, and the kernel's
    log-sum-exp within 1e-3 of the logits' own."""
    plain, plain_bwd = tflash._PLAIN[kind]
    bare, none = tflash.attention_forward_kernel(kind, q, k, v, bias)
    out, lse = tflash.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    grads = tflash.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    refs = (plain(q, k, v, attn_bias=bias), *plain_bwd(q, k, v, g, attn_bias=bias))
    torch.cuda.synchronize()
    assert none is None and torch.equal(bare, out)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        err = float((got.float() - ref.float()).abs().max())
        assert err <= _tol(dtype, ref.float()), (name, err)
    s = torch.einsum("bhnd,bjd->bhnj" if kind == "mqa" else "bhnd,bhjd->bhnj", q.float(), k.float())
    ref_lse = torch.logsumexp(s if bias is None else s + bias, dim=-1)
    assert float((lse - ref_lse).abs().max()) <= 1e-3


# (kind, n, j) through each kernel's paths with a sample whose mask drops
# every key: multi-query rows across heads, a lone-key and a ragged tail;
# multi-head narrow tails (7, 19, 261), a one-key tail (65) and the lite
# path's 259 at n = 1024
DROPPED_ROW_CASES = [("mqa", 64, 65), ("mqa", 100, 130), ("mqa", 1024, 1025), ("mha", 100, 7),
                     ("mha", 64, 19), ("mha", 64, 65), ("mha", 256, 261), ("mha", 1024, 259)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,n,j", DROPPED_ROW_CASES)
def test_attention_kernels_on_fully_dropped_rows_on_card(cuda, dtype, kind, n, j):
    """Sample 1 of 3 drops every key (the others about a quarter): its rows
    attend uniformly, P = 1/j per key, in the forward and in every backward
    kernel, as in the plain versions; the same limits as above."""
    q, k, v, g, _ = _attention_case(cuda, dtype, kind, 3, n, j, False)
    bias = _mask_bias_np(3, j)
    bias[1] = tflash.NEG_INF
    _check_forward_backward(kind, dtype, q, k, v, g, _t(bias).to(cuda))


# float32 (3xTF32) cases: the path's shapes at batch 16 (self-attention
# n + 1 keys at n = 1024, 256, 64; cross-attention 259/261 keys with the
# mask bias), and the edges: one row and key tile far from full (3, 1, 5, 7),
# a ragged row tile across heads and a ragged key tile (2, 8, 100, 101)
F32_PATH_CASES = [("mqa", 16, 8, 1024, 1025, False), ("mqa", 16, 8, 256, 257, False),
                  ("mqa", 16, 8, 64, 65, False), ("mha", 16, 8, 1024, 259, True),
                  ("mha", 16, 8, 1024, 261, False), ("mha", 16, 8, 256, 259, True),
                  ("mha", 16, 8, 64, 261, True), ("mqa", 3, 1, 5, 7, False),
                  ("mha", 3, 1, 5, 7, True), ("mqa", 2, 8, 100, 101, True),
                  ("mha", 2, 8, 100, 101, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,h,n,j,with_bias", F32_PATH_CASES)
def test_float32_attention_at_path_and_edge_shapes_on_card(cuda, kind, b, h, n, j, with_bias):
    """The 3xTF32 forward and backward against the plain float32 versions
    within 2e-5 relative, at the main path's shapes and the edge shapes."""
    q, k, v = (_t(a).to(cuda) for a in _qkv(b, h, n, j, 64, kind == "mha"))
    g = _t(np.random.default_rng(6).normal(size=q.shape).astype(np.float32)).to(cuda)
    bias = _t(_mask_bias_np(b, j)).to(cuda) if with_bias else None
    _check_forward_backward(kind, torch.float32, q, k, v, g, bias)


# the default cascade's float32 train step at Base 16px / Super 32px, batch
# 2 (chip_smoke.py phase 16a): the backward calls whose card / CPU distance
# from float64 was largest when every float32 backward call of that step was
# held against float64 (PERF.md §6): attention (kind, b, h, n, j, bias) and
# GroupNorm (b, h, w, c) at 8 groups with the time scale-shift and SiLU
F64_ATTENTION_CASES = [("mha", 2, 8, 64, 259, True), ("mha", 2, 8, 16, 259, True),
                       ("mqa", 2, 8, 64, 65, False), ("mqa", 2, 8, 16, 17, False)]
F64_GROUP_NORM_CASES = [(2, 32, 32, 128), (2, 4, 4, 512)]
F64_FACTOR = 10.0  # a kernel more than this much farther from float64 than the CPU is at fault


def _rel64(got, ref64):
    return float((got.detach().cpu().double() - ref64).norm() / ref64.norm())


def _against_float64(outputs, plain, args, **kw):
    """Each output's relative L2 from `plain` on the CPU in float64, and the
    float32 plain version's on the CPU, for the same (card) inputs."""
    cpu = lambda t, dt=None: None if t is None else t.detach().to("cpu", dt)  # noqa: E731
    ref = plain(*(cpu(t, torch.float64) for t in args), **kw)
    f32 = plain(*(cpu(t) for t in args), **kw)
    return [(_rel64(o, r), _rel64(c, r)) for o, c, r in zip(outputs, f32, ref) if r is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,h,n,j,with_bias", F64_ATTENTION_CASES)
def test_float32_attention_backward_is_as_close_to_float64_as_the_cpu_on_card(
        cuda, kind, b, h, n, j, with_bias):
    """The 3xTF32 backward's dq, dk, dv at the default train step's shapes:
    relative L2 from the plain version in float64 within F64_FACTOR of the
    float32 plain version's on the CPU."""
    q, k, v = (_t(a).to(cuda) for a in _qkv(b, h, n, j, 64, kind == "mha"))
    g = _t(np.random.default_rng(6).normal(size=q.shape).astype(np.float32)).to(cuda)
    bias = _t(_mask_bias_np(b, j)).to(cuda) if with_bias else None
    out, lse = tflash.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    grads = tflash.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    torch.cuda.synchronize()
    rels = _against_float64(grads, tflash._PLAIN[kind][1], (q, k, v, g, bias))
    for name, (card, cpu) in zip(("dq", "dk", "dv"), rels):
        print(f"{kind} {(b, h, n, j)} {name}: card {card:.3e}, cpu float32 {cpu:.3e} "
              f"from float64 (ratio {card / cpu:.2f})")
        assert card <= F64_FACTOR * cpu, (name, card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F64_GROUP_NORM_CASES)
def test_float32_group_norm_backward_is_as_close_to_float64_as_the_cpu_on_card(cuda, shape):
    """dx, dgamma, dbeta, dscale and dshift at the default train step's
    shapes: relative L2 from the plain closed form in float64 (the same
    statistics) within F64_FACTOR of the float32 plain version's on the
    CPU."""
    x, gamma, beta, ss = _gn_inputs(*shape)
    scale, shift = (_t(a).to(cuda) for a in ss)
    x, gamma, beta = _t(x).to(cuda), _t(gamma).to(cuda), _t(beta).to(cuda)
    g = _t(np.random.default_rng(9).normal(size=shape).astype(np.float32)).to(cuda)
    kw = dict(groups=8, silu=True)
    _, mean, rstd = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    got = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    torch.cuda.synchronize()
    rels = _against_float64(got, tgn.group_norm_silu_bwd_plain,
                            (x, gamma, beta, scale, shift, mean, rstd, g), **kw)
    for name, (card, cpu) in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), rels):
        print(f"GroupNorm {shape} {name}: card {card:.3e}, cpu float32 {cpu:.3e} "
              f"from float64 (ratio {card / cpu:.2f})")
        assert card <= F64_FACTOR * cpu, (name, card, cpu)


# bf16 shapes whose rows per q-batch are no multiple of 4 (multi-query h * n,
# multi-head n): the dk/dv pass's lse and D boxes start 16-byte aligned only
# through the backward's rows-rounded-to-32 layout
BF16_RAGGED_ROW_SHAPES = [(3, 1, 5, 7), (2, 8, 6, 7), (3, 1, 6, 9), (2, 1, 7, 261)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("kind", ["mqa", "mha"])
@pytest.mark.parametrize("b,h,n,j", BF16_RAGGED_ROW_SHAPES)
def test_bf16_attention_at_ragged_row_counts_on_card(cuda, b, h, n, j, kind, with_bias):
    """The bf16 forward and backward against the plain versions at the bf16
    limit where a q-batch's row count is not a multiple of 4."""
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _qkv(b, h, n, j, 64, kind == "mha"))
    g = _t(np.random.default_rng(6).normal(size=q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    bias = _t(_mask_bias_np(b, j)).to(cuda) if with_bias else None
    _check_forward_backward(kind, torch.bfloat16, q, k, v, g, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_float32_attention_is_deterministic_on_card(cuda, kind):
    """The float32 forward and backward sum in a fixed order (dk/dv over the
    heads in registers, row-split slices in split order): two runs give the
    same bits."""
    q, k, v, g, bias = _attention_case(cuda, torch.float32, kind, 16, 1024,
                                       1025 if kind == "mqa" else 259, kind == "mha")
    first = tflash.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    second = tflash.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    out, lse = first
    grads = [tflash.attention_backward_kernel(kind, q, k, v, bias, out, g, lse) for _ in range(2)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_float32_attention_above_65535_sample_heads_on_card(cuda, kind):
    """batch * heads = 8193 * 8 = 65544 in float32: forward and backward
    kernels against the plain versions at n 16, j 17."""
    q, k, v, g, _ = _attention_case(cuda, torch.float32, kind, 8193, 16, 17, False)
    _check_forward_backward(kind, torch.float32, q, k, v, g, None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_mqa_bf16_kernels_launch_from_a_fresh_thread_on_card(cuda, kind):
    """A thread with no current CUDA context (as autograd's backward threads
    may be) launches the multi-query and multi-head kernels, whose tensor
    maps the CUDA driver encodes on the host."""
    import threading

    q, k, v, g, _ = _attention_case(cuda, torch.bfloat16, kind, 2, 64, 65, False)
    got, errors = [], []

    def run():
        try:
            out, lse = tflash.attention_forward_kernel(kind, q, k, v, None, with_lse=True)
            got.extend([out, *tflash.attention_backward_kernel(kind, q, k, v, None, out, g, lse)])
        except RuntimeError as e:
            errors.append(e)

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert not errors, errors
    plain, plain_bwd = tflash._PLAIN[kind]
    refs = (plain(q, k, v), *plain_bwd(q, k, v, g))
    torch.cuda.synchronize()
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, refs):
        assert float((a.float() - r.float()).abs().max()) <= _tol(torch.bfloat16, r.float()), name


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
    assert kernels.LAUNCHES["group_norm_forward"] == 1


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


# --------------------------------------------------------------------------- #
# GroupNorm: the cluster and streaming forms (need the card)                  #
# --------------------------------------------------------------------------- #
# (shape, groups, forms to force): the path's widths on both sides of the form
# rule (a slab of 2 MB per sample), 4 and 8 channels per group, Base's widest
# rows (3584 float32 channels split into two slices), 3 channels per group
# (vectors spanning groups unevenly), 8-byte and one-element vectors
GN_FORM_CASES = [((4, 32, 32, 64), 8, ("cluster", "stream")),
                 ((2, 64, 64, 32), 8, ("cluster", "stream")),
                 ((2, 128, 128, 64), 8, ("stream",)),
                 ((1, 96, 96, 128), 8, ("stream",)),
                 ((2, 8, 8, 1536), 8, ("cluster", "stream")),
                 ((2, 8, 8, 3584), 8, ("cluster", "stream")),
                 ((3, 5, 7, 24), 8, ("cluster", "stream")),
                 ((2, 9, 9, 20), 4, ("cluster", "stream")),
                 ((2, 9, 9, 15), 5, ("cluster", "stream"))]
GN_FORM_PARAMS = [(shape, groups, form) for shape, groups, forms in GN_FORM_CASES
                  for form in (None, *forms)]


def _gn_card_case(cuda, dtype, shape, seed=8):
    x, gamma, beta, ss = _gn_inputs(*shape, seed=seed)
    x, gamma, beta = (_t(a).to(cuda, dtype) for a in (x, gamma, beta))
    scale, shift = (_t(s).to(cuda, dtype) for s in ss)
    g = _t(np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)).to(cuda, dtype)
    return x, gamma, beta, scale, shift, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,form", GN_FORM_PARAMS)
def test_group_norm_forms_match_plain_and_repeat_on_card(cuda, dtype, shape, groups, form):
    """Each form of the forward and backward against the plain versions
    (limits as above); the statistics against the exact two-pass ones
    (cluster) or the tile model of group_stats_tiles_plain (streaming) at
    float32 tolerance; and a repeat of both kernels gives the same bits (the
    second backward reuses the ticket the first left at 0)."""
    x, gamma, beta, scale, shift, g = _gn_card_case(cuda, dtype, shape)
    kw = dict(groups=groups, silu=True, form=form)
    info = tgn.plan_info(False, x, groups, form)
    y, mean, rstd = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    y2, mean2, rstd2 = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    got = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    again = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    ref = tgn.group_norm_silu_plain(x, gamma, beta, groups=groups, scale_shift=(scale, shift),
                                    silu=True)
    want = tgn.group_norm_silu_bwd_plain(x, gamma, beta, scale, shift, mean, rstd, g,
                                         groups=groups, silu=True)
    if info["form"] == "stream":
        stats = tgn.group_stats_tiles_plain(x, groups, info["tile_pixels"], info["tiles_per_part"])
    else:
        stats = tgn.group_stats_plain(x, groups)
    torch.cuda.synchronize()
    if form is not None:
        assert info["form"] == form
    assert float((y.float() - ref.float()).abs().max()) <= _tol(dtype, ref.float())
    for name, a, r in zip(("mean", "rstd"), (mean, rstd), stats):
        assert torch.allclose(a, r.float(), rtol=2e-5, atol=2e-5 * float(r.abs().max())), name
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(rstd, rstd2)
    for name, a, r, b in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), got, want, again):
        err = float((a.float() - r.float()).abs().max())
        assert err <= _tol(dtype, r.float()), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_group_norm_cluster_form_refused_where_the_slab_does_not_fit_on_card(cuda):
    """A 4 MB bf16 sample (the lite SR's 256x256x32) does not fit 16 blocks'
    shared memory: asking for the cluster form raises, nothing falls back."""
    x = torch.zeros(2, 256, 256, 32, dtype=torch.bfloat16, device=cuda)
    assert tgn.plan_info(False, x, 8)["form"] == "stream"
    with pytest.raises(ValueError):
        tgn.plan_info(False, x, 8, "cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["cluster", "stream"])
def test_group_norm_reads_scale_shift_in_place_on_card(cuda, dtype, form):
    """Scale and shift as the two halves of one (b, 1, 1, 2c) tensor (rows
    2c apart, as the time MLP's output is split) give the same results as
    contiguous copies, against the plain versions."""
    b, h, w, c = 2, 16, 16, 64
    x, gamma, beta, _, _, g = _gn_card_case(cuda, dtype, (b, h, w, c))
    ss = _t(np.random.default_rng(4).normal(size=(b, 1, 1, 2 * c)).astype(np.float32) * 0.3)
    ss = ss.to(cuda, dtype)
    scale, shift = ss[..., :c], ss[..., c:]
    assert scale.stride(0) == 2 * c and not scale.is_contiguous()
    kw = dict(groups=8, silu=True, form=form)
    y, mean, rstd = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    got = tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    ref = tgn.group_norm_silu_plain(x, gamma, beta, groups=8, scale_shift=(scale, shift), silu=True)
    want = tgn.group_norm_silu_bwd_plain(x, gamma, beta, scale, shift, mean, rstd, g, groups=8,
                                         silu=True)
    copied = tgn.group_norm_forward_kernel(x, gamma, beta, scale.contiguous(),
                                           shift.contiguous(), eps=1e-5, **kw)[0]
    torch.cuda.synchronize()
    assert float((y.float() - ref.float()).abs().max()) <= _tol(dtype, ref.float())
    assert torch.equal(y, copied)
    for name, a, r in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), got, want):
        assert float((a.float() - r.float()).abs().max()) <= _tol(dtype, r.float()), name


@pytest.mark.cuda
@pytest.mark.parametrize("form,launches", [("cluster", 1), ("stream", 2)])
def test_group_norm_launches_per_call_on_card(cuda, form, launches):
    """The cluster form is one CUDA launch per forward and per backward, the
    streaming form two (kernels counted in a torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    x, gamma, beta, scale, shift, g = _gn_card_case(cuda, torch.bfloat16, (2, 32, 32, 64))
    kw = dict(groups=8, silu=True, form=form)
    _, mean, rstd = tgn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    tgn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    torch.cuda.synchronize()
    counts = {}
    for name, call in (("forward", lambda: tgn.group_norm_forward_kernel(
            x, gamma, beta, scale, shift, eps=1e-5, **kw)),
            ("backward", lambda: tgn.group_norm_backward_kernel(
                x, gamma, beta, scale, shift, mean, rstd, g, **kw))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        counts[name] = sum(e.count for e in prof.key_averages()
                           if e.device_type.name == "CUDA" and "gn_" in e.key)
    assert counts == {"forward": launches, "backward": launches}


@pytest.mark.parametrize("c,dtype,offset,want", [
    (32, torch.bfloat16, 0, 16), (20, torch.bfloat16, 0, 8), (18, torch.bfloat16, 0, 4),
    (15, torch.bfloat16, 0, 2), (64, torch.bfloat16, 1, 2), (64, torch.bfloat16, 4, 8),
    (32, torch.float32, 0, 16), (10, torch.float32, 0, 8), (15, torch.float32, 0, 4),
    (64, torch.float32, 2, 8)])
def test_group_norm_vector_width_follows_rows_and_addresses(c, dtype, offset, want):
    """The GroupNorm kernels take the widest vector (16, 8, 4 or 2 bytes)
    dividing a row of c channels and every tensor's address."""
    t = torch.zeros(4 * c + 16, dtype=dtype)[offset:offset + 2 * c]
    assert tgn.vector_bytes(c, t.element_size(), t) == want
