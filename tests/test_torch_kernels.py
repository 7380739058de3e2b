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
    assert cu == ["flash_attention.cu", "group_norm.cu"]
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
