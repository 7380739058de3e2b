"""The U-Net's CrossEmbed stem (counterpart of
``minimagen_tpu/ops/stem_conv.py``).

The stem runs parallel convolutions with kernel sizes 3/7/15 over the
3- or 6-channel input image and concatenates them on channels
(:func:`cross_embed_reference`). Its contraction is k*k*cin with cin 3 or 6,
which no matrix unit fills, so the JAX package rewrites a stride-1 stem in
two exact steps, ported here with the same channel orders:

1. :func:`merge_cross_embed_kernels` zero-embeds the three kernels into one
   15x15 kernel (a k conv with pad (k-1)/2 is a centred 15x15 conv).
2. :func:`_space_to_depth_weight` turns that conv over (H, W, cin) into a
   VALID conv over the space-to-depth-``f`` input (H/f+.., W/f+.., f*f*cin),
   whose f*f*cout output channels, ordered (py, px, c), are the f*f output
   phases; a depth-to-space puts them back in place.

:func:`_stem_forward` is the JAX package's default forward: the dense
space-to-depth-4 conv (:func:`cross_embed_s2d_conv`, ``F.conv2d``, which
XLA computes outside Pallas there) when H and W divide by 4, then
:func:`depth_to_space_bias`, the shuffle plus the stem bias. That is
kernel 8, ``_depth_to_space_bias_pallas`` (:146), here
``csrc/depth_to_space.cu``: a CUDA tensor launches it or raises, a CPU
tensor takes :func:`depth_to_space_bias_plain`. :class:`StemConv` is the
counterpart of ``_stem_vjp_fns``: its backward computes the weight gradients
as one patches-matmul in the space-to-depth-2 domain
(:func:`_s2d_patches`) and maps them back to the three kernels through the
transpose of the (linear) kernel-to-s2d-weight map, a gather and a
fixed-order sum (:func:`_space_to_depth_weight_grad`); dx goes through the
reference convolutions and only when the input needs it (in the U-Net the
stem's input is data). :func:`cross_embed_fused` (im2col plus one matmul)
is kept for reference, as in the JAX package.

One deliberate difference: the JAX package takes the rewrite only on its
accelerator (``use_fused_stem``: ``pallas_enabled()``, or its
``MINIMAGEN_TPU_STEM_FUSED`` switch) and the reference convolutions on the
CPU. The port takes it on every device, so the CPU tests run the same code
as the card, with the plain depth-to-space. Both formulations are exact;
they differ only in the order of the float sums. The JAX package's
``MINIMAGEN_TPU_STEM_*`` switches are not ported.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import kernels
from .flash_attention import needs_grad


# --------------------------------------------------------------------------- #
# the weight algebra                                                           #
# --------------------------------------------------------------------------- #
def merge_cross_embed_kernels(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Zero-embed per-scale OIHW kernels (cout_i, cin, k_i, k_i), odd k_i,
    into one (sum cout_i, cin, K, K) kernel, K the largest k_i: a k conv
    with pad (k-1)//2 is a K conv with pad (K-1)//2 whose kernel is centred
    at offset (K-k)//2."""
    K = max(w.shape[-1] for w in weights)
    parts = []
    for w in weights:
        off = (K - w.shape[-1]) // 2
        parts.append(F.pad(w, (off, K - w.shape[-1] - off, off, K - w.shape[-1] - off)))
    return torch.cat(parts, dim=0)


def _s2d_kernel_size(K: int, f: int) -> int:
    """Spatial size of the factor-``f`` space-to-depth kernel of an odd-K
    stride-1 conv: dy = f*a + q - p with q, p in [0, f) must cover [0, K)."""
    return (K + f - 2) // f + 1


@functools.lru_cache(maxsize=None)
def _s2d_taps(K: int, f: int, device: torch.device) -> torch.Tensor:
    """(f, f, Kf) row (or column) of tap (p, q, a) of the space-to-depth-f
    kernel in the K kernel padded by f-1 zeros before and f*Kf-K after:
    f*a + q - p + f - 1."""
    p = torch.arange(f)[:, None, None]
    q = torch.arange(f)[None, :, None]
    a = torch.arange(_s2d_kernel_size(K, f))[None, None, :]
    return (f * a + q - p + f - 1).to(device)


def _space_to_depth_weight(w: torch.Tensor, f: int = 2) -> torch.Tensor:
    """An OIHW kernel (cout, cin, K, K), odd K, as the equivalent
    space-to-depth-``f`` kernel (f*f*cout, f*f*cin, Kf, Kf), Kf =
    (K+f-2)//f + 1: output channels ordered (py, px, co), input channels
    (qy, qx, ci), as the JAX package's HWIO weight has them. Its phase (py,
    px) tap (a, b) on input channel (qy, qx, ci) is W(f*a+qy-py, f*b+qx-px)
    (zero where that leaves [0, K); derivation in the JAX package): one
    gather from the zero-padded kernel."""
    cout, cin, K, _ = w.shape
    Kf = _s2d_kernel_size(K, f)
    lo, hi = f - 1, f * Kf - K
    taps = _s2d_taps(K, f, w.device)
    g = F.pad(w, (lo, hi, lo, hi))[:, :, taps[:, :, :, None, None, None],
                                   taps[None, None, None, :, :, :]]
    # (cout, cin, py, qy, a, px, qx, b) -> (py, px, cout, qy, qx, cin, a, b)
    return g.permute(2, 5, 0, 3, 6, 1, 4, 7).reshape(f * f * cout, f * f * cin, Kf, Kf)


@functools.lru_cache(maxsize=None)
def _s2d_sources(K: int, f: int, device: torch.device):
    """The phases p (f,) and, for kernel row dy of phase p, the tap a and
    sub-row q with f*a + q - p = dy, each (f, K)."""
    s = torch.arange(K)[None, :] + torch.arange(f)[:, None]
    return torch.arange(f).to(device), (s // f).to(device), (s % f).to(device)


def _space_to_depth_weight_grad(dw2: torch.Tensor, f: int, K: int) -> torch.Tensor:
    """The transpose of :func:`_space_to_depth_weight`: (f*f*cout, f*f*cin,
    Kf, Kf) -> (cout, cin, K, K), each tap of the K kernel the sum, over the
    f*f phases in order, of the one s2d tap it feeds in each. A gather and a
    fixed-order sum, so a repeat gives the same bits."""
    cout, cin, Kf = dw2.shape[0] // (f * f), dw2.shape[1] // (f * f), dw2.shape[-1]
    v = dw2.reshape(f, f, cout, f, f, cin, Kf, Kf)
    p, a, q = _s2d_sources(K, f, dw2.device)
    g = v[p[:, None, None, None], p[None, :, None, None], :, q[:, None, :, None],
          q[None, :, None, :], :, a[:, None, :, None], a[None, :, None, :]]
    return g.sum(dim=(0, 1)).permute(2, 3, 0, 1)  # (f, f, K, K, cout, cin) -> OIHW


def _space_to_depth(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(b, H, W, c) -> (b, H/f, W/f, f*f*c) with channel order (qy, qx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)


def _depth_to_space(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(b, H', W', f*f*c) with channel order (py, px, c) -> (b, fH', fW', c)."""
    b, h, w, cf = x.shape
    c = cf // (f * f)
    x = x.reshape(b, h, w, f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, f * h, f * w, c)


def _s2d_patches(x: torch.Tensor, K: int) -> torch.Tensor:
    """Pad + space-to-depth-2 + im2col for a K x K (odd) stride-1 conv:
    (b, H/2, W/2, K2*K2*4cin), K2 = K//2 + 1, channels ordered (a, b, (qy,
    qx, ci)) as the flattened HWIO form of :func:`_space_to_depth_weight`."""
    K2, pad = K // 2 + 1, (K - 1) // 2
    x2 = _space_to_depth(F.pad(x, (0, 0, pad, pad, pad, pad)))
    h2, w2 = x2.shape[1] - K2 + 1, x2.shape[2] - K2 + 1
    return torch.cat([x2[:, a:a + h2, b:b + w2, :] for a in range(K2) for b in range(K2)],
                     dim=-1)


def _stem_bias(weights, biases, like: torch.Tensor) -> torch.Tensor:
    """The per-scale biases (zeros where None) as one (sum cout_i,) vector
    of `like`'s dtype."""
    return torch.cat([torch.zeros(w.shape[0], dtype=like.dtype, device=like.device)
                      if b is None else b.to(like.dtype) for w, b in zip(weights, biases)])


# --------------------------------------------------------------------------- #
# kernel 8: depth-to-space + bias                                              #
# --------------------------------------------------------------------------- #
def depth_to_space_bias_plain(y2: torch.Tensor, bias: torch.Tensor, f: int) -> torch.Tensor:
    """(b, H', W', f*f*c), channels (py, px, c), -> (b, fH', fW', c) plus
    `bias` (c,) in y2's dtype."""
    return _depth_to_space(y2, f) + bias.to(y2.dtype)


def depth_to_space_bias_kernel(y2: torch.Tensor, bias: torch.Tensor, f: int) -> torch.Tensor:
    """Launch ``csrc/depth_to_space.cu`` on a contiguous CUDA `y2`; `bias`
    is cast to y2's dtype. No gradient flows through it (:class:`StemConv`
    supplies the stem's backward)."""
    b, h, w, cf = y2.shape
    if f < 1 or cf % (f * f):
        raise ValueError(f"depth_to_space_bias: {cf} channels are not f*f={f * f} phases")
    c = cf // (f * f)
    bias = bias.to(y2.dtype).contiguous()
    if tuple(bias.shape) != (c,):
        raise ValueError(f"depth_to_space_bias: bias {tuple(bias.shape)} is not ({c},)")
    kernels.require_cuda("depth_to_space_bias", y2, bias)
    out = torch.empty(b, f * h, f * w, c, dtype=y2.dtype, device=y2.device)
    kernels.launch("depth_to_space_bias", y2.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                   f, c, kernels.DTYPE_CODES[y2.dtype], kernels.current_stream(y2))
    return out


def depth_to_space_bias(y2: torch.Tensor, bias: torch.Tensor, f: int) -> torch.Tensor:
    """Kernel 8 on a CUDA tensor, its plain version on a CPU tensor."""
    if y2.device.type == "cpu":
        return depth_to_space_bias_plain(y2, bias, f)
    return depth_to_space_bias_kernel(y2, bias, f)


# --------------------------------------------------------------------------- #
# the forward formulations                                                     #
# --------------------------------------------------------------------------- #
def cross_embed_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[Optional[torch.Tensor]],
                          stride: int) -> torch.Tensor:
    """Parallel convs concatenated on channels; x (b, h, w, c) NHWC,
    weights OIHW. Returns NHWC."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    fmaps = []
    for w, b in zip(weights, biases):
        pad = (w.shape[-1] - stride) // 2
        fmaps.append(F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                              stride=stride, padding=pad))
    return torch.cat(fmaps, dim=1).permute(0, 2, 3, 1)


def cross_embed_s2d_conv(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[Optional[torch.Tensor]], f: int) -> torch.Tensor:
    """The stride-1 stem as ONE dense VALID conv over the space-to-depth-``f``
    input, then :func:`depth_to_space_bias`; computes in x's dtype. H and W
    must divide by f."""
    w = merge_cross_embed_kernels([k.to(x.dtype) for k in weights])
    P = (w.shape[-1] - 1) // 2
    b, h, ww, _ = x.shape
    eh, ew = (-(h + 2 * P)) % f, (-(ww + 2 * P)) % f
    x2 = _space_to_depth(F.pad(x, (0, 0, P, P + ew, P, P + eh)), f)
    y2 = F.conv2d(x2.permute(0, 3, 1, 2), _space_to_depth_weight(w, f)).permute(0, 2, 3, 1)
    # the trailing eh/ew zero-pad rows only feed windows past the real image
    y2 = y2[:, : h // f, : ww // f, :].contiguous()
    return depth_to_space_bias(y2, _stem_bias(weights, biases, x), f)


def cross_embed_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """The stride-1 stem as space-to-depth-2 im2col + one matmul (H and W
    even), then :func:`depth_to_space_bias`; computes in x's dtype."""
    w = merge_cross_embed_kernels([k.to(x.dtype) for k in weights])
    w2 = _space_to_depth_weight(w)  # (4cout, 4cin, K2, K2)
    patches = _s2d_patches(x, w.shape[-1])
    b, h2, w2c, _ = patches.shape
    out2 = patches.reshape(b * h2 * w2c, -1) @ w2.permute(2, 3, 1, 0).reshape(-1, w2.shape[0])
    return depth_to_space_bias(out2.reshape(b, h2, w2c, -1), _stem_bias(weights, biases, x), 2)


def _stem_forward(x, weights, biases) -> torch.Tensor:
    """The JAX package's default stem forward: space-to-depth-4 when H and W
    divide by 4, else the reference convolutions."""
    if x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0:
        return cross_embed_s2d_conv(x, weights, biases, 4)
    return cross_embed_reference(x, weights, biases, 1)


# --------------------------------------------------------------------------- #
# the stem's autograd function and dispatch                                    #
# --------------------------------------------------------------------------- #
class StemConv(torch.autograd.Function):
    """The stride-1 stem (H and W even) with the patches-matmul weight
    gradient. ``apply(x, n, *weights, *biases)``: n OIHW kernels of any float
    dtype (cast to x's at use) and their biases (or None)."""

    @staticmethod
    def forward(ctx, x, n, *params):
        weights, biases = params[:n], params[n:]
        ctx.save_for_backward(x, *weights)
        ctx.bias_dtypes = [None if b is None else b.dtype for b in biases]
        return _stem_forward(x, weights, biases)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        n = len(weights)
        g = g.to(x.dtype).contiguous()
        dws: List[Optional[torch.Tensor]] = [None] * n
        if any(ctx.needs_input_grad[2:2 + n]):
            # weight gradient of the s2d-2 kernel as one matmul, float32 sums
            K = max(w.shape[-1] for w in weights)
            K2 = K // 2 + 1
            patches = _s2d_patches(x, K)
            g2 = _space_to_depth(g)
            dw2 = patches.reshape(-1, patches.shape[-1]).t() @ g2.reshape(-1, g2.shape[-1])
            dw2 = dw2.reshape(K2, K2, -1, g2.shape[-1]).permute(3, 2, 0, 1)
            # through the transposes of the s2d-2 map and of the merge
            dw = _space_to_depth_weight_grad(dw2, 2, K)
            off = 0
            for i, w in enumerate(weights):
                k, c, o = w.shape[-1], w.shape[0], (K - w.shape[-1]) // 2
                dws[i] = dw[off:off + c, :, o:o + k, o:o + k].to(w.dtype)
                off += c
        dbs, off = [], 0
        db_full = g.float().sum(dim=(0, 1, 2))
        for w, dt in zip(weights, ctx.bias_dtypes):
            dbs.append(None if dt is None else db_full[off:off + w.shape[0]].to(dt))
            off += w.shape[0]
        dx = None
        if ctx.needs_input_grad[0]:
            # the reference convolutions' input gradient, summed over scales
            gc = g.permute(0, 3, 1, 2)
            shape = x.permute(0, 3, 1, 2).shape
            dx, off = 0, 0
            for w in weights:
                k, cout = w.shape[-1], w.shape[0]
                dx = dx + torch.nn.grad.conv2d_input(shape, w.to(x.dtype), gc[:, off:off + cout],
                                                     padding=(k - 1) // 2)
                off += cout
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        return (dx, None, *dws, *dbs)


def cross_embed_conv(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[Optional[torch.Tensor]], *, stride: int) -> torch.Tensor:
    """The stem's dispatch: stride 1 with even H and W takes
    :func:`_stem_forward` (through :class:`StemConv` when a gradient is
    wanted), anything else the reference convolutions."""
    if stride == 1 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        if needs_grad(x, *weights, *biases):
            return StemConv.apply(x, len(weights), *weights, *biases)
        return _stem_forward(x, weights, biases)
    return cross_embed_reference(x, weights, biases, stride)
