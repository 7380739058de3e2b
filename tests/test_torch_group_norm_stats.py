"""The streaming GroupNorm's statistics, modelled on the CPU.

``group_stats_tiles_plain`` is the plain model of what the card's streaming
form computes (csrc/group_norm.cu: per pixel tile and group a two-pass mean
and M2, merged with Chan's formula in tile order). The output built from its
mean and rstd is held against the JAX package's ``group_norm_silu`` on the
same numpy inputs, with the tiles merged in one run or in runs (the tiles of
one block of the kernel), in float32; the card test holds the kernel's statistics
against this model. An input of mean 1e3 and std 0.1 shows why the tiles are
merged rather than summed as E[x^2] - mean^2: in float32 that form loses
the variance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from minimagen_tpu.ops import group_norm as jgn
from minimagen_tpu_torch.ops import group_norm as tgn


def _inputs(b, h, w, c, loc=0.5, spread=3.0, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * spread + loc).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    ss = tuple((rng.normal(size=(b, 1, 1, c)) * 0.3).astype(np.float32) for _ in range(2))
    return x, gamma, beta, ss


def _from_stats(x, mean, rstd, gamma, beta, ss, groups):
    """y of the forward (float32, scale-shift, SiLU) from given statistics."""
    b, h, w, c = x.shape
    per_channel = lambda t: t.repeat_interleave(c // groups, dim=1)[:, None, None, :]  # noqa: E731
    out = (x - per_channel(mean)) * per_channel(rstd) * gamma + beta
    return F.silu(out * (ss[0] + 1.0) + ss[1])


def _jax(x, gamma, beta, ss, groups):
    return np.asarray(jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                          groups=groups, scale_shift=tuple(map(jnp.asarray, ss)),
                                          silu=True))


@pytest.mark.parametrize("shape,groups,tile_pixels,tiles_per_part", [
    ((2, 8, 8, 32), 8, 5, None),  # 4 channels per group; 13 tiles, the last of 4 pixels
    ((2, 8, 8, 32), 8, 5, 3),     # the same tiles merged in runs of 3 (the last of 1)
    ((2, 8, 8, 64), 8, 7, None),  # 8 channels per group; 10 tiles, the last of 1 pixel
    ((2, 8, 8, 64), 8, 7, 4),
    ((1, 6, 10, 24), 3, 64, None),  # one tile holding every pixel
    ((3, 4, 4, 16), 2, 1, 5),     # a tile per pixel
])
def test_tile_statistics_match_jax(shape, groups, tile_pixels, tiles_per_part):
    x, gamma, beta, ss = _inputs(*shape)
    mean, rstd = tgn.group_stats_tiles_plain(torch.from_numpy(x), groups, tile_pixels,
                                             tiles_per_part)
    ours = _from_stats(torch.from_numpy(x), mean, rstd, torch.from_numpy(gamma),
                       torch.from_numpy(beta), tuple(map(torch.from_numpy, ss)), groups)
    ref = _jax(x, gamma, beta, ss, groups)
    assert float(np.abs(ours.numpy() - ref).max()) <= 1e-5
    exact = tgn.group_stats_plain(torch.from_numpy(x), groups)
    for a, r in zip((mean, rstd), exact):
        assert torch.allclose(a, r, rtol=1e-5, atol=1e-6)


def test_tile_merge_holds_where_moments_fail():
    """Mean 1e3, std 0.1: the tile model stays with the JAX package's
    two-pass statistics, where var = E[x^2] - mean^2 in float32 is off by
    more than the variance itself. The limit against JAX is 1e-2: a float32
    sum of 256 values near 1e3 rounds at an ulp of 0.016 (2.6e5), which
    leaves a two-pass mean up to ~4e-4 off and the normalised value ~4e-3
    (rstd ~10) in either package; the tile model must also be at least as
    close as the JAX package to the float64 result."""
    shape, groups = (2, 8, 8, 32), 8
    x, gamma, beta, ss = _inputs(*shape, loc=1e3, spread=0.1, seed=3)
    xt = torch.from_numpy(x)
    params = (torch.from_numpy(gamma), torch.from_numpy(beta), tuple(map(torch.from_numpy, ss)))
    mean, rstd = tgn.group_stats_tiles_plain(xt, groups, 5, 4)
    ours = _from_stats(xt, mean, rstd, *params, groups).numpy()
    ref = _jax(x, gamma, beta, ss, groups)
    x64 = xt.double()
    exact = _from_stats(x64, *tgn.group_stats_plain(x64, groups),
                        *(p.double() if torch.is_tensor(p) else tuple(t.double() for t in p)
                          for p in params), groups).numpy()
    assert float(np.abs(ours - ref).max()) <= 1e-2
    assert np.abs(ours - exact).max() <= np.abs(ref - exact).max()
    xg = xt.reshape(2, 64, groups, 4)
    m = xg.mean(dim=(1, 3))
    var_moments = (xg * xg).mean(dim=(1, 3)) - m * m
    var_exact = x64.reshape(2, 64, groups, 4).var(dim=(1, 3), unbiased=False)
    assert float(((var_moments.double() - var_exact).abs() / var_exact).max()) > 1.0
    var_tiles = 1.0 / rstd.double() ** 2 - 1e-5
    assert float(((var_tiles - var_exact).abs() / var_exact).max()) < 1e-3
    naive = _from_stats(xt, m, torch.rsqrt(var_moments.clamp_min(0) + 1e-5), *params, groups)
    assert float(np.abs(naive.numpy() - ref).max()) > 0.1
