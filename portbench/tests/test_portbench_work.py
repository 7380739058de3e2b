"""The FLOP and byte reckoning against hand counts at small shapes."""
import torch

from portbench import work
from portbench.reference import unet as ref


def test_self_attention_flops_by_hand():
    # dim 64, 2 rows of 16 tokens, 8 heads of 64, one shared K/V head
    b, n, d, h, dh = 2, 16, 64, 8, 64
    j = n + 1  # the null key
    hand = (2 * b * n * d * h * dh          # to_q
            + 2 * b * n * d * 2 * dh        # to_kv
            + 2 * 2 * b * h * n * j * dh    # q k^T and p v
            + 2 * b * n * h * dh * d)       # to_out
    assert work.attention_flops("self", d, b, n) == hand


def test_cross_attention_flops_by_hand():
    b, n, d, h, dh, jc, dc = 2, 16, 64, 8, 64, 10, 32
    j = jc + 1
    hand = (2 * b * n * d * h * dh + 2 * b * jc * dc * 2 * h * dh
            + 2 * 2 * b * h * n * j * dh + 2 * b * n * h * dh * d)
    assert work.attention_flops("cross", d, b, n, (jc, dc)) == hand


def test_attention_bound_by_hand():
    b, n, d = 2, 16, 64
    pbytes = 1000
    bound, by = work.attention_bound([("self", (b, n, d), None, 2, pbytes, 8, False)] * 3)
    flops = work.attention_flops("self", d, b, n)
    nbytes = 2 * b * n * d * 2 + pbytes
    assert by == ("flops" if flops / 989e12 > nbytes / 3.35e12 else "bytes")
    assert abs(bound - 3 * max(flops / 989e12, nbytes / 3.35e12)) < 1e-18


def test_group_norm_bound_by_hand():
    x = (2, 8, 8, 32)
    bound, by = work.group_norm_bound([(x, 2, 256, True)])
    nbytes = 2 * 2 * 8 * 8 * 32 * 2 + 256 + 2 * 2 * 32 * 2
    assert by == "bytes" and abs(bound - nbytes / 3.35e12) < 1e-18


def test_conv_flops_by_hand():
    with torch.device("meta"):
        conv = ref.Conv(32, 48, 3, padding=1)
    x = torch.empty(2, 8, 8, 32, device="meta")
    assert work.counted_flops(conv, x) == 2 * 2 * 8 * 8 * 32 * 48 * 9


def test_unet_flops_count_every_conv_once():
    # a one-level U-Net: the sum of its parts' counts
    cfg = dict(dim=16, dim_mults=[1], num_resnet_blocks=1, layer_attns=[False],
               layer_cross_attns=[False], attn_heads=2, memory_efficient=False,
               attend_at_middle=False, lowres_cond=False, text_embed_dim=8)
    total = work.unet_forward_flops(cfg, 2, 8, 4)
    assert total > 0
    assert work.unet_forward_flops(cfg, 4, 8, 4) == 2 * total  # linear in rows
