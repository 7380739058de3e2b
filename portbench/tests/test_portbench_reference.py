"""The plain reference against the port's plain CPU path on a tiny
cascade, float32: one U-Net forward each, then whole tiny runs of a
sampling and a training cell, whose compared gaps fall to round-off."""
import pytest
import torch

from portbench import program, run, weights
from portbench.reference import cascade as rc
from portbench.tests import tiny


@pytest.mark.parametrize("stage", [0, 1])
def test_unet_forward_equals_port(stage):
    cfg = tiny.tiny_config()
    cfg["dtype"] = "float32"
    cfgs = run.make_context("default.ddim50.c8", 5, config=cfg, device="cpu").unet_cfgs
    w = weights.SeededWeights(cfgs, 5, "cpu")
    imagen = program.build(cfg, w, "float32", "cpu")
    ref = rc.build_unets(cfgs, [w.state_dict(u) for u in range(2)], "cpu")[stage]
    g = torch.Generator().manual_seed(0)
    size = cfg["image_sizes"][stage]
    x = torch.randn(3, size, size, 3, generator=g)
    t = torch.tensor([5, 50, 99])
    text = torch.randn(3, 6, cfg["text_embed_dim"], generator=g)
    mask = torch.arange(6)[None, :] < torch.tensor([[2], [6], [4]])
    keep = torch.tensor([True, False, True])
    kw = dict(text_embeds=text, text_mask=mask, text_keep_mask=keep)
    if stage:
        kw.update(lowres_cond_img=torch.rand(3, size, size, 3, generator=g) * 2 - 1,
                  lowres_noise_times=torch.tensor([20, 20, 20]))
    with torch.no_grad():
        got = imagen.unets[stage](x, t, **kw)
        want = ref(x, t, **kw)
    assert (got - want).norm() / want.norm() < 1e-5


@pytest.mark.parametrize("cell", ["default.ddim50.c8", "default.train.b16"])
def test_float32_port_matches_reference(cell):
    cfg = tiny.tiny_config()
    cfg["dtype"] = cfg["param_dtype"] = "float32"
    result = tiny.run_tiny(cell, seed=77, config=cfg)
    assert result["correct"]
    for name, v in result["compared"].items():
        assert v["value"] < 1e-3, (name, v)
