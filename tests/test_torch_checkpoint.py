"""The port's checkpoint reader against flax: its pure-Python msgpack decoder
must give the same tree, shapes and values as
``flax.serialization.msgpack_restore`` on the committed files, and the
committed lite weights must load into the full-width port U-Nets with every
key matched."""
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from minimagen_tpu_torch import checkpoint
from minimagen_tpu_torch.generate import LITE_CKPT_DIR, lite_imagen, load_lite
from minimagen_tpu_torch.models.t5 import REPO_ROOT

FILES = [
    os.path.join(REPO_ROOT, "assets", "t5_tiny", "flax_model.msgpack"),
    os.path.join(LITE_CKPT_DIR, "unet_0_ema_bf16.ckpt"),
    os.path.join(LITE_CKPT_DIR, "unet_1_ema_bf16.ckpt"),
]


def _flat(tree):
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("path", FILES, ids=["t5_tiny", "unet_0", "unet_1"])
def test_msgpack_decoder_matches_flax(path):
    with open(path, "rb") as f:
        data = f.read()
    ours, ref = _flat(checkpoint.msgpack_restore(data)), _flat(serialization.msgpack_restore(data))
    assert ours.keys() == ref.keys()
    for name, leaf in ref.items():
        assert ours[name].shape == leaf.shape, name
        # bf16 leaves decode to float32 holding the same values
        np.testing.assert_array_equal(ours[name], np.asarray(leaf, np.float32), err_msg=name)


def test_decoder_handles_scalars_and_containers():
    blob = bytes([0x83, 0xA1, 0x61, 0xCD, 0x01, 0x00,       # {"a": 256,
                  0xA1, 0x62, 0x92, 0xC3, 0xD0, 0x9C,       #  "b": [True, -100],
                  0xA1, 0x63, 0xCB]) + np.float64(1.5).byteswap().tobytes()  # "c": 1.5}
    assert checkpoint.msgpack_restore(blob) == {"a": 256, "b": [True, -100], "c": 1.5}
    with pytest.raises(ValueError):
        checkpoint.msgpack_restore(blob[:-1])


def test_unet_state_dict_layouts():
    tree = {"conv": {"kernel": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5),
                     "bias": np.zeros(5, np.float32)},
            "dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "norm": {"gamma": np.ones(3, np.float32)}}
    sd = checkpoint.unet_state_dict(tree)
    assert set(sd) == {"conv.weight", "conv.bias", "dense.weight", "norm.gamma"}
    assert sd["conv.weight"].shape == (5, 4, 2, 3)
    assert sd["conv.weight"][4, 3, 1, 2] == tree["conv"]["kernel"][1, 2, 3, 4]
    assert torch.equal(sd["dense.weight"], torch.from_numpy(tree["dense"]["kernel"].T.copy()))


def test_committed_weights_load_into_full_width_unets():
    imagen = load_lite(device="cpu", dtype=torch.float32)
    for i, unet in enumerate(imagen.unets):
        tree = checkpoint.read_msgpack(os.path.join(LITE_CKPT_DIR, f"unet_{i}_ema_bf16.ckpt"))
        expected = checkpoint.unet_state_dict(tree)
        state = unet.state_dict()
        assert state.keys() == expected.keys()
        for name, value in expected.items():
            assert torch.equal(state[name], value), name
    assert imagen.text_max_length == 16 and imagen.text_encoder.name == "t5_tiny"
    assert sum(p.numel() for p in imagen.unets.parameters()) == pytest.approx(47.906278e6, rel=1e-6)
    fresh = lite_imagen(device="cpu", dtype=torch.float32)
    assert [u.config for u in fresh.unets] == [u.config for u in imagen.unets]
