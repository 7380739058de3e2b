"""The port's text path against the JAX package's on the CPU: the copied
registry and word tokenizer (byte for byte, including the EOS dropped when a
caption is truncated), and the port's own PyTorch T5 encoder against
HuggingFace's FlaxT5EncoderModel on the committed assets/t5_tiny (max-abs
1e-4)."""
import numpy as np
import pytest
import torch

from minimagen_tpu.models import t5 as J
from minimagen_tpu_torch.models import t5 as T

CAPTIONS = [
    "a green square",
    "A Red circle",
    "a purple circle on a very large gray background with some extra words to truncate",
    "",
    "ünïcode words, punctuation!",
]


def test_registry_matches_jax():
    assert T.T5_VERSIONS == J.T5_VERSIONS
    assert T.MAX_LENGTH == J.MAX_LENGTH
    for name in J.T5_VERSIONS:
        assert T.get_encoded_dim(name) == J.get_encoded_dim(name)


@pytest.mark.parametrize("max_length", [16, 4, 256])
def test_word_tokenizer_matches_jax(max_length):
    ref = J.WordTokenizer(512).batch_encode_plus(CAPTIONS, padding="longest",
                                                 max_length=max_length, truncation=True,
                                                 return_tensors="np")
    ids, mask = T.WordTokenizer(512).encode(CAPTIONS, max_length)
    np.testing.assert_array_equal(ids, ref.input_ids)
    np.testing.assert_array_equal(mask, ref.attention_mask)
    if max_length == 4:  # a truncated caption loses its EOS, as in the JAX package
        assert ids[2, -1] != 1


def test_relative_position_buckets():
    rel = torch.arange(-200, 201)
    b = T.relative_position_bucket(rel, 32, 128)
    assert b[200] == 0 and b[201] == 17 and b[199] == 1  # 0, +1, -1
    assert b.min() >= 0 and b.max() <= 31
    assert b[0] == 15 and b[-1] == 31  # beyond max distance: last bucket per side


@pytest.fixture(scope="module")
def encoder():
    return T.TextEncoder("t5_tiny", device="cpu")


@pytest.mark.parametrize("max_length", [16, 256])
def test_t5_encoder_matches_flax(encoder, max_length):
    ref, ref_mask = J.t5_encode_text(CAPTIONS, "t5_tiny", max_length)
    enc, mask = encoder.encode(CAPTIONS, max_length)
    assert enc.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    assert enc.shape == ref.shape
    assert float(np.abs(enc.numpy() - ref).max()) <= 1e-4
    assert not enc.numpy()[~mask.numpy()].any()  # padded rows zeroed


def test_only_local_encoders_load():
    """Only ``local:`` encoders load T5 weights; a name whose weights need a
    download takes the JAX package's offline hash encoder, with a warning."""
    T._FALLBACK_WARNED.discard("t5_base")
    with pytest.warns(UserWarning, match="hash text encoder"):
        enc = T.TextEncoder("t5_base", device="cpu")
    assert enc.model is None
    out, mask = enc.encode(["a red square"], 8)
    assert out.shape == (1, 3, 768) and mask.all()
