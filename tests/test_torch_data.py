"""The port's data layer against the JAX package's on the CPU: loader
batches at the same seed (shuffled, drop-last, with a worker pool), the
collator's handling of failed items, ``random_split`` and
``ConceptualCaptions``' offline split, the npz cache both ways,
``rescale_image``, and the native resize against the JAX package's binding
of the same library. Images, masks, index orders and native outputs are
equal bit for bit; encodings of the hash encoder too."""
import argparse

import numpy as np
import pytest
import torch

from minimagen_tpu.data import cache as jcache
from minimagen_tpu.data import collate as jcollate
from minimagen_tpu.data import dataset as jdata
from minimagen_tpu.data import native as jnative
from minimagen_tpu_torch.data import cache as tcache
from minimagen_tpu_torch.data import collate as tcollate
from minimagen_tpu_torch.data import dataset as tdata
from minimagen_tpu_torch.data import native as tnative


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(n=10, **kw):
    common = dict(num_items=n, side_length=16, encoder_name="t5_small", max_length=8, **kw)
    return tdata.SyntheticCaptionedImages(device="cpu", **common), \
        jdata.SyntheticCaptionedImages(**common)


def _same_batches(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if b is None:
            assert a is None
            continue
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("workers,drop_last", [(0, True), (3, True), (0, False)])
def test_loader_batches_match_jax(workers, drop_last):
    """Two epochs (the shuffle is seeded by seed + epoch) of 10 items in
    batches of 4."""
    ours_ds, ref_ds = _pair(seed_offset=3)
    kw = dict(batch_size=4, shuffle=True, num_workers=workers, drop_last=drop_last, seed=7)
    ours = tcollate.DataLoader(ours_ds, collate_fn=tcollate.MinimagenCollator(max_length=8), **kw)
    ref = jcollate.DataLoader(ref_ds, collate_fn=jcollate.MinimagenCollator(max_length=8), **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):
        _same_batches(list(ours), list(ref))


def test_collator_drops_failed_items():
    ours_ds, ref_ds = _pair(n=12, failure_rate=0.5)
    ours, ref = [ours_ds[i] for i in range(12)], [ref_ds[i] for i in range(12)]
    assert [x is None for x in ours] == [x is None for x in ref] and any(x is None for x in ours)
    _same_batches([tcollate.MinimagenCollator(max_length=8)(ours[i:i + 3]) for i in range(0, 12, 3)],
                  [jcollate.MinimagenCollator(max_length=8)(ref[i:i + 3]) for i in range(0, 12, 3)])
    assert tcollate.MinimagenCollator(max_length=8)([None, None]) is None
    assert tcollate.get_minimagen_dl_opts().keys() == jcollate.get_minimagen_dl_opts().keys()


def _offline_datasets(monkeypatch):
    """A ``datasets`` module whose ``load_dataset`` raises, as without a
    network: ``ConceptualCaptions`` takes its offline branch at once
    (the installed package would first try to reach the hub)."""
    import sys
    import types

    mod = types.ModuleType("datasets")

    def load_dataset(name):
        raise ConnectionError("offline")

    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)


def test_random_split_and_offline_conceptual_captions_match_jax(monkeypatch):
    """``random_split`` orders equal the JAX package's; ``ConceptualCaptions``
    builds the JAX package's offline branch: its synthetic set split and cut
    the same way (the JAX factory itself is not called here: it tries the
    network first)."""
    _offline_datasets(monkeypatch)
    ours_ds, ref_ds = _pair(n=20)
    for size in (0, 7, 20):
        a, b = tdata.random_split(ours_ds, size, seed=3), jdata.random_split(ref_ds, size, seed=3)
        assert [list(x.indices) for x in a] == [list(x.indices) for x in b]
    args = argparse.Namespace(IMG_SIDE_LEN=16, T5_NAME="t5_small", MAX_NUM_WORDS=8,
                              TRAIN_VALID_FRAC=0.25, VALID_NUM=2)
    with pytest.warns(UserWarning):
        ours_train, ours_valid = tdata.ConceptualCaptions(args, smalldata=True, device="cpu")
    full = jdata.SyntheticCaptionedImages(num_items=16, side_length=16, encoder_name="t5_small",
                                          max_length=8)
    ref_train, ref_valid = jdata.random_split(full, 4)
    ref_valid.indices = ref_valid.indices[:3]
    assert list(ours_train.indices) == list(ref_train.indices)
    assert list(ours_valid.indices) == list(ref_valid.indices) and len(ours_valid) == 3
    _same_batches([ours_valid[i] for i in range(3)], [ref_valid[i] for i in range(3)])
    with pytest.warns(UserWarning):
        test_ours = tdata.ConceptualCaptions(args, smalldata=True, testset=True, device="cpu")
    test_ref = jdata.SyntheticCaptionedImages(num_items=16, side_length=16, seed_offset=10_000,
                                              encoder_name="t5_small", max_length=8)
    assert len(test_ours) == 16 and test_ours.seed_offset == 10_000
    _same_batches([test_ours[5]], [test_ref[5]])


def test_cache_round_trips_between_packages(tmp_path):
    """A cache built by either package reads back in the other, failed
    items left out."""
    ours_ds, ref_ds = _pair(n=9, failure_rate=0.3)
    m_ours = tcache.build_cache(ours_ds, str(tmp_path / "ours"), shard_size=4, num_threads=2)
    m_ref = jcache.build_cache(ref_ds, str(tmp_path / "ref"), shard_size=4, num_threads=2)
    assert m_ours == m_ref and m_ours["num_items"] < 9
    for src in ("ours", "ref"):
        a = tcache.CachedCaptionedImages(str(tmp_path / src))
        b = jcache.CachedCaptionedImages(str(tmp_path / ("ref" if src == "ours" else "ours")))
        _same_batches([a[i] for i in range(len(a))], [b[i] for i in range(len(b))])


def test_rescale_image_matches_jax():
    rng = np.random.default_rng(2)
    for shape in ((40, 30, 3), (16, 16, 3), (20, 24)):
        arr = rng.uniform(size=shape).astype(np.float32)
        ours, ref = tdata.rescale_image(arr, 16), jdata.rescale_image(arr, 16)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert tdata.rescale_image(np.full((8, 8, 3), 0.5, np.float32), 16) is None
    img = (rng.uniform(size=(5, 6, 4)) * 255).astype(np.uint8)
    assert np.array_equal(tdata.pil_to_array(img), jdata.pil_to_array(img))


def test_native_resize_matches_jax_binding():
    """The port builds native/preprocess.cpp into its own build directory;
    both bindings of the library give the same bits (skipped where no C++
    compiler builds it)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native library does not build here")
    assert not tnative.library_path().startswith(tnative._REPO + "/native")
    rng = np.random.default_rng(3)
    imgs = [(rng.uniform(size=s) * 255).astype(np.uint8) for s in ((40, 30, 3), (17, 23, 3))]
    for im in imgs:
        np.testing.assert_array_equal(tnative.resize_image_u8(im, 16), jnative.resize_image_u8(im, 16))
    np.testing.assert_array_equal(tnative.resize_batch_u8(imgs, 12, n_threads=2),
                                  jnative.resize_batch_u8(imgs, 12, n_threads=2))
