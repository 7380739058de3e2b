"""The port's URL-fetching data path (``minimagen_tpu_torch/data/dataset.py``)
against the JAX package's on the CPU, offline: a ``ThreadingHTTPServer`` on
localhost serves generated PNGs and failures, and a stub ``datasets``
module stands in for Hugging Face's.

- ``fetch_single_image``: per URL the same image (equal pixels) or the
  same None, for a good PNG, a 404, bytes that are no image, a greyscale
  and an RGBA PNG, a server that hangs past ``timeout``, and a URL that
  fails its first hit at ``retries`` 0 and 1 (the same hit counts);
- ``MinimagenDataset``: per item the same None, or images within 1e-6
  (the port resizes with torch, the JAX package with numpy:
  ``test_torch_data.py``'s tolerance) and equal encodings and masks;
  ``CaptionEncoder.precompute``'s cache equal;
- ``ConceptualCaptions``' HF branch on the stub: the same splits,
  ``smalldata``'s 16 rows, ``VALID_NUM``'s cut, the test set's validation
  rows, and the offline fallback where ``load_dataset`` raises;
- end to end: the live dataset through ``MinimagenCollator`` and
  ``DataLoader`` into one port train step from weights the JAX package
  initialised, the loss within 1e-5 relative of the JAX step on the same
  batch and draws (float32).
"""
import io
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.data import collate as jcollate
from minimagen_tpu.data import dataset as jdata
from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.checkpoint import unet_state_dict
from minimagen_tpu_torch.data import collate as tcollate
from minimagen_tpu_torch.data import dataset as tdata
from minimagen_tpu_torch.models import unet as T
from minimagen_tpu_torch.models.imagen import Imagen as TImagen

ENCODER, TEXT_LEN, SIDE = "t5_small", 8, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the server                                                                  #
# --------------------------------------------------------------------------- #
def _png_bytes(h=20, w=24, mode="RGB", seed=0):
    import PIL.Image

    rng = np.random.default_rng(seed)
    if mode == "RGB":
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif mode == "RGBA":
        arr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    else:  # "L"
        arr = rng.integers(0, 256, (h, w), dtype=np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    """/img_<seed>.png a random RGB PNG; /gray.png, /rgba.png; /junk.bin
    bytes that are no image; /hang answers after 3 s; /flaky_<tag>.png a
    500 on its first hit (counted per tag in `hits`), a PNG after; any
    other path a 404."""

    hits = {}
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path.startswith("/img_"):
            body = _png_bytes(seed=int(self.path.rsplit("_", 1)[-1].split(".")[0]))
        elif self.path == "/gray.png":
            body = _png_bytes(mode="L")
        elif self.path == "/rgba.png":
            body = _png_bytes(mode="RGBA")
        elif self.path == "/junk.bin":
            body = b"this is not an image at all" * 10
        elif self.path == "/hang":
            time.sleep(3.0)
            body = _png_bytes()
        elif self.path.startswith("/flaky_"):
            with _Handler.lock:
                n = _Handler.hits[self.path] = _Handler.hits.get(self.path, 0) + 1
            if n == 1:
                self.send_error(500, "first hit fails")
                return
            body = _png_bytes(seed=5)
        else:
            self.send_error(404, "no such image")
            return
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def http_base():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def _same_image(a, b):
    """Both None, or PIL images of the same mode, size and pixels (and
    ``pil_to_array`` of each equal in bits)."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.mode, a.size) == (b.mode, b.size)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x, y = tdata.pil_to_array(a), jdata.pil_to_array(b)
    assert x.dtype == y.dtype and np.array_equal(x, y)


# --------------------------------------------------------------------------- #
# fetch_single_image                                                          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("path,fetched", [("/img_3.png", True), ("/missing.png", False),
                                          ("/junk.bin", False), ("/gray.png", True),
                                          ("/rgba.png", True)])
def test_fetch_single_image_matches_jax(http_base, path, fetched):
    ours = tdata.fetch_single_image(http_base + path, timeout=5.0)
    ref = jdata.fetch_single_image(http_base + path, timeout=5.0)
    assert (ours is not None) == fetched
    _same_image(ours, ref)


def test_fetch_single_image_times_out_as_jax(http_base):
    """A server that answers after 3 s: None well before that, in both."""
    for fetch in (tdata.fetch_single_image, jdata.fetch_single_image):
        t0 = time.monotonic()
        assert fetch(http_base + "/hang", timeout=0.4) is None
        assert time.monotonic() - t0 < 2.5


@pytest.mark.parametrize("retries", [0, 1])
def test_fetch_single_image_retries_as_jax(http_base, retries):
    """A URL whose first hit fails: None at retries 0, the image at 1, and
    the server hit as often by both packages."""
    got = {}
    for name, fetch in (("port", tdata.fetch_single_image), ("jax", jdata.fetch_single_image)):
        path = f"/flaky_{name}_{retries}.png"
        got[name] = (fetch(http_base + path, timeout=5.0, retries=retries),
                     _Handler.hits.get(path, 0))
    (ours, ours_hits), (ref, ref_hits) = got["port"], got["jax"]
    assert ours_hits == ref_hits == retries + 1
    assert (ours is None) == (retries == 0)
    _same_image(ours, ref)


def test_the_user_agent_is_the_jax_packages():
    assert tdata.USER_AGENT == jdata.USER_AGENT


# --------------------------------------------------------------------------- #
# MinimagenDataset and the caption cache                                      #
# --------------------------------------------------------------------------- #
def _hf_dict(http_base, train_urls, train_caps, valid_urls=(), valid_caps=()):
    return {"train": {"image_url": [f"{http_base}{u}" for u in train_urls],
                      "caption": list(train_caps)},
            "validation": {"image_url": [f"{http_base}{u}" for u in valid_urls],
                           "caption": list(valid_caps)}}


def _same_item(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert set(a) == set(b)
    assert a["image"].shape == b["image"].shape == (SIDE, SIDE, 3)
    assert a["image"].dtype == b["image"].dtype == np.float32
    np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)
    for k in ("encoding", "mask"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _datasets(dset, **kw):
    common = dict(encoder_name=ENCODER, max_length=TEXT_LEN, side_length=SIDE,
                  fetch_timeout=5.0, **kw)
    return tdata.MinimagenDataset(dset, device="cpu", **common), \
        jdata.MinimagenDataset(dset, **common)


def test_minimagen_dataset_items_match_jax(http_base):
    """Good URLs give the same items; a 404, junk bytes, a greyscale and an
    RGBA image give None in both (non-3-channel images are dropped after
    the resize, as the reference does); a transform applies to both, and
    one that returns None drops the item."""
    urls = ["/img_0.png", "/missing.png", "/junk.bin", "/gray.png", "/rgba.png", "/img_1.png"]
    caps = ["a red square", "b", "c", "d", "e", "a much longer caption of many words"]
    ours, ref = _datasets(_hf_dict(http_base, urls, caps))
    assert len(ours) == len(ref) == 6
    items = [(ours[i], ref[i]) for i in range(6)]
    assert [a is None for a, _ in items] == [False, True, True, True, True, False]
    for a, b in items:
        _same_item(a, b)
    flip = lambda arr: arr[:, ::-1].copy()  # noqa: E731
    ours, ref = _datasets(_hf_dict(http_base, urls[:1], caps[:1]), img_transform=flip)
    _same_item(ours[0], ref[0])
    ours, ref = _datasets(_hf_dict(http_base, urls[:1], caps[:1]), img_transform=lambda a: None)
    assert ours[0] is None and ref[0] is None
    ours, ref = _datasets(_hf_dict(http_base, [], [], urls[:2], caps[:2]), train=False)
    assert ours.urls == ref.urls and len(ours) == 2
    _same_item(ours[0], ref[0])


def test_caption_encoder_precompute_matches_jax():
    """``precompute`` (distinct captions in batches, rows cut to their
    mask's count) and ``encode`` (the row as encoded alone) fill equal
    caches."""
    caps = ["a red square", "a blue circle on a green field", "a red square", "x",
            "stripes of yellow and purple and orange", "y z"]
    ours = tdata.CaptionEncoder(ENCODER, TEXT_LEN, "cpu")
    ref = jdata.CaptionEncoder(ENCODER, TEXT_LEN)
    ours.precompute(caps, batch_size=2)
    ref.precompute(caps, batch_size=2)
    assert list(ours._cache) == list(ref._cache) == list(dict.fromkeys(caps))
    for c in ref._cache:
        for x, y in zip(ours._cache[c], ref._cache[c]):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), c
    assert int(ref._cache["x"][1].sum()) == ref._cache["x"][1].size  # cut to the mask
    for c in ("a new caption", "x"):
        for x, y in zip(ours.encode(c), ref.encode(c)):
            assert x.dtype == y.dtype and np.array_equal(x, y), c


# --------------------------------------------------------------------------- #
# ConceptualCaptions' HF branch on a stub `datasets`                          #
# --------------------------------------------------------------------------- #
def _cc_args(**over):
    base = dict(MAX_NUM_WORDS=TEXT_LEN, T5_NAME=ENCODER, IMG_SIDE_LEN=SIDE,
                TRAIN_VALID_FRAC=0.75, VALID_NUM=None)
    base.update(over)
    return SimpleNamespace(**base)


def _fake_cc(n_train=40, n_valid=10):
    return {"train": {"image_url": [f"http://x/{i}.png" for i in range(n_train)],
                      "caption": [f"t{i}" for i in range(n_train)]},
            "validation": {"image_url": [f"http://v/{i}.png" for i in range(n_valid)],
                           "caption": [f"v{i}" for i in range(n_valid)]}}


def _stub(monkeypatch, load_dataset):
    mod = types.ModuleType("datasets")
    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)


@pytest.fixture()
def stub_datasets(monkeypatch):
    names = []

    def load_dataset(name):
        names.append(name)
        return _fake_cc()

    _stub(monkeypatch, load_dataset)
    return names


def _same_split(ours, ref):
    assert type(ours.base) is tdata.MinimagenDataset and type(ref.base) is jdata.MinimagenDataset
    assert list(ours.indices) == list(ref.indices)
    assert list(ours.base.urls) == list(ref.base.urls)
    assert list(ours.base.captions) == list(ref.base.captions)


@pytest.mark.parametrize("smalldata,over,sizes", [
    (True, {}, (12, 4)), (False, {}, (30, 10)),
    (False, dict(TRAIN_VALID_FRAC=0.5, VALID_NUM=3), (20, 4))],
    ids=["smalldata", "full", "valid_num"])
def test_conceptual_captions_hf_branch_matches_jax(stub_datasets, smalldata, over, sizes):
    """``smalldata`` cuts both splits to 16 rows before the split;
    ``VALID_NUM`` keeps VALID_NUM + 1 validation items."""
    args = _cc_args(**over)
    ours = tdata.ConceptualCaptions(args, smalldata=smalldata, device="cpu")
    ref = jdata.ConceptualCaptions(args, smalldata=smalldata)
    assert stub_datasets == ["conceptual_captions"] * 2
    for a, b in zip(ours, ref):
        _same_split(a, b)
    assert (len(ours[0]), len(ours[1])) == sizes
    assert set(ours[0].indices).isdisjoint(ours[1].indices)
    assert len(ours[0].base.urls) == (16 if smalldata else 40)


@pytest.mark.parametrize("smalldata", [False, True])
def test_conceptual_captions_testset_is_the_validation_split(stub_datasets, smalldata):
    ours = tdata.ConceptualCaptions(_cc_args(), smalldata=smalldata, testset=True, device="cpu")
    ref = jdata.ConceptualCaptions(_cc_args(), smalldata=smalldata, testset=True)
    assert type(ours) is tdata.MinimagenDataset
    assert list(ours.urls) == list(ref.urls) and list(ours.captions) == list(ref.captions)
    assert len(ours) == 10 and ours.urls[0].startswith("http://v/")


def test_conceptual_captions_falls_back_offline_as_jax(monkeypatch):
    """A ``load_dataset`` that raises: both warn and serve the synthetic
    set, split alike."""
    def load_dataset(name):
        raise RuntimeError("offline")

    _stub(monkeypatch, load_dataset)
    with pytest.warns(UserWarning, match="offline synthetic"):
        ours = tdata.ConceptualCaptions(_cc_args(), smalldata=True, device="cpu")
    with pytest.warns(UserWarning, match="offline synthetic"):
        ref = jdata.ConceptualCaptions(_cc_args(), smalldata=True)
    assert type(ours[0].base) is tdata.SyntheticCaptionedImages
    assert len(ours[0]) + len(ours[1]) == 16
    for a, b in zip(ours, ref):
        assert list(a.indices) == list(b.indices)
    item, want = ours[1][0], ref[1][0]
    for k in want:
        assert np.array_equal(item[k], want[k]), k


# --------------------------------------------------------------------------- #
# end to end                                                                  #
# --------------------------------------------------------------------------- #
UNET = dict(dim=16, dim_mults=(1,), num_resnet_blocks=1, layer_attns=False,
            layer_cross_attns=True, attn_heads=2)


def _jax_draws(ref, key, step, b):
    """The JAX train step's draws at `step` (``mesh.py:346-347``,
    ``imagen.py:1164,1232-1243``), per stage, as torch tensors."""
    keys = jax.random.split(jax.random.fold_in(key, step), ref.num_unets)
    draws = []
    for i, size in enumerate(ref.image_sizes):
        times_key, _, p_key = jax.random.split(keys[i], 3)
        noise_key, _, drop_key = jax.random.split(p_key, 3)
        d = {"times": ref.noise_schedulers[i].sample_random_times(times_key, b),
             "noise": jax.random.normal(noise_key, (b, size, size, ref.channels), jnp.float32),
             "keep_mask": jax.random.uniform(drop_key, (b,)) < 1.0 - ref.cond_drop_prob}
        draws.append({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    return draws


def test_live_dataset_to_a_train_step_matches_jax(http_base):
    """Four good URLs and a 404 through each package's MinimagenCollator and
    DataLoader: the same 4-row batch (the 404 dropped). One port train step
    from weights the JAX package initialised, on the port's batch with the
    JAX step's draws: the loss within 1e-5 relative of the JAX step's on
    the same batch, and the parameters moved."""
    urls = [f"/img_{i}.png" for i in range(4)] + ["/missing.png"]
    caps = [f"caption number {i}" for i in range(5)]
    ours_ds, ref_ds = _datasets(_hf_dict(http_base, urls, caps))
    kw = dict(batch_size=5, shuffle=False, drop_last=False)
    batch = next(iter(tcollate.DataLoader(
        ours_ds, collate_fn=tcollate.MinimagenCollator(max_length=TEXT_LEN), **kw)))
    ref_batch = next(iter(jcollate.DataLoader(
        ref_ds, collate_fn=jcollate.MinimagenCollator(max_length=TEXT_LEN), **kw)))
    assert batch["image"].shape == (4, SIDE, SIDE, 3)
    np.testing.assert_allclose(np.asarray(batch["image"]), np.asarray(ref_batch["image"]),
                               rtol=0, atol=1e-6)
    for k in ("encoding", "mask"):
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(ref_batch[k]))

    kwi = dict(image_sizes=(SIDE,), timesteps=25, cond_drop_prob=0.1, text_encoder_name=ENCODER)
    ref = JImagen(unets=[J.UnetConfig(**UNET)], **kwi)
    ref.init_params(jax.random.PRNGKey(0), batch_size=2, text_len=TEXT_LEN)
    ours = TImagen([T.UnetConfig(**UNET)], device="cpu", **kwi)
    ours.unets[0].load_state_dict(unet_state_dict(
        jax.tree_util.tree_map(np.asarray, ref.params["unet_0"])))
    p0 = [p.detach().clone() for p in ours.unets.parameters()]

    key = jax.random.PRNGKey(1)
    jopt = jmesh.make_optimizer(1e-4)
    jstep = jmesh.make_train_step(ref, jopt, mesh=None, donate=False)
    np_batch = {k: np.asarray(v) for k, v in batch.items()}
    _, jlosses = jstep(jmesh.create_train_state(ref.params, jopt),
                       {k: jnp.asarray(v) for k, v in np_batch.items()}, key)
    topt = ttrain.make_optimizer(1e-4)
    tstep = ttrain.make_train_step(ours, topt)
    state = ttrain.create_train_state(ours, topt)
    state, tlosses = tstep(state, {k: torch.from_numpy(v) for k, v in np_batch.items()},
                           draws=_jax_draws(ref, key, 0, 4))
    assert np.isfinite(tlosses.numpy()).all()
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-5)
    assert any(not torch.equal(a, b.detach()) for a, b in zip(p0, ours.unets.parameters()))
