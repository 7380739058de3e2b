"""The port's Orbax interchange (``orbax_format.py``, ``training.py``'s
``save_train_state_orbax`` / ``load_train_state_orbax``) against zstandard,
tensorstore and the JAX package on the CPU:

- ``zstd_decompress`` against ``zstandard``'s compressor on a corpus of
  levels, sizes and contents, several frames, a checksum, no content size;
  ``zstd_frame_raw`` read back by ``zstandard``;
- the OCDBT reader against tensorstore's own reads, with interior nodes,
  indirect values and node compression on and off;
- train states of a dim-16 cascade (bf16 first moment, EMA, step 3) that
  the JAX package's ``save_train_state_orbax`` writes, replicated or sharded
  over a {data 1, model 2} mesh, read by the port in equal bits; the port's
  writes restored by the JAX package in equal bits; ``MinimagenTrain``
  restarted from an Orbax-only directory as from ``train_state.ckpt``;
- the committed fixture ``tests/data/orbax_tiny/`` against a fresh write of
  its recipe.

The fixture is a restart directory: ``cascade.json`` (the U-Nets, the
Imagen settings, the optimizer's first-moment dtype, the EMA decay, the
step and the seed) and ``tmp/train_state_orbax/``, which the JAX package
wrote (orbax-checkpoint 0.11.32) from the state :func:`fixture_state` makes.
To write it again::

    JAX_PLATFORMS=cpu python tests/test_torch_orbax.py --write-fixture
"""
import ast
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import zstandard

from minimagen_tpu import training as jtrain
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import checkpoint as tckpt
from minimagen_tpu_torch import orbax_format as of
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.data.collate import DataLoader, MinimagenCollator
from minimagen_tpu_torch.data.dataset import SyntheticCaptionedImages
from minimagen_tpu_torch.models.imagen import Imagen as TImagen
from minimagen_tpu_torch.models.unet import UnetConfig

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "orbax_tiny")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# zstd                                                                        #
# --------------------------------------------------------------------------- #
def _content(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size)
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "repeats":
        return (b"minimagen " * (size // 10 + 1))[:size]
    if kind == "text":
        words = [bytes(rng.integers(97, 123, n, dtype=np.uint8)) for n in rng.integers(2, 9, 400)]
        picks = rng.integers(0, len(words), size // 3 + 1)
        return b" ".join(words[i] for i in picks)[:size]
    w = rng.normal(size=size // 4 + 1).astype(np.float32)
    if kind == "f32":
        return w.tobytes()[:size]
    return np.asarray(w, ml_dtypes.bfloat16).tobytes()[:size]  # bf16


# (content, size): sizes 0, 1, 127, 128 KiB +- 1 and ~2 MB
ZSTD_CASES = [("random", 0), ("text", 1), ("text", 127), ("repeats", 128 * 1024 - 1),
              ("bf16", 128 * 1024 - 1), ("f32", 128 * 1024 + 1), ("text", 128 * 1024 + 1),
              ("f32", 2_000_000), ("random", 2_000_000), ("text", 2_000_000)]


@pytest.mark.parametrize("kind,size", ZSTD_CASES)
@pytest.mark.parametrize("level", [1, 3, 9, 19, -5])
def test_zstd_decompress_matches_zstandard(level, kind, size):
    data = _content(kind, size)
    assert of.zstd_decompress(zstandard.ZstdCompressor(level=level).compress(data)) == data


@pytest.mark.parametrize("form", ["frames", "checksum", "no_content_size"])
def test_zstd_decompress_frame_forms(form):
    """Two frames with a skippable frame between; a frame with a content
    checksum; a streamed frame whose header gives no content size."""
    a, b = _content("text", 300_000), _content("f32", 70_000)
    if form == "frames":
        skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
        c = zstandard.ZstdCompressor(level=3)
        data, want = c.compress(a) + skip + c.compress(b), a + b
    elif form == "checksum":
        data, want = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a), a
    else:
        c = zstandard.ZstdCompressor(level=3, write_content_size=False)
        data, want = c.compress(a), a
        assert zstandard.get_frame_parameters(data).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert of.zstd_decompress(data) == want


ZSTD_F32_SAMPLE = os.path.join(os.path.dirname(FIXTURE), "zstd", "normal_f32_level1.zst")


def zstd_f32_sample() -> bytes:
    """The content of ``tests/data/zstd/normal_f32_level1.zst``: 2^18
    float32 draws of N(0, 1) from numpy's generator at seed 0. Its frame is
    ``zstandard.ZstdCompressor(level=1).compress`` of these bytes: literals
    Huffman-coded in 4 streams and few matches, as zstd codes trained float32
    weights (``chip_smoke.py`` times the decoder on it, where no zstd
    compressor is installed)."""
    return np.random.default_rng(0).normal(size=1 << 18).astype(np.float32).tobytes()


def test_the_committed_float32_zstd_sample_decodes_to_its_recipe():
    frame = open(ZSTD_F32_SAMPLE, "rb").read()
    want = zstd_f32_sample()
    assert zstandard.ZstdDecompressor().decompress(frame) == want
    assert of.zstd_decompress(frame) == want


def test_zstd_decompress_refuses_a_dictionary():
    """A frame naming dictionary 7 (single segment, 1-byte dictionary id,
    an empty last Raw block) is refused."""
    frame = of.ZSTD_MAGIC.to_bytes(4, "little") + bytes([0x21, 7, 0]) + bytes([1, 0, 0])
    assert zstandard.get_frame_parameters(frame).dict_id == 7
    with pytest.raises(of.ZstdError, match="dictionar"):
        of.zstd_decompress(frame)


@pytest.mark.parametrize("kind,size", ZSTD_CASES)
@pytest.mark.parametrize("level", [1, 3, 9, 19, -5])
def test_plain_zstd_decoder_matches_zstandard(level, kind, size):
    """The Python decoder, the host decoder's plain version, on the same
    corpus as ``test_zstd_decompress_matches_zstandard``."""
    data = _content(kind, size)
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert of.zstd_decompress(frame, plain=True) == data


@pytest.mark.parametrize("form", ["frames", "checksum", "no_content_size"])
@pytest.mark.parametrize("plain", [False, True], ids=["host", "python"])
def test_both_decoders_read_frame_forms_with_checksums(form, plain):
    """As ``test_zstd_decompress_frame_forms``, every frame with its XXH64
    content checksum, which each decoder verifies."""
    a, b = _content("text", 300_000), _content("f32", 70_000)
    c = zstandard.ZstdCompressor(level=3, write_checksum=True,
                                 write_content_size=form != "no_content_size")
    if form == "frames":
        skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
        data, want = c.compress(a) + skip + c.compress(b), a + b
    else:
        data, want = c.compress(a), a
    assert zstandard.get_frame_parameters(data).has_checksum
    assert of.zstd_decompress(data, plain=plain) == want


@pytest.mark.parametrize("where", ["checksum", "content"])
@pytest.mark.parametrize("plain", [False, True], ids=["host", "python"])
def test_a_corrupt_frame_with_a_checksum_is_refused(where, plain):
    """One flipped bit in a frame's XXH64 checksum, or in the content of
    its Raw block (the frame's structure intact), raises ZstdError in both
    decoders: a corrupt chunk that carries a checksum never restores."""
    data = _content("random", 5000)
    for frame in (of.zstd_frame_raw(data, checksum=True),
                  zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)):
        assert of.zstd_decompress(frame, plain=plain) == data
        bad = bytearray(frame)
        bad[-3 if where == "checksum" else len(frame) // 2] ^= 0x08
        with pytest.raises(of.ZstdError, match="checksum"):
            of.zstd_decompress(bytes(bad), plain=plain)


# XXH64 with seed 0 (the reference implementation's published values)
XXH64_KNOWN = {b"": 0xEF46DB3751D8E999, b"a": 0xD24EC4F1A98C6E5B, b"abc": 0x44BC2CF5AD770999}


@pytest.mark.parametrize("plain", [False, True], ids=["host", "python"])
def test_xxh64_matches_known_values_and_the_other_decoder(plain):
    from minimagen_tpu_torch.host import zstd as host_zstd

    xxh = of.xxh64 if plain else host_zstd.xxh64
    for data, want in XXH64_KNOWN.items():
        assert xxh(data) == want
    rng = np.random.default_rng(3)
    for n in [*range(0, 70), 1000, 4099]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert of.xxh64(data) == host_zstd.xxh64(data)


def test_both_decoders_read_the_committed_sample_and_fixture_alike():
    """The Huffman-coded float32 sample decodes to its recipe in both
    decoders, and ``read_checkpoint`` of the committed fixture gives equal
    bits through either."""
    frame = open(ZSTD_F32_SAMPLE, "rb").read()
    assert of.zstd_decompress(frame, plain=True) == of.zstd_decompress(frame) == zstd_f32_sample()
    sub = os.path.join(FIXTURE, "tmp", ttrain.ORBAX_STATE_DIR)
    host, plain = of.read_checkpoint(sub), of.read_checkpoint(sub, plain=True)
    assert [k for k, _, _ in host] == [k for k, _, _ in plain]
    for (k, _, a), (_, _, b) in zip(host, plain):
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), k


def test_the_host_decoder_builds_under_build_named_by_its_hash(tmp_path, monkeypatch):
    """The library sits in the checkout's gitignored build/minimagen_tpu_torch/,
    named by a hash of the source and flags; a source that does not
    compile raises ZstdBuildError, and read_checkpoint raises with it
    rather than falling back to the Python decoder."""
    from minimagen_tpu_torch.host import zstd as host_zstd

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = host_zstd.library_path()
    assert os.path.dirname(path) == os.path.join(root, "build", "minimagen_tpu_torch")
    host_zstd.library()
    assert os.path.exists(path)
    broken = tmp_path / "broken.c"
    broken.write_text("int mmt_zstd_decompress(void) { return; }\n  this is not C\n")
    monkeypatch.setattr(host_zstd, "SOURCE", str(broken))
    monkeypatch.setattr(host_zstd, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(host_zstd, "_lib", None)
    assert host_zstd.library_path() != path
    with pytest.raises(host_zstd.ZstdBuildError):
        host_zstd.library()
    with pytest.raises(host_zstd.ZstdBuildError):
        of.read_checkpoint(os.path.join(FIXTURE, "tmp", ttrain.ORBAX_STATE_DIR))


@pytest.mark.parametrize("size", [0, 1, 255, 65_791, 128 * 1024, 128 * 1024 + 1, 1_000_000])
def test_zstd_frame_raw_is_read_by_zstandard(size):
    data = _content("random", size)
    frame = of.zstd_frame_raw(data)
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=size + 1) == data
    assert of.zstd_decompress(frame) == data


# --------------------------------------------------------------------------- #
# OCDBT against tensorstore                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 8, "compression": None},
    {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16},
    {}], ids=["small-nodes-raw", "small-nodes-zstd", "default"])
def test_ocdbt_reader_matches_tensorstore(tmp_path, config):
    """Keys and values as tensorstore reads them, across several
    generations, interior nodes and indirect values."""
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/", "config": config}
    kv = ts.KvStore.open(spec).result()
    for g in range(3):
        with ts.Transaction() as txn:
            for i in range(40):
                kv.with_transaction(txn)[f"key{i:03d}/{g}"] = (b"v%d." % i) * (i % 9 + g + 1)
    want = {k: kv.read(k).result().value for k in kv.list().result()}
    reader = of.OcdbtReader(str(tmp_path))
    assert reader.keys() == sorted(want)
    assert {k: reader.get(k) for k in reader.keys()} == want


# --------------------------------------------------------------------------- #
# train states                                                                #
# --------------------------------------------------------------------------- #
def _cascade(spec, device="cpu", dtype=torch.float32):
    unets = [UnetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in u.items()})
             for u in spec["unets"]]
    torch.manual_seed(spec["seed"])
    kw = dict(spec["imagen"], image_sizes=tuple(spec["imagen"]["image_sizes"]))
    return TImagen(unets, device=device, dtype=dtype, **kw)


FIXTURE_SPEC = json.load(open(os.path.join(FIXTURE, "cascade.json")))
# one U-Net as test_parallel.py's sharded Orbax test has it, at one level (dim 32:
# min_shard_dim 32 splits it)
SHARDED_SPEC = {"unets": [{"dim": 32, "dim_mults": [1], "num_resnet_blocks": 1,
                           "layer_attns": False, "layer_cross_attns": False}],
                "imagen": {"image_sizes": [8], "timesteps": 25, "cond_drop_prob": 0.15,
                           "text_encoder_name": "t5_small"},
                "mu_dtype": "bf16", "ema": 0.9, "step": 3, "seed": 0}


def _values(rng, shape, quantised):
    if quantised:  # 8 small levels repeating every 29 elements: small zstd frames
        n = int(np.prod(shape))
        return np.resize(rng.integers(-4, 4, 29) / 512.0, n).reshape(shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def fixture_state(spec=FIXTURE_SPEC, quantised=True, device="cpu"):
    """The port's (imagen, state) of `spec`: a bf16 first moment, the EMA,
    every tensor drawn from numpy's generator at `spec`'s seed (8 levels
    within +-1/128 repeating where `quantised`; the second moment kept off
    0: a state that trains on), the step and Adam's count at spec's step."""
    imagen = _cascade(spec, device)
    mu = torch.bfloat16 if spec["mu_dtype"] == "bf16" else None
    state = ttrain.create_train_state(imagen, ttrain.make_optimizer(1e-4, 1, mu), ema=True)
    rng = np.random.default_rng(spec["seed"])
    opt = state.opt_state
    with torch.no_grad():
        for group, positive in ((state.params, False), (opt.mu, False), (opt.nu, True),
                                (state.ema_params, False)):
            for t in group:
                v = _values(rng, tuple(t.shape), quantised)
                t.copy_(torch.from_numpy(np.abs(v) + 2.0 ** -9 if positive else v))
    state.step = state.opt_state.count = spec["step"]
    return imagen, state


def _jax_state(imagen, state, tmp, mesh=None):
    """The JAX package's TrainState holding `state`'s values (through the
    port's msgpack file, which both packages read alike); on `mesh`, the
    U-Net leaves sharded by ``infer_param_shardings(min_shard_dim=32)``."""
    params = {}
    for i, u in enumerate(imagen.unets):
        for path, t in tckpt._flatten(tckpt.flax_unet_tree(u)):
            node = params.setdefault(f"unet_{i}", {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.zeros(t.shape, np.float32)
    mu = jnp.bfloat16 if state.opt_state.mu[0].dtype == torch.bfloat16 else None
    tx = jmesh.make_optimizer(1e-4, 1, mu_dtype=mu)
    template = jmesh.create_train_state(params, tx, ema=True)
    tckpt.save_train_state(os.path.join(tmp, "s.ckpt"), state)
    jstate = jtrain.load_train_state(os.path.join(tmp, "s.ckpt"), template)
    if mesh is None:
        return jstate
    shard = jmesh.infer_param_shardings(params, mesh, min_shard_dim=32)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    trees = {"params": shard, "ema_params": shard}
    adam = jstate.opt_state[1][0]
    placed = jstate.replace(
        step=jax.device_put(jstate.step, rep),
        params=jax.tree_util.tree_map(jax.device_put, jstate.params, trees["params"]),
        ema_params=jax.tree_util.tree_map(jax.device_put, jstate.ema_params, trees["ema_params"]),
        opt_state=(jstate.opt_state[0], (adam._replace(
            count=jax.device_put(adam.count, rep),
            mu=jax.tree_util.tree_map(jax.device_put, adam.mu, shard),
            nu=jax.tree_util.tree_map(jax.device_put, adam.nu, shard)), jstate.opt_state[1][1])))
    return placed


def _jax_leaves(jstate):
    """Every array of a JAX TrainState by its Orbax name, as raw bits."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in path)
        out[name] = np.asarray(leaf)
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a.view(f"u{a.itemsize}")


def _assert_port_leaves_equal(directory, jstate):
    got = {".".join(k): t for k, _, t in of.read_checkpoint(directory) if t is not None}
    want = _jax_leaves(jstate)
    assert set(got) == set(want)
    for name, a in want.items():
        t = got[name]
        b = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert b.shape == a.shape and b.dtype.itemsize == a.dtype.itemsize, name
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for xs, ys in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                   (a.opt_state.nu, b.opt_state.nu), (a.ema_params, b.ema_params)):
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())


def test_the_port_reads_a_jax_orbax_state_in_equal_bits(tmp_path):
    """The dim-16 cascade's state with random values (bf16 first moment,
    EMA, step 3), written by ``jtrain.save_train_state_orbax``: every array
    read equal in bits (``load_train_state_orbax`` into a state: the
    fixture's test and the restart's)."""
    imagen, state = fixture_state(quantised=False)
    jstate = _jax_state(imagen, state, str(tmp_path))
    jtrain.save_train_state_orbax(str(tmp_path / "orbax"), jstate)
    _assert_port_leaves_equal(str(tmp_path / "orbax"), jstate)


def test_the_port_reads_a_sharded_jax_orbax_state_in_equal_bits(tmp_path):
    """The same over a {data 1, model 2} mesh: the split kernels arrive in
    two chunks each, put together on the chunk grid."""
    mesh = jmesh.make_mesh(jax.devices()[:2], model_parallel=2)
    imagen, state = fixture_state(SHARDED_SPEC, quantised=False)
    jstate = _jax_state(imagen, state, str(tmp_path), mesh)
    jtrain.save_train_state_orbax(str(tmp_path / "orbax"), jstate)
    reader = of.OcdbtReader(str(tmp_path / "orbax"))
    assert any(k.endswith(b".1") for k in reader.keys())  # a second chunk along an axis
    _assert_port_leaves_equal(str(tmp_path / "orbax"), jstate)


def test_the_jax_package_restores_the_ports_orbax_state_in_equal_bits(tmp_path):
    imagen, state = fixture_state(quantised=False)
    ttrain.save_train_state_orbax(str(tmp_path / "orbax"), state)
    assert sorted(os.listdir(tmp_path / "orbax")) == [
        "_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt", "ocdbt.process_0"]
    template = _jax_state(imagen, fixture_state(dict(FIXTURE_SPEC, seed=7))[1], str(tmp_path))
    restored = jtrain.load_train_state_orbax(str(tmp_path / "orbax"), template)
    want = _jax_state(imagen, state, str(tmp_path))
    got, ref = _jax_leaves(restored), _jax_leaves(want)
    assert set(got) == set(ref)
    for name, a in ref.items():
        assert got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(a), err_msg=name)
    # and the port reads its own write back
    _, other = fixture_state(dict(FIXTURE_SPEC, seed=7), quantised=False)
    ttrain.load_train_state_orbax(str(tmp_path / "orbax"), other)
    _assert_states_equal(other, state)


def _args(**over):
    args = ttrain.load_testing_parameters(ttrain.get_minimagen_parser().parse_args([]))
    args.IMG_SIDE_LEN, args.EPOCHS, args.CHCKPT_NUM, args.MAX_NUM_WORDS = 16, 1, 1, 8
    args.__dict__.update(over)
    return args


def _loader():
    ds = SyntheticCaptionedImages(num_items=4, side_length=16, encoder_name="t5_small",
                                  max_length=8, device="cpu")
    return DataLoader(ds, batch_size=2, collate_fn=MinimagenCollator(max_length=8),
                      shuffle=False)


def test_minimagen_train_restarts_from_an_orbax_only_directory(tmp_path, monkeypatch, capsys):
    """A restart directory whose tmp/ holds only the JAX package's
    ``train_state_orbax/`` resumes as one holding ``train_state.ckpt`` of
    the same state: the same losses over 2 steps, the same step and count."""
    imagen, state = fixture_state(quantised=False)
    jstate = _jax_state(imagen, state, str(tmp_path))
    os.makedirs(tmp_path / "orbax_run" / "tmp")
    jtrain.save_train_state_orbax(str(tmp_path / "orbax_run" / "tmp" / ttrain.ORBAX_STATE_DIR),
                                  jstate)
    os.makedirs(tmp_path / "ckpt_run" / "tmp")
    tckpt.save_train_state(str(tmp_path / "ckpt_run" / "tmp" / ttrain.TRAIN_STATE_FILE), state)
    monkeypatch.chdir(tmp_path)
    summaries = {}
    for run in ("orbax_run", "ckpt_run"):
        imagen = _cascade(FIXTURE_SPEC)
        args = _args(EMA=0.9, RESTART_DIRECTORY=str(tmp_path / run))
        training_dir = ttrain.create_directory(str(tmp_path / f"training_{run}"))
        summaries[run] = ttrain.MinimagenTrain(
            run, args, imagen.unet_configs, imagen, _loader(), _loader(), training_dir,
            optimizer=ttrain.make_optimizer(1e-4, 1, torch.bfloat16))
        kind = "orbax" if run == "orbax_run" else "msgpack"
        assert f"[{kind}]" in capsys.readouterr().out
    a, b = summaries["orbax_run"], summaries["ckpt_run"]
    assert a["start_step"] == a["start_adam_count"] == 3
    assert a["final_step"] == a["adam_count"] == b["final_step"] == b["adam_count"] == 5
    assert [h["batch_train"] for h in a["history"]] == [h["batch_train"] for h in b["history"]]
    assert len(a["history"]) == 2 and np.isfinite(a["history"][-1]["batch_train"]).all()


def write_fixture(directory: str = FIXTURE) -> None:
    """The committed fixture: :func:`fixture_state` written by the JAX
    package's ``save_train_state_orbax`` into `directory`'s
    tmp/train_state_orbax/."""
    import tempfile

    imagen, state = fixture_state()
    with tempfile.TemporaryDirectory() as tmp:
        jstate = _jax_state(imagen, state, tmp)
    out = os.path.join(directory, "tmp", ttrain.ORBAX_STATE_DIR)
    shutil.rmtree(out, ignore_errors=True)
    jtrain.save_train_state_orbax(out, jstate)


def test_the_committed_fixture_matches_a_fresh_jax_write(tmp_path):
    """The port reads the committed fixture and a fresh write of its recipe
    to the same bits, and restores it into the recipe's state."""
    shutil.copy(os.path.join(FIXTURE, "cascade.json"), tmp_path / "cascade.json")
    write_fixture(str(tmp_path))
    sub = os.path.join("tmp", ttrain.ORBAX_STATE_DIR)
    fresh = of.read_checkpoint(str(tmp_path / sub))
    committed = of.read_checkpoint(os.path.join(FIXTURE, sub))
    assert [k for k, _, _ in fresh] == [k for k, _, _ in committed]
    for (k, types, a), (_, types_b, b) in zip(fresh, committed):
        assert types == types_b and (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), k
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(FIXTURE) for f in fs)
    assert size <= 1 << 20
    _, want = fixture_state()
    _, got = fixture_state(dict(FIXTURE_SPEC, seed=7), quantised=False)
    ttrain.load_train_state_orbax(os.path.join(FIXTURE, sub), got)
    _assert_states_equal(got, want)


def test_a_jax_side_conversion_to_train_state_ckpt_restores_in_equal_bits(tmp_path):
    """The fast route for a large JAX-written state (README): the JAX
    package restores its Orbax directory and writes ``train_state.ckpt``
    with its ``save_train_state``; the port reads that file (no zstd) to
    the same bits as the Orbax directory."""
    sub = os.path.join(FIXTURE, "tmp", ttrain.ORBAX_STATE_DIR)
    imagen, want = fixture_state()
    template = _jax_state(imagen, fixture_state(dict(FIXTURE_SPEC, seed=7))[1], str(tmp_path))
    path = str(tmp_path / ttrain.TRAIN_STATE_FILE)
    jtrain.save_train_state(path, jtrain.load_train_state_orbax(sub, template))
    _, got = fixture_state(dict(FIXTURE_SPEC, seed=7), quantised=False)
    tckpt.load_train_state(path, got)
    _assert_states_equal(got, want)


# --------------------------------------------------------------------------- #
# gradient accumulation: optax.MultiSteps' state                              #
# --------------------------------------------------------------------------- #
ACCUM, ACCUM_LR, ACCUM_BATCH, ACCUM_TEXT = 2, 1e-4, 2, 8  # lr: the train CLI's default


def _accum_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((ACCUM_BATCH, ACCUM_TEXT), bool)
    mask[1, 5:] = False
    side = FIXTURE_SPEC["imagen"]["image_sizes"][-1]
    return {"image": rng.uniform(size=(ACCUM_BATCH, side, side, 3)).astype(np.float32),
            "encoding": rng.normal(size=(ACCUM_BATCH, ACCUM_TEXT, 512)).astype(np.float32),
            "mask": mask}


def _accum_draws(ref, key, step):
    """The JAX train step's draws at `step` (``mesh.py:346-347``,
    ``imagen.py:1164,1232-1243``), per stage, as torch tensors."""
    keys = jax.random.split(jax.random.fold_in(key, step), ref.num_unets)
    draws = []
    for i, size in enumerate(ref.image_sizes):
        times_key, aug_key, p_key = jax.random.split(keys[i], 3)
        noise_key, lowres_key, drop_key = jax.random.split(p_key, 3)
        shape = (ACCUM_BATCH, size, size, ref.channels)
        d = {"times": ref.noise_schedulers[i].sample_random_times(times_key, ACCUM_BATCH),
             "noise": jax.random.normal(noise_key, shape, jnp.float32),
             "keep_mask": jax.random.uniform(drop_key, (ACCUM_BATCH,)) < 1.0 - ref.cond_drop_prob}
        if i > 0:
            aug = ref.lowres_noise_schedule.sample_random_times(aug_key, 1)
            d["lowres_aug_times"] = jnp.repeat(aug, ACCUM_BATCH)
            d["lowres_noise"] = jax.random.normal(lowres_key, shape, jnp.float32)
        draws.append({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    return draws


class _AccumRun:
    """The fixture's dim-16 cascade (flax-style init from its seed) trained
    under ``accum_iter`` 2 (bf16 first moment, the EMA) by both packages
    from the same weights, batches and draws: each package's train state
    after 1 and after 2 mini-steps."""

    def __init__(self):
        from minimagen_tpu.models import unet as J
        from minimagen_tpu.models.imagen import Imagen as JImagen

        self.imagen = _cascade(FIXTURE_SPEC)
        self.ref = JImagen(unets=[J.UnetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                   for k, v in u.items()})
                                  for u in FIXTURE_SPEC["unets"]],
                           **dict(FIXTURE_SPEC["imagen"],
                                  image_sizes=tuple(FIXTURE_SPEC["imagen"]["image_sizes"])))
        self.params = {f"unet_{i}": jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), tckpt.flax_unet_tree(u))
            for i, u in enumerate(self.imagen.unets)}
        self.key = jax.random.PRNGKey(5)
        self.jtx = jmesh.make_optimizer(ACCUM_LR, ACCUM, mu_dtype=jnp.bfloat16)
        self.jstep = jmesh.make_train_step(self.ref, self.jtx, donate=False,
                                           ema_decay=FIXTURE_SPEC["ema"])
        jstate = jmesh.create_train_state(self.params, self.jtx, ema=True)
        tstate = self.port_state()
        self.tstep = ttrain.make_train_step(self.imagen, self.port_optimizer(),
                                            ema_decay=FIXTURE_SPEC["ema"])
        self.jax_states, self.port_states = {}, {}
        for k in (1, 2):
            jstate, _ = self.jax_step(jstate)
            tstate, _ = self.port_step(tstate)
            self.jax_states[k] = jstate
            self.port_states[k] = ttrain.create_train_state(
                _cascade(FIXTURE_SPEC), self.port_optimizer(), ema=True)
            _copy_state(tstate, self.port_states[k])

    def port_optimizer(self):
        return ttrain.make_optimizer(ACCUM_LR, ACCUM, torch.bfloat16)

    def port_state(self, seed=None):
        imagen = self.imagen if seed is None else _cascade(dict(FIXTURE_SPEC, seed=seed))
        return ttrain.create_train_state(imagen, self.port_optimizer(), ema=True)

    def jax_step(self, jstate):
        batch = _accum_batch(int(jstate.step))
        return self.jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, self.key)

    def port_step(self, tstate, imagen=None):
        step = self.tstep if imagen is None else ttrain.make_train_step(
            imagen, self.port_optimizer(), ema_decay=FIXTURE_SPEC["ema"])
        batch = _accum_batch(tstate.step)
        return step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                    draws=_accum_draws(self.ref, self.key, tstate.step))

    def template(self):
        """A JAX TrainState of the same structure and other values."""
        params = jax.tree_util.tree_map(lambda a: a + 1.0, self.params)
        return jmesh.create_train_state(params, self.jtx, ema=True)


def _copy_state(src, dst):
    """`src`'s values into `dst` (another state of the same layout)."""
    with torch.no_grad():
        for xs, ys in ((src.params, dst.params), (src.opt_state.mu, dst.opt_state.mu),
                       (src.opt_state.nu, dst.opt_state.nu), (src.ema_params, dst.ema_params),
                       (src.opt_state.acc_grads, dst.opt_state.acc_grads)):
            for x, y in zip(xs, ys):
                y.copy_(x)
    dst.step = src.step
    for name in ("count", "mini_step", "gradient_step"):
        setattr(dst.opt_state, name, getattr(src.opt_state, name))


def _port_leaves(state):
    """Every array of a port TrainState by its Orbax name, as numpy."""
    return {".".join(keys): (t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                             if t.dtype == torch.bfloat16 else t.numpy())
            for keys, _, t in ttrain._orbax_leaves(tckpt.train_state_dict(state))
            if t is not None}


def _assert_leaves_equal(got, want):
    assert set(got) == set(want)
    for name, a in want.items():
        b = got[name]
        assert b.shape == a.shape and b.dtype.itemsize == a.dtype.itemsize, name
        np.testing.assert_array_equal(_bits(np.asarray(b)), _bits(np.asarray(a)), err_msg=name)


@pytest.fixture(scope="module")
def accum_run():
    return _AccumRun()


@pytest.mark.parametrize("mini_steps", [1, 2])
def test_the_port_reads_a_jax_accumulation_state_in_equal_bits(accum_run, tmp_path, mini_steps):
    """``accum_iter`` 2: the JAX package's Orbax write after one mini-step
    (``mini_step`` 1, ``acc_grads`` the first gradients) and after two (the
    update made, ``mini_step`` 0, ``gradient_step`` 1): every leaf read in
    equal bits, and ``load_train_state_orbax`` puts each field into a port
    state in equal bits."""
    jstate = accum_run.jax_states[mini_steps]
    inner = jstate.opt_state
    assert int(inner.mini_step) == mini_steps % ACCUM
    assert int(inner.gradient_step) == mini_steps // ACCUM
    assert any(np.abs(np.asarray(g)).max() > 0 for g in jax.tree_util.tree_leaves(
        inner.acc_grads)) == (mini_steps % ACCUM == 1)
    path = str(tmp_path / "jax")
    jtrain.save_train_state_orbax(path, jstate)
    _assert_port_leaves_equal(path, jstate)
    state = accum_run.port_state(seed=7)
    ttrain.load_train_state_orbax(path, state)
    assert (state.step, state.opt_state.count) == (mini_steps, mini_steps // ACCUM)
    assert (state.opt_state.mini_step, state.opt_state.gradient_step) == (
        mini_steps % ACCUM, mini_steps // ACCUM)
    _assert_leaves_equal(_port_leaves(state), _jax_leaves(jstate))


@pytest.mark.parametrize("mini_steps", [1, 2])
def test_the_jax_package_restores_the_ports_accumulation_state_in_equal_bits(
        accum_run, tmp_path, mini_steps):
    """The port's own state after the same mini-steps, written by
    ``save_train_state_orbax``: the JAX package restores every leaf of it
    in equal bits (``mini_step``, ``gradient_step``, ``acc_grads`` too);
    and the port's state agrees with the JAX package's as the train steps
    of ``test_torch_training.py`` do (the same steps in two packages):
    parameters and EMA within 1e-5 relative L2, the accumulated gradients
    within 1e-4."""
    state = accum_run.port_states[mini_steps]
    path = str(tmp_path / "port")
    ttrain.save_train_state_orbax(path, state)
    restored = jtrain.load_train_state_orbax(path, accum_run.template())
    _assert_leaves_equal(_jax_leaves(restored), _port_leaves(state))
    want, got = _jax_leaves(accum_run.jax_states[mini_steps]), _port_leaves(state)
    for group, limit in (("params.", 1e-5), ("ema_params.", 1e-5),
                         ("opt_state.acc_grads.", 1e-4)):
        keys = [k for k in want if k.startswith(group)]
        a = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in keys])
        b = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in keys])
        assert np.linalg.norm(a - b) <= limit * max(np.linalg.norm(b), 1e-30), group


def _params_rel(got, want, unet):
    keys = [k for k in want if k.startswith(f"params.unet_{unet}.")]
    a = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in keys])
    b = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in keys])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mini_steps", [1, 2])
def test_each_package_resumes_the_others_accumulation_state(accum_run, tmp_path, mini_steps,
                                                            writer):
    """One package writes its state after `mini_steps`; the other restores
    that write and takes one step, and the writer takes the same step from
    its own state: both stage losses and every U-Net's parameters within
    1e-6 relative (float32; the two steps start from the same bits, so
    only the packages' arithmetic differs). After one mini-step this step
    makes the update from the restored ``acc_grads``; after two it starts a
    new round."""
    path = str(tmp_path / writer)
    imagen = _cascade(dict(FIXTURE_SPEC, seed=7))
    state = ttrain.create_train_state(imagen, accum_run.port_optimizer(), ema=True)
    if writer == "jax":
        jtrain.save_train_state_orbax(path, accum_run.jax_states[mini_steps])
        ttrain.load_train_state_orbax(path, state)
        jstate = accum_run.jax_states[mini_steps]
    else:
        ttrain.save_train_state_orbax(path, accum_run.port_states[mini_steps])
        jstate = jtrain.load_train_state_orbax(path, accum_run.template())
        _copy_state(accum_run.port_states[mini_steps], state)
    state, tlosses = accum_run.port_step(state, imagen)
    jstate, jlosses = accum_run.jax_step(jstate)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-6)
    assert state.opt_state.mini_step == int(jstate.opt_state.mini_step) == (mini_steps + 1) % 2
    got, want = _port_leaves(state), _jax_leaves(jstate)
    for i in range(len(imagen.unets)):
        assert _params_rel(got, want, i) <= 1e-6


def test_orbax_format_imports_neither_jax_nor_orbax():
    tree = ast.parse(open(of.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert not names & {"jax", "flax", "orbax", "tensorstore", "zstandard", "minimagen_tpu"}
    assert names <= {"json", "os", "struct", "time", "uuid", "typing", "numpy",
                     "torch", "__future__"}


def time_lite_restore(directory: str) -> dict:
    """The lite cascade's full train state as a JAX run leaves it: float32
    master parameters and EMA (the committed bf16 weights with seeded
    noise below bf16's precision, as a trained float32 master has), a bf16
    first moment and a float32 second moment from a seeded generator.
    The JAX package writes it into `directory` with Orbax (zstd chunks);
    the port's ``load_train_state_orbax`` restores it on the CPU, timed."""
    import tempfile
    import time

    from minimagen_tpu_torch.generate import load_lite

    imagen = load_lite(device="cpu", param_dtype=torch.float32)
    state = ttrain.create_train_state(imagen, ttrain.make_optimizer(1e-4, 1, torch.bfloat16),
                                      ema=True)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p, e in zip(state.params, state.ema_params):
            p.mul_(1 + 1e-3 * torch.randn(p.shape, generator=gen))
            e.copy_(p * (1 + 1e-3 * torch.randn(p.shape, generator=gen)))
        for m, v in zip(state.opt_state.mu, state.opt_state.nu):
            g = 1e-3 * torch.randn(m.shape, generator=gen)
            m.copy_(g)
            v.copy_(g * g)
    state.step = state.opt_state.count = 1000
    with tempfile.TemporaryDirectory() as tmp:
        jstate = _jax_state(imagen, state, tmp)
    shutil.rmtree(directory, ignore_errors=True)
    jtrain.save_train_state_orbax(directory, jstate)
    del jstate
    nbytes = sum(t.numel() * t.element_size() for t in
                 [*state.params, *state.opt_state.mu, *state.opt_state.nu, *state.ema_params])
    on_disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(directory)
                  for f in fs)
    dst = ttrain.create_train_state(load_lite(device="cpu", param_dtype=torch.float32),
                                    ttrain.make_optimizer(1e-4, 1, torch.bfloat16), ema=True)
    t0 = time.perf_counter()
    ttrain.load_train_state_orbax(directory, dst)
    seconds = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for xs, ys in (
        (state.params, dst.params), (state.opt_state.mu, dst.opt_state.mu),
        (state.opt_state.nu, dst.opt_state.nu), (state.ema_params, dst.ema_params))
        for a, b in zip(xs, ys))
    return dict(gb=nbytes / 1e9, gb_on_disk=on_disk / 1e9, seconds=seconds,
                mb_s=nbytes / 1e6 / seconds, equal_bits=equal)


if __name__ == "__main__" and sys.argv[1:] == ["--write-fixture"]:
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
elif __name__ == "__main__" and sys.argv[1:2] == ["--time-lite-restore"]:
    # JAX_PLATFORMS=cpu python tests/test_torch_orbax.py --time-lite-restore DIR
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(time_lite_restore(sys.argv[2])))
