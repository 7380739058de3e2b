"""Frozen T5 text encoder (counterpart of ``minimagen_tpu/models/t5.py``).

The registry and ``WordTokenizer`` are copied from the JAX package. The
encoder itself is this package's own PyTorch T5 encoder stack, numerically
the HuggingFace Flax ``T5EncoderModel`` the JAX package runs: token
embedding, per layer an RMS-normed self-attention (no 1/sqrt(d) scaling, a
bucketed bidirectional relative-position bias computed in layer 0 and shared
by every layer) and an RMS-normed ReLU feed-forward, then a final RMS norm.
Its weights are read from the committed ``flax_model.msgpack`` by the port's
own msgpack reader (``checkpoint.py``). Only ``local:`` registry entries (the
committed ``t5_tiny``) are loaded as T5 encoders: the others need a download,
and for them :class:`TextEncoder` takes the JAX package's own offline
behaviour, its deterministic hash encoder (:func:`_fallback_encode`, copied
from ``minimagen_tpu/models/t5.py:176-199``), warning once per name as it
does. Its encodings have the real encoder's shapes and masks, not its
meaning.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MAX_LENGTH = 256

DEFAULT_T5_NAME = "t5_small"

# name -> handle / encoding dim / approx size in GB (copied from the JAX package)
T5_VERSIONS = {
    "t5_small": {"handle": "t5-small", "dim": 512, "size": 0.24},
    "t5_base": {"handle": "t5-base", "dim": 768, "size": 0.890},
    "t5_large": {"handle": "t5-large", "dim": 1024, "size": 2.75},
    "t5_3b": {"handle": "t5-3b", "dim": 1024, "size": 10.6},
    "t5_11b": {"handle": "t5-11b", "dim": 1024, "size": 42.1},
    "small1.1": {"handle": "google/t5-v1_1-small", "dim": 512, "size": 0.3},
    "base1.1": {"handle": "google/t5-v1_1-base", "dim": 768, "size": 0.99},
    "large1.1": {"handle": "google/t5-v1_1-large", "dim": 1024, "size": 3.13},
    "xl1.1": {"handle": "google/t5-v1_1-xl", "dim": 2048, "size": 11.4},
    "xxl1.1": {"handle": "google/t5-v1_1-xxl", "dim": 4096, "size": 44.5},
    "t5_tiny": {"handle": "local:assets/t5_tiny", "dim": 64, "size": 0.001},
}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


_FALLBACK_WARNED = set()


def get_encoded_dim(name: str) -> int:
    """Encoding dimensionality of a T5 variant."""
    return T5_VERSIONS[name]["dim"]


def _hash_token_embedding(token: str, dim: int) -> np.ndarray:
    """Stable pseudo-embedding of a token: a standard normal vector seeded by
    a sha256 of the token text."""
    digest = hashlib.sha256(token.encode("utf-8")).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    return rng.standard_normal(dim).astype(np.float32)


def _fallback_encode(texts: List[str], name: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """The hash encoder: per word, its embedding plus 0.1 of its position's,
    over sqrt(1.01); (encodings (b, L, dim) float32, mask (b, L) bool), L the
    longest caption's word count (at least 1) after truncation."""
    dim = get_encoded_dim(name)
    tokenized = [t.lower().split()[:max_length] for t in texts]
    longest = max(max((len(t) for t in tokenized), default=1), 1)
    enc = np.zeros((len(texts), longest, dim), dtype=np.float32)
    mask = np.zeros((len(texts), longest), dtype=bool)
    for i, toks in enumerate(tokenized):
        for j, tok in enumerate(toks):
            emb = _hash_token_embedding(tok, dim)
            pos = _hash_token_embedding(f"<pos{j}>", dim)
            enc[i, j] = (emb + 0.1 * pos) / np.sqrt(1.01)
            mask[i, j] = True
    return enc, mask


class WordTokenizer:
    """Deterministic word-level tokenizer of the committed tiny T5 (copied
    from the JAX package byte for byte): sha256-hashed word ids, pad 0, EOS 1
    appended, truncation to `max_length` (which drops the EOS of a long
    caption), longest padding."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _ids(self, text: str, max_length: int) -> List[int]:
        ids = []
        for w in text.lower().split():
            digest = hashlib.sha256(w.encode("utf-8")).digest()
            ids.append(int.from_bytes(digest[:4], "little") % (self.vocab_size - 2) + 2)
        ids.append(1)
        return ids[:max_length]

    def encode(self, texts: List[str], max_length: int = MAX_LENGTH) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), both (b, longest) int32."""
        ids = [self._ids(t, max_length) for t in texts]
        longest = max((len(i) for i in ids), default=1)
        input_ids = np.zeros((len(ids), longest), dtype=np.int32)
        attention_mask = np.zeros((len(ids), longest), dtype=np.int32)
        for row, seq in enumerate(ids):
            input_ids[row, : len(seq)] = seq
            attention_mask[row, : len(seq)] = 1
        return input_ids, attention_mask


class T5LayerNorm(nn.Module):
    """RMS norm without bias or mean subtraction, statistics in float32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.float().pow(2).mean(dim=-1, keepdim=True)
        return self.weight * (x / torch.sqrt(variance + self.eps))


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucket of `memory - query` positions (float32 math,
    truncated to int as the Flax encoder does)."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_f = rel.float()
    large = max_exact + (torch.log(rel_f / max_exact)
                         / torch.log(torch.tensor(max_distance / max_exact))
                         * (num_buckets - max_exact))
    large = large.clamp(max=num_buckets - 1)
    return (buckets + torch.where(is_small, rel_f, large)).long()


class T5Attention(nn.Module):
    def __init__(self, cfg: dict, has_relative_bias: bool):
        super().__init__()
        self.heads, self.d_kv = cfg["num_heads"], cfg["d_kv"]
        self.num_buckets = cfg["relative_attention_num_buckets"]
        self.max_distance = cfg["relative_attention_max_distance"]
        inner = self.heads * self.d_kv
        self.q = nn.Linear(cfg["d_model"], inner, bias=False)
        self.k = nn.Linear(cfg["d_model"], inner, bias=False)
        self.v = nn.Linear(cfg["d_model"], inner, bias=False)
        self.o = nn.Linear(inner, cfg["d_model"], bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(self.num_buckets, self.heads)

    def compute_bias(self, length: int, device) -> torch.Tensor:
        pos = torch.arange(length, device=device)
        bucket = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                          self.max_distance)
        return self.relative_attention_bias(bucket).permute(2, 0, 1)[None]  # (1, h, q, k)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        split = lambda t: t.reshape(b, n, self.heads, self.d_kv).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) + position_bias
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.o(out)


class T5Block(nn.Module):
    def __init__(self, cfg: dict, has_relative_bias: bool):
        super().__init__()
        eps = cfg["layer_norm_epsilon"]
        self.attn_norm = T5LayerNorm(cfg["d_model"], eps)
        self.attention = T5Attention(cfg, has_relative_bias)
        self.ff_norm = T5LayerNorm(cfg["d_model"], eps)
        self.wi = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wo = nn.Linear(cfg["d_ff"], cfg["d_model"], bias=False)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.attn_norm(x), position_bias)
        return x + self.wo(F.relu(self.wi(self.ff_norm(x))))


class T5Encoder(nn.Module):
    """T5 encoder stack from a HuggingFace ``config.json`` dict (ReLU
    feed-forward variant, as the committed ``t5_tiny`` uses)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg.get("feed_forward_proj", "relu") != "relu" or cfg.get("is_gated_act", False):
            raise ValueError("only the ReLU (non-gated) T5 feed-forward is ported")
        self.config = cfg
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg["num_layers"]))
        self.final_layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Last hidden state (b, L, d_model), padded rows zeroed."""
        x = self.shared(input_ids.long())
        n = input_ids.shape[1]
        mask_bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0,
                                torch.finfo(torch.float32).min)
        position_bias = self.block[0].attention.compute_bias(n, x.device) + mask_bias
        for layer in self.block:
            x = layer(x, position_bias)
        x = self.final_layer_norm(x)
        return x * attention_mask[..., None].to(x.dtype)

    def load_flax_params(self, tree: dict) -> None:
        """Load a HuggingFace Flax T5 parameter tree (nested dict of numpy
        arrays, as ``checkpoint.msgpack_restore`` returns it)."""
        enc = tree["encoder"]
        dense = lambda a: torch.as_tensor(np.asarray(a, np.float32)).T  # noqa: E731
        sd = {"shared.weight": torch.as_tensor(np.asarray(tree["shared"]["embedding"], np.float32)),
              "final_layer_norm.weight": torch.as_tensor(
                  np.asarray(enc["final_layer_norm"]["weight"], np.float32))}
        for i in range(len(self.block)):
            att, ff = enc["block"][str(i)]["layer"]["0"], enc["block"][str(i)]["layer"]["1"]
            p = f"block.{i}."
            sd[p + "attn_norm.weight"] = torch.as_tensor(np.asarray(att["layer_norm"]["weight"], np.float32))
            for name in ("q", "k", "v", "o"):
                sd[p + f"attention.{name}.weight"] = dense(att["SelfAttention"][name]["kernel"])
            if "relative_attention_bias" in att["SelfAttention"]:
                sd[p + "attention.relative_attention_bias.weight"] = torch.as_tensor(np.asarray(
                    att["SelfAttention"]["relative_attention_bias"]["embedding"], np.float32))
            sd[p + "ff_norm.weight"] = torch.as_tensor(np.asarray(ff["layer_norm"]["weight"], np.float32))
            sd[p + "wi.weight"] = dense(ff["DenseReluDense"]["wi"]["kernel"])
            sd[p + "wo.weight"] = dense(ff["DenseReluDense"]["wo"]["kernel"])
        self.load_state_dict(sd, strict=True)


class TextEncoder:
    """A tokenizer and a T5 encoder on one device; for a registry name that
    is not ``local:`` (its weights need a download), the hash encoder."""

    def __init__(self, name: str = "t5_tiny", device="cuda"):
        from ..checkpoint import read_msgpack  # noqa: PLC0415 (checkpoint imports models)

        self.name, self.device = name, torch.device(device)
        handle = T5_VERSIONS[name]["handle"]
        self.model = None
        if not handle.startswith("local:"):
            if name not in _FALLBACK_WARNED:
                _FALLBACK_WARNED.add(name)
                warnings.warn(f"T5 checkpoint '{handle}' is not in the repository: using the "
                              "deterministic hash text encoder. Shapes and masks match the real "
                              "encoder; semantic quality does not.", stacklevel=2)
            return
        path = os.path.join(REPO_ROOT, handle[len("local:"):])
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        self.tokenizer = WordTokenizer(cfg["vocab_size"])
        self.model = T5Encoder(cfg)
        self.model.load_flax_params(read_msgpack(os.path.join(path, "flax_model.msgpack")))
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def encode(self, texts: List[str], max_length: int = MAX_LENGTH) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encodings (b, L, dim) float32 with padded rows zeroed, mask (b, L) bool)."""
        if self.model is None:
            enc, mask = _fallback_encode(texts, self.name, max_length)
            return (torch.as_tensor(enc, device=self.device),
                    torch.as_tensor(mask, device=self.device))
        ids, mask = self.tokenizer.encode(texts, max_length)
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        return self.model(ids, mask).float(), mask.bool()


_ENCODERS = {}


def t5_encode_text(text: List[str], name: str = "t5_base", max_length: int = MAX_LENGTH,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode captions (the reference's ``t5_encode_text``, t5.py:31-84):
    (encodings (b, L, dim) float32 with padded rows zeroed, mask (b, L)
    bool) on `device`, by the committed local encoder of registry name
    `name` or, for a name whose weights need a download, the hash encoder
    (:class:`TextEncoder`; nothing is downloaded). The encoder is built once
    per name and device."""
    key = (name, str(torch.device(device)))
    if key not in _ENCODERS:
        _ENCODERS[key] = TextEncoder(name, device)
    return _ENCODERS[key].encode(list(text), max_length)
