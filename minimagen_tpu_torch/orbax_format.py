"""Read and write the Orbax checkpoints of the JAX package without Orbax.

``minimagen_tpu.training.save_train_state_orbax`` writes a train state with
``orbax.checkpoint.StandardCheckpointer``: a directory of JSON metadata and
an OCDBT key-value database (tensorstore's "optionally-cooperative
distributed B+tree") whose values are zarr v2 arrays compressed with zstd.
The card's machine has none of orbax, tensorstore or a zstd library, so this
module reads and writes that layout itself, in Python with numpy and one
host C file:

- :func:`zstd_decompress`, zstd (RFC 8878: frames, skippable frames, Raw /
  RLE / Compressed blocks, Huffman-coded literals in 1 or 4 streams and
  treeless ones, FSE-coded sequences in predefined, RLE, compressed and
  repeat modes, each frame's XXH64 content checksum verified) decoded by
  the host C decoder ``host/zstd_decode.c``, or with ``plain=True`` by this
  module's Python + numpy decoder, its plain version; and
  :func:`zstd_frame_raw`, a valid frame of Raw blocks for the writer;
- :class:`OcdbtReader`, which lists every key of a database and returns each
  value, and :func:`write_ocdbt`, which writes one database with one
  process's sub-database as Orbax lays it out;
- :func:`read_zarr` and :func:`zarr_items`, one zarr v2 array read from (or
  written as) such keys: ``<name>/.zarray`` and its chunks ``<name>/i.j...``;
- :func:`read_checkpoint` and :func:`write_checkpoint`, a whole checkpoint
  directory: ``_METADATA``'s tree paths, each leaf a CPU tensor.

The format was read from dumps that orbax-checkpoint 0.11.32 and
tensorstore 0.1.80 wrote (zarr v2 arrays, OCDBT "single" manifests):

- Every OCDBT manifest and B-tree node file starts with a magic number
  (0x0cdb3a2a for a manifest, 0x0cdb20de for a node; big-endian), the
  file's length (uint64 little-endian), a format version (varint, 0) and a
  compression code (varint: 0 none, 1 zstd), and ends in the CRC-32C of all
  the bytes before it. Value data files (``d/<32 hex>``) are bare
  concatenations of values.
- A manifest holds the config (uuid, manifest kind, the largest inline
  value, the largest decoded node, the version tree's arity, the node
  compression), a data file table and the latest versions: generation,
  the B-tree root's height and (file, offset, length), key and byte counts,
  commit time.
- A B-tree node holds its height, a data file table and its entries, each
  array of fields stored column by column: keys prefix-compressed against
  the previous entry; a leaf's values inline or by (file, offset, length);
  an interior node's children by (file, offset, length) with the length of
  the key prefix its whole subtree shares, which the child's keys omit.
- A data file table names each file by a path relative to the database's
  directory, prefix-compressed against the previous path, with the length
  of its base directory (``ocdbt.process_0/`` where the root database
  refers to its process's values).

Orbax merges the process databases into the root one when it finalises a
checkpoint; the reader follows the root manifest alone.
"""
from __future__ import annotations

import json
import os
import struct
import time
import uuid as _uuid
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .host import zstd as _host_zstd
from .host.zstd import ZstdError

# --------------------------------------------------------------------------- #
# zstd (RFC 8878)                                                             #
# --------------------------------------------------------------------------- #
ZSTD_MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 * 1024

# predefined FSE distributions and the codes' baselines and extra bits (RFC 8878 3.1.1.3.2)
_LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1)
_ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2) + (1,) * 37 + (-1,) * 7
_OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2) + (1,) * 15 + (-1,) * 5
_LL_BASE = tuple(range(16)) + (16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                               4096, 8192, 16384, 32768, 65536)
_LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
_ML_BASE = tuple(range(3, 35)) + (35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                  2051, 4099, 8195, 16387, 32771, 65539)
_ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)


_M64 = (1 << 64) - 1
_XXH_P1, _XXH_P2, _XXH_P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_XXH_P4, _XXH_P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh_round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _XXH_P2) & _M64, 31) * _XXH_P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of `data` in Python (the plain decoder's checksum)."""
    data = bytes(data)
    n = len(data)
    stripes = n // 32
    lanes = np.frombuffer(data, "<u8", count=n // 8).tolist()
    if stripes:
        v = [(seed + _XXH_P1 + _XXH_P2) & _M64, (seed + _XXH_P2) & _M64, seed & _M64,
             (seed - _XXH_P1) & _M64]
        for i in range(0, 4 * stripes, 4):
            v[0] = _xxh_round(v[0], lanes[i])
            v[1] = _xxh_round(v[1], lanes[i + 1])
            v[2] = _xxh_round(v[2], lanes[i + 2])
            v[3] = _xxh_round(v[3], lanes[i + 3])
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _xxh_round(0, x)) * _XXH_P1 + _XXH_P4) & _M64
    else:
        h = (seed + _XXH_P5) & _M64
    h = (h + n) & _M64
    for lane in lanes[4 * stripes:]:
        h = (_rotl(h ^ _xxh_round(0, lane), 27) * _XXH_P1 + _XXH_P4) & _M64
    p = 8 * (n // 8)
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _XXH_P1 & _M64), 23)
             * _XXH_P2 + _XXH_P3) & _M64
        p += 4
    for b in data[p:]:
        h = _rotl(h ^ (b * _XXH_P5 & _M64), 11) * _XXH_P1 & _M64
    h ^= h >> 33
    h = h * _XXH_P2 & _M64
    h ^= h >> 29
    h = h * _XXH_P3 & _M64
    return h ^ (h >> 32)


class _BackwardBits:
    """A backward bit stream (Huffman streams, FSE bit streams): read from
    the highest set bit of the last byte (a marker) down to bit 0 of the
    first; each read takes the next bits as an integer, its first bit the
    most significant. Bits past the start read as zeros."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a bit stream ends in a zero byte")
        self.data = bytes(7) + bytes(data)  # 7 zero bytes below bit 0
        self.pos = 8 * len(data) - 9 + data[-1].bit_length() + 56

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        b = p >> 3
        return (int.from_bytes(self.data[b:b + 8], "little") >> (p & 7)) & ((1 << n) - 1)

    def overflowed(self) -> bool:
        return self.pos < 56

    def done(self) -> bool:
        return self.pos == 56


class _ForwardBits:
    """A forward, little-endian bit stream (FSE table descriptions)."""

    __slots__ = ("data", "start", "bit")

    def __init__(self, data, start: int):
        self.data, self.start, self.bit = data, start, 0

    def peek(self, n: int) -> int:
        b = self.start + (self.bit >> 3)
        return (int.from_bytes(bytes(self.data[b:b + 8]).ljust(8, b"\0"), "little")
                >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n

    def end(self) -> int:
        """The offset of the first byte after the bits read."""
        return self.start + (self.bit + 7) // 8


def _fse_counts(data, start: int, max_log: int, max_symbol: int) -> Tuple[List[int], int, int]:
    """An FSE table description at `start`: the normalised counts (-1 for a
    "less than 1" probability), the accuracy log and the offset after it."""
    bits = _ForwardBits(data, start)
    log = bits.peek(4) + 5
    bits.skip(4)
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    previous_zero = False
    while remaining > 1:
        if previous_zero:
            while True:  # 2-bit repeat flags: more zero counts
                flag = bits.peek(2)
                bits.skip(2)
                counts.extend([0] * flag)
                if flag != 3:
                    break
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description names too many symbols")
        mx = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < mx:
            value = low
            bits.skip(nbits - 1)
        else:
            value = bits.peek(nbits)
            if value >= threshold:
                value -= mx
            bits.skip(nbits)
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        previous_zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, bits.end()


def _fse_table(counts: Sequence[int], log: int) -> Tuple[List[int], List[int], List[int]]:
    """The FSE decoding table of `counts` at accuracy `log`: per state its
    symbol, bits to read and base of the next state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("corrupt FSE distribution")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        nbits[u], base[u] = nb, (state << nb) - size
    return symbol, nbits, base


def _rle_table(sym: int) -> Tuple[List[int], List[int], List[int]]:
    return [sym], [0], [0]


_PREDEFINED = {"ll": _fse_table(_LL_DEFAULT, 6) + (6,), "of": _fse_table(_OF_DEFAULT, 5) + (5,),
               "ml": _fse_table(_ML_DEFAULT, 6) + (6,)}


def _huffman_weights(data, pos: int) -> Tuple[List[int], int]:
    """A Huffman tree description at `pos`: the weights of the symbols it
    lists (the last one's deduced later) and the offset after it."""
    head = data[pos]
    pos += 1
    if head >= 128:  # direct: 4 bits a weight
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + (n + 1) // 2
    end = pos + head  # FSE-compressed weights: two interleaved states
    counts, log, start = _fse_counts(data, pos, 6, 255)
    symbol, nbits, base = _fse_table(counts, log)
    bits = _BackwardBits(bytes(data[start:end]))
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    while True:
        weights.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.overflowed():
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.overflowed():
            weights.append(symbol[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return weights, end


def _huffman_table(weights: List[int]) -> Tuple[int, np.ndarray, np.ndarray]:
    """(max bits, symbol per code prefix, bits per code prefix) of the
    weights listed, the last symbol's weight deduced."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("a Huffman table without weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("corrupt Huffman weights")
    weights = list(weights) + [rest.bit_length()]
    size = 1 << max_bits
    syms, nbits = np.zeros(size, np.uint8), np.zeros(size, np.intp)
    pos = 0
    for w in range(1, max(weights) + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[pos:pos + n], nbits[pos:pos + n] = s, max_bits + 1 - w
                pos += n
    return max_bits, syms, nbits


_HOP = 16  # symbols a step of the Huffman decode's walk skips
_SMALL_STREAM = 4096  # streams of at most this many symbols are decoded symbol by symbol


def _huffman_stream_small(data: bytes, count: int, top: int, max_bits: int, syms, nbits) -> bytes:
    """:func:`_huffman_stream` one symbol at a time, for short streams."""
    x = int.from_bytes(data, "little") << max_bits  # max_bits zero bits below the start
    mask, sym_l, nb_l = (1 << max_bits) - 1, syms.tolist(), nbits.tolist()
    out = bytearray(count)
    p = top
    for i in range(count):
        v = (x >> p) & mask
        out[i] = sym_l[v]
        p -= nb_l[v]
    if p != 0:
        raise ZstdError("a Huffman stream's bits do not add up")
    return bytes(out)


def _huffman_stream(data, count: int, table) -> bytes:
    """`count` symbols of one Huffman stream. Each bit position's code (the
    next `max_bits` bits below it) is looked up at once for all positions,
    giving the position after its symbol; the walk down the stream from its
    top then takes hops of _HOP symbols through that map composed with
    itself, and the positions between are filled in vectorised."""
    max_bits, syms, nbits = table
    a = np.frombuffer(bytes(data), np.uint8)
    if a.size == 0 or a[-1] == 0:
        raise ZstdError("a Huffman stream ends in a zero byte")
    if count == 0:
        return b""
    top = 8 * (a.size - 1) + int(a[-1]).bit_length() - 1
    if count <= _SMALL_STREAM:
        return _huffman_stream_small(a.tobytes(), count, top, max_bits, syms, nbits)
    # every array is indexed with np.take and intp indices, numpy's fastest gather
    padded = np.concatenate([np.zeros(2, np.uint8), a, np.zeros(3, np.uint8)]).astype(np.uint32)
    # the 24 bits from each byte of `padded` up, shifted by 0-7: the code
    # below bit position p sits at flat index p - max_bits + 16
    words = padded[:-2] | (padded[1:-1] << 8) | (padded[2:] << 16)
    grid = (words[:, None] >> np.arange(8, dtype=np.uint32)) & np.uint32((1 << max_bits) - 1)
    start = 16 - max_bits
    val = np.empty(top + 2, np.intp)
    val[:-1] = grid.reshape(-1)[start:start + top + 1]
    val[-1] = 0
    sink = top + 1  # where a code would run past the stream's start
    nxt = np.arange(top + 2, dtype=np.intp)
    nxt -= np.take(nbits, val)
    nxt[-1] = sink
    low = nxt[:max_bits]  # only a code below bit max_bits can run past the start
    low[low < 0] = sink
    hop = nxt
    for _ in range(_HOP.bit_length() - 1):
        hop = np.take(hop, hop)
    rows = -(-count // _HOP)
    pos = np.empty((_HOP, rows), np.intp)
    starts = [0] * rows
    p = top
    for i in range(rows):
        starts[i] = p
        p = hop.item(p)
    pos[0] = starts
    for r in range(1, _HOP):
        np.take(nxt, pos[r - 1], out=pos[r])
    pos = pos.T.reshape(-1)[:count]
    if nxt[pos[-1]] != 0 or pos[-1] == sink:
        raise ZstdError("a Huffman stream's bits do not add up")
    return np.take(syms, np.take(val, pos)).tobytes()


def _literals(data, pos: int, state: dict) -> Tuple[bytes, int]:
    """A compressed block's literals section at `pos`: the literals and the
    offset after the section."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            lit = bytes(data[pos:pos + size])
            if len(lit) != size:
                raise ZstdError("raw literals run past the block")
            return lit, pos + size
        return bytes([data[pos]]) * size, pos + 1
    if fmt in (0, 1):
        h = int.from_bytes(bytes(data[pos:pos + 3]), "little")
        regen, comp, pos = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF, pos + 3
    elif fmt == 2:
        h = int.from_bytes(bytes(data[pos:pos + 4]), "little")
        regen, comp, pos = (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF, pos + 4
    else:
        h = int.from_bytes(bytes(data[pos:pos + 5]), "little")
        regen, comp, pos = (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF, pos + 5
    end = pos + comp
    if kind == 2:
        weights, pos = _huffman_weights(data, pos)
        state["huffman"] = _huffman_table(weights)
    elif state.get("huffman") is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    table = state["huffman"]
    if fmt == 0:  # one stream
        return _huffman_stream(data[pos:end], regen, table), end
    sizes = struct.unpack("<3H", bytes(data[pos:pos + 6]))
    pos += 6
    each = (regen + 3) // 4
    parts = []
    for i in range(4):
        size = sizes[i] if i < 3 else end - pos
        if size <= 0:
            raise ZstdError("corrupt jump table")
        parts.append(_huffman_stream(data[pos:pos + size], each if i < 3 else regen - 3 * each,
                                     table))
        pos += size
    return b"".join(parts), end


def _seq_table(data, pos: int, mode: int, name: str, max_log: int, max_symbol: int,
               state: dict) -> int:
    if mode == 0:
        state[name] = _PREDEFINED[name]
    elif mode == 1:
        state[name] = _rle_table(data[pos]) + (0,)
        pos += 1
    elif mode == 2:
        counts, log, pos = _fse_counts(data, pos, max_log, max_symbol)
        state[name] = _fse_table(counts, log) + (log,)
    elif state.get(name) is None:
        raise ZstdError(f"repeat mode for {name} without an earlier table")
    return pos


def _sequences(data, pos: int, end: int, state: dict) -> List[Tuple[int, int, int]]:
    """The (literal length, match length, offset) of a block's sequences."""
    b0 = data[pos]
    if b0 == 0:
        return []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequences' modes")
    pos = _seq_table(data, pos, modes >> 6, "ll", 9, 35, state)
    pos = _seq_table(data, pos, (modes >> 4) & 3, "of", 8, 31, state)
    pos = _seq_table(data, pos, (modes >> 2) & 3, "ml", 9, 52, state)
    (ll_sym, ll_nb, ll_base, ll_log), (of_sym, of_nb, of_base, of_log), \
        (ml_sym, ml_nb, ml_base, ml_log) = state["ll"], state["of"], state["ml"]
    bits = _BackwardBits(bytes(data[pos:end]))
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    reps = state["reps"]
    out = []
    for i in range(n):
        of_code, ll_code, ml_code = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if of_code > 31:
            raise ZstdError("offset code above 31")
        ov = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ov > 3:
            off = ov - 3
            reps = [off, reps[0], reps[1]]
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                off = reps[0]
            elif idx == 1:
                off = reps[1]
                reps = [off, reps[0], reps[2]]
            elif idx == 2:
                off = reps[2]
                reps = [off, reps[0], reps[1]]
            else:
                off = reps[0] - 1
                if off == 0:
                    raise ZstdError("a repeat offset of 0")
                reps = [off, reps[0], reps[1]]
        out.append((ll, ml, off))
        if i + 1 < n:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if not bits.done():
        raise ZstdError("the sequences' bit stream does not add up")
    state["reps"] = reps
    return out


def _execute(out: bytearray, literals: bytes, seqs: List[Tuple[int, int, int]]) -> None:
    """Append the block's literals and matches to the frame's output."""
    lit = 0
    for ll, ml, off in seqs:
        if ll:
            out += literals[lit:lit + ll]
            lit += ll
        start = len(out) - off
        if start < 0:
            raise ZstdError("a match reaches before the frame's start")
        if off >= ml:
            out += out[start:start + ml]
        else:  # overlapping: the last `off` bytes repeated
            reps, tail = divmod(ml, off)
            chunk = out[start:]
            out += chunk * reps + chunk[:tail]
    if lit > len(literals):
        raise ZstdError("sequences use more literals than the block holds")
    out += literals[lit:]


def _frame(data, pos: int) -> Tuple[bytes, int]:
    """Decode the frame at `pos` (after its magic number); returns its
    content and the offset after the frame."""
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in a frame header")
    if not single:
        pos += 1  # window descriptor: the whole frame is kept, so unused
    dict_size = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(bytes(data[pos:pos + dict_size]), "little")
    pos += dict_size
    if dict_id:
        raise ZstdError(f"frame needs dictionary {dict_id}: dictionaries are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(bytes(data[pos:pos + fcs_size]), "little")
        content_size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    out = bytearray()
    state = {"reps": [1, 4, 8], "huffman": None, "ll": None, "of": None, "ml": None}
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if size > _BLOCK_MAX or pos + size > len(data):
                raise ZstdError("compressed block too large or truncated")
            end = pos + size
            literals, p = _literals(data, pos, state)
            _execute(out, literals, _sequences(data, p, end, state))
            pos = end
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame holds {len(out)} bytes, its header says {content_size}")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("truncated content checksum")
        if xxh64(out) & 0xFFFFFFFF != int.from_bytes(bytes(data[pos:pos + 4]), "little"):
            raise ZstdError("the frame's XXH64 content checksum does not match its content")
        pos += 4
    return bytes(out), pos


def zstd_decompress(data, size: Optional[int] = None, *,
                    plain: bool = False) -> Union[bytes, bytearray]:
    """The content of zstd `data`: one or more frames, skippable frames
    skipped, each frame's content checksum verified. The host C decoder
    (``host/zstd.py``; `size`, the content's length where known, sizes its
    output) decodes it; ``plain=True`` takes this module's Python decoder
    instead."""
    if not plain:
        return _host_zstd.decompress(data, size)
    data = memoryview(bytes(data)) if not isinstance(data, (bytes, bytearray)) else data
    parts, pos = [], 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(bytes(data[pos:pos + 4]), "little")
        pos += 4
        if 0x184D2A50 <= magic <= 0x184D2A5F:
            pos += 4 + int.from_bytes(bytes(data[pos:pos + 4]), "little")
            continue
        if magic != ZSTD_MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        content, pos = _frame(data, pos)
        parts.append(content)
    return b"".join(parts)


def zstd_frame_raw(data, checksum: bool = False) -> bytes:
    """`data` as one zstd frame of Raw blocks (at most 128 KiB each), with
    its content size and, where `checksum`, the XXH64 content checksum
    (the host decoder's XXH64)."""
    data = bytes(data)
    n = len(data)
    flag = 4 if checksum else 0
    if n < 256:
        header = bytes([0x20 | flag, n])  # single segment, 1-byte content size
    elif n < 65536 + 256:
        header = bytes([0x60 | flag]) + (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        header = bytes([0xA0 | flag]) + n.to_bytes(4, "little")
    else:
        header = bytes([0xE0 | flag]) + n.to_bytes(8, "little")
    parts = [ZSTD_MAGIC.to_bytes(4, "little"), header]
    for start in range(0, max(n, 1), _BLOCK_MAX):
        size = min(_BLOCK_MAX, n - start)
        last = start + _BLOCK_MAX >= n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(data[start:start + size])
    if checksum:
        parts.append((_host_zstd.xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    return b"".join(parts)


# --------------------------------------------------------------------------- #
# OCDBT                                                                       #
# --------------------------------------------------------------------------- #
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
PROCESS_DIR = "ocdbt.process_0"  # the sub-database of process 0
MAX_INLINE_VALUE_BYTES = 1024  # Orbax's OCDBT config (tensorstore_utils.add_ocdbt_write_options)
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_NO_ROOT = (1 << 64) - 1  # a version's root offset/length where its tree is empty


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`, the checksum closing every OCDBT
    manifest and node."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Cursor:
    """Reads varints, bytes and fixed-width fields from a decoded body."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError("OCDBT: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("OCDBT: truncated field")
        self.pos += n
        return bytes(out)

    def byte(self) -> int:
        return self.take(1)[0]


def _decode_file(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node: header checked, checksum checked,
    decompressed where the header says zstd."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"OCDBT: {what} has no {magic:#010x} magic number")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"OCDBT: {what}'s length field does not match its size")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"OCDBT: {what} fails its CRC-32C")
    c = _Cursor(raw, 12)
    version, compression = c.varint(), c.varint()
    if version != 0 or compression not in (0, 1):
        raise ValueError(f"OCDBT: {what} has format version {version}, compression {compression}")
    body = raw[c.pos:-4]
    return bytes(zstd_decompress(body)) if compression else body


def _encode_file(body: bytes, magic: int) -> bytes:
    """A manifest or node file of `body`, uncompressed."""
    head_tail = 4 + 8 + 2 + 4
    out = magic.to_bytes(4, "big") + (len(body) + head_tail).to_bytes(8, "little") + b"\0\0" + body
    return out + crc32c(out).to_bytes(4, "little")


def _read_file_table(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix, _base = c.varints(n), c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + c.take(suffix[i])
        paths.append(path.decode())
        prev = path
    return paths


def _file_table(paths: Sequence[str], base_lengths: Sequence[int]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = []
    for prev, cur in zip(enc, enc[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        prefix.append(k)
    suffix = [e[k:] for e, k in zip(enc, [0] + prefix)]
    return b"".join([_varint(len(enc)), *map(_varint, prefix), *(_varint(len(s)) for s in suffix),
                     *map(_varint, base_lengths), *suffix])


def _prefix_keys(c: _Cursor, n: int) -> Tuple[List[int], List[int]]:
    return [0] + c.varints(max(n - 1, 0)), c.varints(n)


class OcdbtReader:
    """The latest version of the OCDBT database in `directory`: its keys
    (bytes, in order) and values. Node and value files are read where the
    root manifest's tree names them (its own ``d/`` or a process
    sub-database's)."""

    def __init__(self, directory: str):
        self.directory = directory
        raw = open(os.path.join(directory, MANIFEST_FILE), "rb").read()
        c = _Cursor(_decode_file(raw, MANIFEST_MAGIC, MANIFEST_FILE))
        c.take(16)  # uuid
        if c.varint() != 0:
            raise ValueError("OCDBT: only single-file manifests are read (Orbax writes those)")
        c.varint()  # max inline value bytes
        c.varint()  # max decoded node bytes
        c.byte()  # version tree arity, log2
        if c.varint() == 1:
            c.take(4)  # zstd level, int32
        files = _read_file_table(c)
        n = c.varint()
        if n == 0:
            raise ValueError("OCDBT: the manifest lists no version")
        gen, height, file_id = c.varints(n), list(c.take(n)), c.varints(n)
        offset, length = c.varints(n), c.varints(n)
        last = max(range(n), key=gen.__getitem__)
        self.generation = gen[last]
        self._entries: Dict[bytes, Tuple] = {}
        if offset[last] != _NO_ROOT:
            self._walk(files[file_id[last]], offset[last], length[last], height[last], b"")

    def _read(self, path: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.directory, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} ends before {offset} + {length}")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        body = _decode_file(self._read(path, offset, length), NODE_MAGIC, f"node in {path}")
        c = _Cursor(body)
        if c.byte() != height:
            raise ValueError(f"OCDBT: node in {path} has another height than its parent says")
        files = _read_file_table(c)
        n = c.varint()
        key_prefix, key_suffix = _prefix_keys(c, n)
        if height:
            common = c.varints(n)
        keys, prev = [], b""
        for i in range(n):
            key = prev[:key_prefix[i]] + c.take(key_suffix[i])
            keys.append(key)
            prev = key
        if height:
            ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            for i, key in enumerate(keys):
                self._walk(files[ids[i]], offs[i], lens[i], height - 1,
                           prefix + key[:common[i]])
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i]]
        if any(k > 1 for k in kinds):
            raise ValueError(f"OCDBT: unknown value kind in {path}")
        ids, offs = c.varints(len(indirect)), c.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offs)))
        for i, key in enumerate(keys):
            if i in refs:
                fid, off = refs[i]
                self._entries[prefix + key] = (files[fid], off, lengths[i])
            else:
                self._entries[prefix + key] = (c.take(lengths[i]),)

    def keys(self) -> List[bytes]:
        return sorted(self._entries)

    def get(self, key) -> Optional[bytes]:
        entry = self._entries.get(key.encode() if isinstance(key, str) else key)
        if entry is None or len(entry) == 1:
            return None if entry is None else entry[0]
        return self._read(*entry)


def _leaf_node(items: Sequence[Tuple[bytes, bytes]], values_file: Optional[str],
               values_base: int, offsets: Dict[bytes, int]) -> Tuple[bytes, int]:
    """A B-tree leaf of sorted (key, value) `items`: values up to
    MAX_INLINE_VALUE_BYTES inline, the others at `offsets` in
    `values_file`. Returns the node file and the bytes held indirectly."""
    keys = [k for k, _ in items]
    prefix = []
    for prev, cur in zip(keys, keys[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        prefix.append(k)
    suffix = [key[k:] for key, k in zip(keys, [0] + prefix)]
    kinds = [int(len(v) > MAX_INLINE_VALUE_BYTES) for _, v in items]
    indirect = [k for (k, _), kind in zip(items, kinds) if kind]
    table = _file_table([values_file], [values_base]) if indirect else _varint(0)
    body = b"".join([b"\0", table, _varint(len(items)), *map(_varint, prefix),
                     *(_varint(len(s)) for s in suffix), *suffix,
                     *(_varint(len(v)) for _, v in items), *map(_varint, kinds),
                     *(_varint(0) for _ in indirect), *(_varint(offsets[k]) for k in indirect),
                     *(v for (_, v), kind in zip(items, kinds) if not kind)])
    return _encode_file(body, NODE_MAGIC), sum(len(v) for (_, v), kind in zip(items, kinds) if kind)


def _manifest(node_file: str, node_len: int, num_keys: int, indirect_bytes: int) -> bytes:
    """A single-file manifest of one version whose tree is one leaf node."""
    body = b"".join([_uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
                     _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]),
                     _varint(0),  # node compression: none
                     _file_table([node_file], [0]),
                     _varint(1), _varint(1), b"\0", _varint(0), _varint(0), _varint(node_len),
                     _varint(num_keys), _varint(node_len), _varint(indirect_bytes),
                     time.time_ns().to_bytes(8, "little"),
                     _varint(0)])  # no version tree nodes
    return _encode_file(body, MANIFEST_MAGIC)


def write_ocdbt(directory: str, items: Mapping[str, bytes]) -> None:
    """Write `items` (key -> value) as one OCDBT database in `directory`,
    laid out as Orbax leaves one written by process 0: the values above
    MAX_INLINE_VALUE_BYTES in one data file of the process sub-database
    ``ocdbt.process_0/``, which holds a version of its own, and the root
    database's tree referring to them there. Nodes and manifests are not
    compressed (the config says so); every tree is one leaf node."""
    pairs = sorted((k.encode(), bytes(v)) for k, v in items.items())
    proc = os.path.join(directory, PROCESS_DIR)
    for d in (os.path.join(directory, "d"), os.path.join(proc, "d")):
        os.makedirs(d, exist_ok=True)
    values_name = f"d/{_uuid.uuid4().hex}"
    offsets, pos = {}, 0
    with open(os.path.join(proc, values_name), "wb") as f:
        for k, v in pairs:
            if len(v) > MAX_INLINE_VALUE_BYTES:
                offsets[k] = pos
                f.write(v)
                pos += len(v)
    for root, values, base in ((proc, values_name, 0),
                               (directory, f"{PROCESS_DIR}/{values_name}", len(PROCESS_DIR) + 1)):
        node, indirect = _leaf_node(pairs, values, base, offsets)
        node_name = f"d/{_uuid.uuid4().hex}"
        with open(os.path.join(root, node_name), "wb") as f:
            f.write(node)
        with open(os.path.join(root, MANIFEST_FILE), "wb") as f:
            f.write(_manifest(node_name, len(node), len(pairs), indirect))


# --------------------------------------------------------------------------- #
# zarr v2 arrays                                                              #
# --------------------------------------------------------------------------- #
# the dtypes of a train state's arrays: float32 and bf16 leaves, int32 counters
_ZARR_DTYPES = {"<f4": np.float32, "<i4": np.int32, "bfloat16": np.uint16}
_TORCH_ZARR = {torch.float32: "<f4", torch.int32: "<i4", torch.bfloat16: "bfloat16"}


def read_zarr(store: OcdbtReader, name: str, *, plain: bool = False) -> torch.Tensor:
    """The zarr v2 array `name` of `store` as a CPU tensor: its chunks put
    together on the chunk grid, each decompressed by the ``compressor``
    named (``zstd`` or none; the host decoder, or the Python one where
    `plain`), missing chunks at ``fill_value``. A ``bfloat16`` array comes
    back as torch.bfloat16."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"no zarr array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C-order zarr v2 arrays without filters are read")
    dtype = np.dtype(_ZARR_DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    comp = (meta.get("compressor") or {}).get("id")
    if comp not in (None, "zstd"):
        raise ValueError(f"{name}: compressor {comp!r} is not read")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if meta["dtype"] == "bfloat16" and isinstance(fill, (int, float)) and fill:
        fill = int(np.float32(fill).view(np.uint32) >> 16)
    out = None
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.get(key)
        if data is None:
            continue
        if comp == "zstd":
            data = zstd_decompress(data, int(np.prod(chunks)) * dtype.itemsize, plain=plain)
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape and chunk.flags.writeable:
            out = chunk  # the one chunk is the whole array, in the decoder's own buffer
            continue
        if out is None:
            out = np.full(shape, 0 if fill is None else fill, dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        sl = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:
        out = np.full(shape, 0 if fill is None else fill, dtype)
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def zarr_items(name: str, t: torch.Tensor) -> Dict[str, bytes]:
    """The keys and values of `t` as zarr v2 array `name` as Orbax writes it
    (its ``.zarray``, one chunk: the whole array, in a zstd frame of Raw
    blocks)."""
    t = t.detach().cpu().contiguous()
    shape = list(t.shape)
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _TORCH_ZARR[t.dtype], "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    chunk = ".".join("0" for _ in shape) or "0"
    return {f"{name}/.zarray": json.dumps(meta, sort_keys=True, separators=(",", ":")).encode(),
            f"{name}/{chunk}": zstd_frame_raw(bits.numpy().tobytes())}


# --------------------------------------------------------------------------- #
# checkpoint directories                                                      #
# --------------------------------------------------------------------------- #
METADATA_FILE = "_METADATA"
CHECKPOINT_METADATA_FILE = "_CHECKPOINT_METADATA"
SEQUENCE_KEY, DICT_KEY = 1, 2  # key_type in _METADATA: a tuple index, a dict / field name
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], Optional[torch.Tensor]]


def read_checkpoint(directory: str, *, plain: bool = False) -> List[Leaf]:
    """Every leaf of the checkpoint in `directory`, in ``_METADATA``'s
    order: (keys, key types, CPU tensor), the tensor None where the tree
    holds no array (None, or an empty optimizer state). The arrays' zstd
    chunks go through the host decoder (its build failing raises), or the
    Python one where `plain`."""
    meta = json.load(open(os.path.join(directory, METADATA_FILE)))
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{directory}: only zarr v2 arrays in OCDBT are read (Orbax's default)")
    store = OcdbtReader(directory)
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        types = tuple(int(k["key_type"]) for k in entry["key_metadata"])
        value = entry["value_metadata"]
        skip = value.get("skip_deserialize") or value.get("value_type") == "None"
        leaves.append((keys, types,
                       None if skip else read_zarr(store, ".".join(keys), plain=plain)))
    return leaves


def write_checkpoint(directory: str, leaves: Iterable[Leaf]) -> int:
    """Write `leaves` (keys, key types, tensor or None) as a checkpoint that
    Orbax's ``StandardCheckpointer`` restores: ``_METADATA``,
    ``_CHECKPOINT_METADATA`` and the OCDBT database (:func:`write_ocdbt`).
    Returns the bytes of array data written."""
    start = time.time_ns()
    os.makedirs(directory, exist_ok=True)
    tree, items, nbytes = {}, {}, 0
    for keys, types, t in leaves:
        if t is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(t.shape)}
            items.update(zarr_items(".".join(keys), t))
            nbytes += t.numel() * t.element_size()
        tree[str(tuple(keys))] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in zip(keys, types)],
            "value_metadata": value}
    write_ocdbt(directory, items)
    with open(os.path.join(directory, METADATA_FILE), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(directory, CHECKPOINT_METADATA_FILE), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    return nbytes
