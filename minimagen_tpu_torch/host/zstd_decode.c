/* A zstd decoder (RFC 8878) for the host, with a plain C interface for
 * ctypes: whole frames in, their content out, each frame's XXH64 content
 * checksum verified where the frame carries one.
 *
 * Frames and skippable frames; Raw, RLE and Compressed blocks; literals
 * Raw, RLE, Huffman-coded (1 or 4 streams, the weights direct or
 * FSE-coded) and treeless; sequences with predefined, RLE, FSE-compressed
 * and repeat tables and the three repeat offsets. Dictionaries are
 * refused. Nothing but libc is used; the host is little-endian (x86-64,
 * aarch64).
 *
 *   int64_t mmt_zstd_decompress(src, n, dst, cap)
 *       the bytes written to dst, or a negative error code
 *   int64_t mmt_zstd_content_size(src, n)
 *       the sum of the frames' declared content sizes, -1 where a frame
 *       declares none, or a negative error code below -1
 *   const char *mmt_zstd_error(code)
 *   uint64_t mmt_xxh64(src, n, seed)
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    E_TRUNCATED = -2, E_MAGIC = -3, E_RESERVED = -4, E_DICTIONARY = -5, E_DST_SMALL = -6,
    E_BLOCK = -7, E_LITERALS = -8, E_HUFFMAN = -9, E_FSE = -10, E_SEQUENCES = -11,
    E_OFFSET = -12, E_CONTENT_SIZE = -13, E_CHECKSUM = -14, E_MEMORY = -15
};

const char *mmt_zstd_error(int64_t code) {
    switch (code) {
    case E_TRUNCATED: return "truncated zstd data";
    case E_MAGIC: return "not a zstd frame";
    case E_RESERVED: return "a reserved bit or type is set";
    case E_DICTIONARY: return "the frame needs a dictionary: dictionaries are not supported";
    case E_DST_SMALL: return "the content is larger than the output buffer";
    case E_BLOCK: return "a block is corrupt or too large";
    case E_LITERALS: return "a literals section is corrupt";
    case E_HUFFMAN: return "a Huffman table or stream is corrupt";
    case E_FSE: return "an FSE table is corrupt";
    case E_SEQUENCES: return "a sequences section is corrupt";
    case E_OFFSET: return "a match reaches before the frame's start";
    case E_CONTENT_SIZE: return "the frame's content differs from its declared size";
    case E_CHECKSUM: return "the frame's XXH64 content checksum does not match its content";
    case E_MEMORY: return "out of host memory";
    default: return "unknown error";
    }
}

#define ZSTD_MAGIC 0xFD2FB528u
#define BLOCK_MAX (128 * 1024)

static inline uint64_t le64(const uint8_t *p) { uint64_t v; memcpy(&v, p, 8); return v; }
static inline uint32_t le32(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline unsigned highbit32(uint32_t v) { return 31u - (unsigned)__builtin_clz(v); }

/* ------------------------------------------------------------------------ */
/* XXH64                                                                    */
/* ------------------------------------------------------------------------ */
#define P1 0x9E3779B185EBCA87ULL
#define P2 0xC2B2AE3D27D4EB4FULL
#define P3 0x165667B19E3779F9ULL
#define P4 0x85EBCA77C2B2AE63ULL
#define P5 0x27D4EB2F165667C5ULL

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
    return rotl64(acc + in * P2, 31) * P1;
}
static inline uint64_t xxh_merge(uint64_t h, uint64_t v) {
    return (h ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t mmt_xxh64(const uint8_t *p, size_t n, uint64_t seed) {
    const uint8_t *end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t *limit = end - 32;
        do {
            v1 = xxh_round(v1, le64(p));
            v2 = xxh_round(v2, le64(p + 8));
            v3 = xxh_round(v3, le64(p + 16));
            v4 = xxh_round(v4, le64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P5;
    }
    h += (uint64_t)n;
    for (; p + 8 <= end; p += 8) h = rotl64(h ^ xxh_round(0, le64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl64(h ^ ((uint64_t)le32(p) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; p++) h = rotl64(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ------------------------------------------------------------------------ */
/* backward bit streams (Huffman and FSE streams)                            */
/* ------------------------------------------------------------------------ */
/* A stream is read from the highest set bit of its last byte (a marker)
 * down to bit 0 of its first byte, each read's first bit the most
 * significant. `c` holds the 8 bytes at `p`; `used` counts the bits of
 * `c` already read, from its top. Bits below the stream's start read as
 * zeros. */
typedef struct {
    uint64_t c;
    unsigned used;
    const uint8_t *p, *start;
} BitIn;

static int bits_init(BitIn *b, const uint8_t *src, size_t n) {
    if (n == 0 || src[n - 1] == 0) return E_TRUNCATED;
    unsigned marker = 8 - highbit32(src[n - 1]);
    b->start = src;
    if (n >= 8) {
        b->p = src + n - 8;
        b->c = le64(b->p);
        b->used = marker;
    } else {
        b->p = src;
        b->c = 0;
        for (size_t i = 0; i < n; i++) b->c |= (uint64_t)src[i] << (8 * i);
        b->used = marker + 8 * (unsigned)(8 - n);
    }
    return 0;
}

/* the next n bits (0 <= n <= 56 after a reload), not consumed */
static inline uint64_t bits_peek(const BitIn *b, unsigned n) {
    return ((b->c << (b->used & 63)) >> 1) >> (63 - n);
}

static inline uint64_t bits_read(BitIn *b, unsigned n) {
    uint64_t v = bits_peek(b, n);
    b->used += n;
    return v;
}

static inline void bits_reload(BitIn *b) {
    if (b->used > 64) return;  /* read past the start: overflowed */
    if (b->p >= b->start + 8) {
        b->p -= b->used >> 3;
        b->used &= 7;
    } else if (b->p > b->start) {
        size_t k = b->used >> 3;
        if ((size_t)(b->p - b->start) < k) k = (size_t)(b->p - b->start);
        b->p -= k;
        b->used -= 8 * (unsigned)k;
    } else {
        return;
    }
    b->c = le64(b->p);
}

static inline int bits_done(const BitIn *b) { return b->p == b->start && b->used == 64; }
static inline int bits_overflowed(const BitIn *b) { return b->used > 64; }

/* up to 32 bits of a forward little-endian bit stream from bit `bit`
 * (FSE table descriptions), zeros past its end */
static inline uint32_t fwd_bits(const uint8_t *src, size_t n, size_t bit) {
    size_t at = bit >> 3;
    uint64_t v = 0;
    for (size_t i = 0; i < 5 && at + i < n; i++) v |= (uint64_t)src[at + i] << (8 * i);
    return (uint32_t)(v >> (bit & 7));
}

/* ------------------------------------------------------------------------ */
/* FSE                                                                      */
/* ------------------------------------------------------------------------ */
typedef struct {
    uint16_t base;   /* the next state: base + the nbits read */
    uint8_t symbol;
    uint8_t nbits;
} FseEntry;

typedef struct {
    FseEntry t[512];
    unsigned log;
} FseTable;

/* The FSE table description of at most `n` bytes at `src`: the normalised
 * counts (-1 for "less than 1") of its `*nsym` symbols and the accuracy
 * log; returns the bytes it takes or a negative error. */
static int64_t fse_counts(const uint8_t *src, size_t n, unsigned max_log, unsigned max_symbol,
                          int16_t *counts, unsigned *nsym, unsigned *log_out) {
    if (n == 0) return E_TRUNCATED;
    const size_t total_bits = 8 * n;
    unsigned log = (src[0] & 15u) + 5;
    if (log > max_log) return E_FSE;
    size_t bit = 4;
    int remaining = (1 << log) + 1, threshold = 1 << log;
    unsigned nbits = log + 1, s = 0;
    int previous_zero = 0;
    while (remaining > 1) {
        if (previous_zero) {
            for (;;) {  /* 2-bit repeat flags: more zero counts */
                unsigned flag = fwd_bits(src, n, bit) & 3u;
                bit += 2;
                if (bit > total_bits) return E_TRUNCATED;
                for (unsigned k = 0; k < flag; k++) {
                    if (s > max_symbol) return E_FSE;
                    counts[s++] = 0;
                }
                if (flag != 3) break;
            }
        }
        if (s > max_symbol) return E_FSE;
        int mx = 2 * threshold - 1 - remaining;
        uint32_t window = fwd_bits(src, n, bit);
        int value = (int)(window & ((1u << (nbits - 1)) - 1));
        if (value < mx) {
            bit += nbits - 1;
        } else {
            value = (int)(window & ((1u << nbits) - 1));
            if (value >= threshold) value -= mx;
            bit += nbits;
        }
        if (bit > total_bits) return E_TRUNCATED;
        int count = value - 1;
        remaining -= count < 0 ? -count : count;
        counts[s++] = (int16_t)count;
        previous_zero = count == 0;
        if (remaining < 1) return E_FSE;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return E_FSE;
    *nsym = s;
    *log_out = log;
    return (int64_t)((bit + 7) / 8);
}

/* The decoding table of `counts` at accuracy `log`. */
static int fse_build(FseTable *t, const int16_t *counts, unsigned nsym, unsigned log) {
    unsigned size = 1u << log, high = size - 1;
    uint16_t next[256];
    for (unsigned s = 0; s < nsym; s++) {
        if (counts[s] == -1) {
            t->t[high--].symbol = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)counts[s];
        }
    }
    unsigned step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (unsigned s = 0; s < nsym; s++) {
        for (int i = 0; i < counts[s]; i++) {
            t->t[pos].symbol = (uint8_t)s;
            do pos = (pos + step) & mask; while (pos > high);
        }
    }
    if (pos != 0) return E_FSE;
    for (unsigned u = 0; u < size; u++) {
        unsigned s = t->t[u].symbol;
        unsigned state = next[s]++;
        if (state == 0) return E_FSE;
        unsigned nb = log - highbit32(state);
        t->t[u].nbits = (uint8_t)nb;
        t->t[u].base = (uint16_t)((state << nb) - size);
    }
    t->log = log;
    return 0;
}

static void fse_rle(FseTable *t, uint8_t symbol) {
    t->t[0].symbol = symbol;
    t->t[0].nbits = 0;
    t->t[0].base = 0;
    t->log = 0;
}

/* ------------------------------------------------------------------------ */
/* Huffman                                                                  */
/* ------------------------------------------------------------------------ */
typedef struct {
    uint16_t t[1 << 11];  /* per code prefix of max_bits bits: symbol | bits << 8 */
    unsigned max_bits;
    int valid;
} Huffman;

/* A Huffman tree description of at most `n` bytes at `src` into `h`;
 * returns the bytes it takes or a negative error. */
static int64_t huffman_table(Huffman *h, const uint8_t *src, size_t n) {
    uint8_t w[256];
    unsigned nw = 0;
    if (n == 0) return E_TRUNCATED;
    unsigned head = src[0];
    int64_t taken;
    if (head >= 128) {  /* direct: 4 bits a weight */
        nw = head - 127;
        size_t bytes = (nw + 1) / 2;
        if (1 + bytes > n) return E_TRUNCATED;
        for (unsigned i = 0; i < nw; i++) w[i] = (i & 1) ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
        taken = (int64_t)(1 + bytes);
    } else {  /* FSE-coded: two interleaved states over one stream */
        if (1 + (size_t)head > n) return E_TRUNCATED;
        int16_t counts[256];
        unsigned nsym, log;
        int64_t k = fse_counts(src + 1, head, 6, 255, counts, &nsym, &log);
        if (k < 0) return k;
        FseTable t;
        int r = fse_build(&t, counts, nsym, log);
        if (r) return r;
        BitIn b;
        if (bits_init(&b, src + 1 + k, head - (size_t)k)) return E_HUFFMAN;
        unsigned s1 = (unsigned)bits_read(&b, log), s2 = (unsigned)bits_read(&b, log);
        bits_reload(&b);
        for (;;) {
            if (nw > 253) return E_HUFFMAN;
            w[nw++] = t.t[s1].symbol;
            s1 = t.t[s1].base + (unsigned)bits_read(&b, t.t[s1].nbits);
            bits_reload(&b);
            if (bits_overflowed(&b)) {
                w[nw++] = t.t[s2].symbol;
                break;
            }
            w[nw++] = t.t[s2].symbol;
            s2 = t.t[s2].base + (unsigned)bits_read(&b, t.t[s2].nbits);
            bits_reload(&b);
            if (bits_overflowed(&b)) {
                w[nw++] = t.t[s1].symbol;
                break;
            }
        }
        taken = (int64_t)(1 + head);
    }
    uint32_t total = 0;
    for (unsigned i = 0; i < nw; i++) {
        if (w[i] > 11) return E_HUFFMAN;
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0 || nw > 255) return E_HUFFMAN;
    unsigned max_bits = highbit32(total) + 1;
    uint32_t rest = (1u << max_bits) - total;
    if (max_bits > 11 || (rest & (rest - 1))) return E_HUFFMAN;
    w[nw++] = (uint8_t)(highbit32(rest) + 1);  /* the last symbol's weight */
    unsigned pos = 0, size = 1u << max_bits;
    for (unsigned wt = 1; wt <= max_bits; wt++) {
        for (unsigned s = 0; s < nw; s++) {
            if (w[s] != wt) continue;
            unsigned k = 1u << (wt - 1);
            if (pos + k > size) return E_HUFFMAN;
            uint16_t e = (uint16_t)(s | ((max_bits + 1 - wt) << 8));
            for (unsigned i = 0; i < k; i++) h->t[pos + i] = e;
            pos += k;
        }
    }
    if (pos != size) return E_HUFFMAN;
    h->max_bits = max_bits;
    h->valid = 1;
    return taken;
}

/* `count` symbols of the Huffman stream of `n` bytes at `src` */
static int huffman_stream(const Huffman *h, const uint8_t *src, size_t n, uint8_t *out,
                          size_t count) {
    BitIn b;
    if (bits_init(&b, src, n)) return E_HUFFMAN;
    const unsigned mb = h->max_bits;
    const uint16_t *t = h->t;
    size_t i = 0;
    while (i + 4 <= count) {  /* 4 codes of at most 11 bits after a reload */
        bits_reload(&b);
        for (int k = 0; k < 4; k++) {
            uint16_t e = t[bits_peek(&b, mb)];
            out[i++] = (uint8_t)e;
            b.used += e >> 8;
        }
    }
    while (i < count) {
        bits_reload(&b);
        uint16_t e = t[bits_peek(&b, mb)];
        out[i++] = (uint8_t)e;
        b.used += e >> 8;
    }
    bits_reload(&b);
    return bits_done(&b) ? 0 : E_HUFFMAN;
}

/* ------------------------------------------------------------------------ */
/* a frame's decoding state                                                 */
/* ------------------------------------------------------------------------ */
typedef struct {
    Huffman huf;
    FseTable ll, of, ml;
    FseTable pre_ll, pre_of, pre_ml;  /* the predefined tables */
    int have_ll, have_of, have_ml;
    uint32_t reps[3];
    uint8_t lit[BLOCK_MAX + 8];
} Frame;

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
static const uint32_t LL_BASE[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
                                     20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                                     4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                                     20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
                                     35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                     1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

static void predefined_tables(Frame *f) {
    fse_build(&f->pre_ll, LL_DEFAULT, 36, 6);
    fse_build(&f->pre_ml, ML_DEFAULT, 53, 6);
    fse_build(&f->pre_of, OF_DEFAULT, 29, 5);
}

/* A compressed block's literals section at `src` (the block's `n` bytes):
 * the literals in f->lit or, when raw, pointed at in the source; returns
 * the bytes the section takes or a negative error. */
static int64_t literals(Frame *f, const uint8_t *src, size_t n, const uint8_t **lit,
                        size_t *nlit) {
    if (n == 0) return E_TRUNCATED;
    unsigned kind = src[0] & 3, fmt = (src[0] >> 2) & 3;
    size_t regen, comp = 0, head;
    if (kind < 2) {  /* Raw, RLE */
        if (fmt == 0 || fmt == 2) {
            regen = src[0] >> 3;
            head = 1;
        } else if (fmt == 1) {
            if (n < 2) return E_TRUNCATED;
            regen = (src[0] >> 4) + ((size_t)src[1] << 4);
            head = 2;
        } else {
            if (n < 3) return E_TRUNCATED;
            regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
            head = 3;
        }
        if (regen > BLOCK_MAX) return E_LITERALS;
        if (kind == 0) {
            if (head + regen > n) return E_TRUNCATED;
            *lit = src + head;
            *nlit = regen;
            return (int64_t)(head + regen);
        }
        if (head + 1 > n) return E_TRUNCATED;
        memset(f->lit, src[head], regen);
        *lit = f->lit;
        *nlit = regen;
        return (int64_t)(head + 1);
    }
    if (fmt < 2) {
        if (n < 3) return E_TRUNCATED;
        uint32_t v = src[0] | (src[1] << 8) | ((uint32_t)src[2] << 16);
        regen = (v >> 4) & 0x3FF;
        comp = (v >> 14) & 0x3FF;
        head = 3;
    } else if (fmt == 2) {
        if (n < 4) return E_TRUNCATED;
        uint32_t v = le32(src);
        regen = (v >> 4) & 0x3FFF;
        comp = (v >> 18) & 0x3FFF;
        head = 4;
    } else {
        if (n < 5) return E_TRUNCATED;
        uint64_t v = le32(src) | ((uint64_t)src[4] << 32);
        regen = (size_t)((v >> 4) & 0x3FFFF);
        comp = (size_t)((v >> 22) & 0x3FFFF);
        head = 5;
    }
    if (regen > BLOCK_MAX || head + comp > n) return E_LITERALS;
    const uint8_t *p = src + head, *end = p + comp;
    if (kind == 2) {
        int64_t k = huffman_table(&f->huf, p, comp);
        if (k < 0) return k;
        p += k;
    } else if (!f->huf.valid) {
        return E_LITERALS;  /* treeless literals without an earlier table */
    }
    if (fmt == 0) {
        int r = huffman_stream(&f->huf, p, (size_t)(end - p), f->lit, regen);
        if (r) return r;
    } else {
        if (end - p < 6) return E_TRUNCATED;
        size_t sizes[4] = {(size_t)(p[0] | (p[1] << 8)), (size_t)(p[2] | (p[3] << 8)),
                           (size_t)(p[4] | (p[5] << 8)), 0};
        p += 6;
        size_t room = (size_t)(end - p);
        if (sizes[0] + sizes[1] + sizes[2] > room) return E_LITERALS;
        sizes[3] = room - sizes[0] - sizes[1] - sizes[2];
        size_t each = (regen + 3) / 4;
        if (3 * each > regen) return E_LITERALS;
        for (int i = 0; i < 4; i++) {
            size_t count = i < 3 ? each : regen - 3 * each;
            int r = huffman_stream(&f->huf, p, sizes[i], f->lit + i * each, count);
            if (r) return r;
            p += sizes[i];
        }
    }
    *lit = f->lit;
    *nlit = regen;
    return (int64_t)(head + comp);
}

/* One sequence table of the sequences section at `p` (before `end`) in
 * `mode`; returns the bytes it takes or a negative error. */
static int64_t seq_table(FseTable *t, int *have, const FseTable *pre, const uint8_t *p,
                         const uint8_t *end, unsigned mode, unsigned max_log, unsigned max_sym) {
    if (mode == 0) {
        *t = *pre;
    } else if (mode == 1) {
        if (p >= end || *p > max_sym) return E_SEQUENCES;
        fse_rle(t, *p);
        *have = 1;
        return 1;
    } else if (mode == 2) {
        int16_t counts[256];
        unsigned nsym, log;
        int64_t k = fse_counts(p, (size_t)(end - p), max_log, max_sym, counts, &nsym, &log);
        if (k < 0) return k;
        int r = fse_build(t, counts, nsym, log);
        if (r) return r;
        *have = 1;
        return k;
    } else if (!*have) {
        return E_SEQUENCES;  /* repeat mode without an earlier table */
    }
    *have = 1;
    return 0;
}

/* The sequences section at `p` (the block's rest up to `end`), executed
 * into out[*pos:cap] with the block's literals; out[0] is the frame's
 * first byte. */
static int sequences(Frame *f, const uint8_t *p, const uint8_t *end, const uint8_t *lit,
                     size_t nlit, uint8_t *out, size_t *pos, size_t cap) {
    if (p >= end) return E_TRUNCATED;
    size_t nseq;
    unsigned b0 = p[0];
    if (b0 < 128) {
        nseq = b0;
        p += 1;
    } else if (b0 < 255) {
        if (end - p < 2) return E_TRUNCATED;
        nseq = ((size_t)(b0 - 128) << 8) + p[1];
        p += 2;
    } else {
        if (end - p < 3) return E_TRUNCATED;
        nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
        p += 3;
    }
    size_t o = *pos;
    const uint8_t *lp = lit, *lend = lit + nlit;
    if (nseq) {
        if (p >= end) return E_TRUNCATED;
        unsigned modes = *p++;
        if (modes & 3) return E_RESERVED;
        int64_t k;
        if ((k = seq_table(&f->ll, &f->have_ll, &f->pre_ll, p, end, modes >> 6, 9, 35)) < 0) return (int)k;
        p += k;
        if ((k = seq_table(&f->of, &f->have_of, &f->pre_of, p, end, (modes >> 4) & 3, 8, 31)) < 0)
            return (int)k;
        p += k;
        if ((k = seq_table(&f->ml, &f->have_ml, &f->pre_ml, p, end, (modes >> 2) & 3, 9, 52)) < 0)
            return (int)k;
        p += k;
        BitIn b;
        if (bits_init(&b, p, (size_t)(end - p))) return E_SEQUENCES;
        const FseEntry *ll = f->ll.t, *of = f->of.t, *ml = f->ml.t;
        unsigned sl = (unsigned)bits_read(&b, f->ll.log);
        unsigned so = (unsigned)bits_read(&b, f->of.log);
        unsigned sm = (unsigned)bits_read(&b, f->ml.log);
        uint32_t r0 = f->reps[0], r1 = f->reps[1], r2 = f->reps[2];
        for (size_t i = 0; i < nseq; i++) {
            bits_reload(&b);
            unsigned ofc = of[so].symbol, llc = ll[sl].symbol, mlc = ml[sm].symbol;
            if (ofc > 31) return E_SEQUENCES;
            uint32_t ov = (uint32_t)((1ull << ofc) + bits_read(&b, ofc));
            bits_reload(&b);
            size_t mlen = ML_BASE[mlc] + (size_t)bits_read(&b, ML_BITS[mlc]);
            size_t llen = LL_BASE[llc] + (size_t)bits_read(&b, LL_BITS[llc]);
            uint32_t off;
            if (ov > 3) {
                off = ov - 3;
                r2 = r1;
                r1 = r0;
                r0 = off;
            } else {
                unsigned idx = ov - 1 + (llen == 0);
                if (idx == 0) {
                    off = r0;
                } else if (idx == 1) {
                    off = r1;
                    r1 = r0;
                    r0 = off;
                } else if (idx == 2) {
                    off = r2;
                    r2 = r1;
                    r1 = r0;
                    r0 = off;
                } else {
                    off = r0 - 1;
                    if (off == 0) return E_SEQUENCES;
                    r2 = r1;
                    r1 = r0;
                    r0 = off;
                }
            }
            if (i + 1 < nseq) {
                bits_reload(&b);
                sl = ll[sl].base + (unsigned)bits_read(&b, ll[sl].nbits);
                sm = ml[sm].base + (unsigned)bits_read(&b, ml[sm].nbits);
                so = of[so].base + (unsigned)bits_read(&b, of[so].nbits);
            }
            /* execute: the literals, then the match */
            if ((size_t)(lend - lp) < llen) return E_SEQUENCES;
            if (cap - o < llen + mlen) return E_DST_SMALL;
            memcpy(out + o, lp, llen);
            lp += llen;
            o += llen;
            if (off > o) return E_OFFSET;
            uint8_t *d = out + o;
            const uint8_t *m = d - off;
            if (off >= mlen) {
                memcpy(d, m, mlen);
            } else if (off >= 8) {
                size_t c = 0;
                for (; c + 8 <= mlen; c += 8) memcpy(d + c, m + c, 8);
                for (; c < mlen; c++) d[c] = m[c];
            } else {
                for (size_t c = 0; c < mlen; c++) d[c] = m[c];
            }
            o += mlen;
        }
        bits_reload(&b);
        if (!bits_done(&b)) return E_SEQUENCES;
        f->reps[0] = r0;
        f->reps[1] = r1;
        f->reps[2] = r2;
    } else if (p != end) {
        return E_SEQUENCES;
    }
    size_t rest = (size_t)(lend - lp);
    if (cap - o < rest) return E_DST_SMALL;
    memcpy(out + o, lp, rest);
    *pos = o + rest;
    return 0;
}

/* ------------------------------------------------------------------------ */
/* frames                                                                   */
/* ------------------------------------------------------------------------ */
typedef struct {
    size_t header;        /* bytes from the magic number to the first block */
    int64_t content_size; /* -1 where not declared */
    int checksum;
} FrameHeader;

static int frame_header(const uint8_t *src, size_t n, FrameHeader *h) {
    if (n < 5) return E_TRUNCATED;
    unsigned fhd = src[4];
    unsigned fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
    if (fhd & 8) return E_RESERVED;
    size_t pos = 5 + (single ? 0 : 1);
    static const size_t dict_sizes[4] = {0, 1, 2, 4};
    static const size_t fcs_sizes[4] = {0, 2, 4, 8};
    size_t ds = dict_sizes[dict_flag], fs = fcs_flag ? fcs_sizes[fcs_flag] : (single ? 1 : 0);
    if (pos + ds + fs > n) return E_TRUNCATED;
    uint32_t dict_id = 0;
    for (size_t i = 0; i < ds; i++) dict_id |= (uint32_t)src[pos + i] << (8 * i);
    if (dict_id) return E_DICTIONARY;
    pos += ds;
    h->content_size = -1;
    if (fs) {
        uint64_t v = 0;
        for (size_t i = 0; i < fs; i++) v |= (uint64_t)src[pos + i] << (8 * i);
        if (fs == 2) v += 256;
        h->content_size = (int64_t)v;
        pos += fs;
    }
    h->header = pos;
    h->checksum = (fhd >> 2) & 1;
    return 0;
}

/* The frame at `src` (its magic number first) into out[*pos:cap]; returns
 * the bytes the frame takes or a negative error. */
static int64_t frame(Frame *f, const uint8_t *src, size_t n, uint8_t *out, size_t *pos,
                     size_t cap) {
    FrameHeader h;
    int r = frame_header(src, n, &h);
    if (r) return r;
    f->huf.valid = 0;
    f->have_ll = f->have_of = f->have_ml = 0;
    f->reps[0] = 1;
    f->reps[1] = 4;
    f->reps[2] = 8;
    size_t p = h.header, start = *pos;
    for (;;) {
        if (p + 3 > n) return E_TRUNCATED;
        uint32_t bh = src[p] | (src[p + 1] << 8) | ((uint32_t)src[p + 2] << 16);
        p += 3;
        unsigned last = bh & 1, kind = (bh >> 1) & 3;
        size_t size = bh >> 3;
        if (kind == 0) {  /* Raw */
            if (p + size > n) return E_TRUNCATED;
            if (cap - *pos < size) return E_DST_SMALL;
            memcpy(out + *pos, src + p, size);
            *pos += size;
            p += size;
        } else if (kind == 1) {  /* RLE */
            if (p + 1 > n) return E_TRUNCATED;
            if (cap - *pos < size) return E_DST_SMALL;
            memset(out + *pos, src[p], size);
            *pos += size;
            p += 1;
        } else if (kind == 2) {  /* Compressed */
            if (size > BLOCK_MAX) return E_BLOCK;
            if (p + size > n) return E_TRUNCATED;
            const uint8_t *lit = NULL;
            size_t nlit = 0;
            int64_t k = literals(f, src + p, size, &lit, &nlit);
            if (k < 0) return k;
            /* offsets count from the frame's first byte */
            size_t o = *pos - start;
            r = sequences(f, src + p + k, src + p + size, lit, nlit, out + start, &o, cap - start);
            if (r) return r;
            *pos = start + o;
            p += size;
        } else {
            return E_RESERVED;
        }
        if (last) break;
    }
    size_t produced = *pos - start;
    if (h.content_size >= 0 && (uint64_t)h.content_size != produced) return E_CONTENT_SIZE;
    if (h.checksum) {
        if (p + 4 > n) return E_TRUNCATED;
        uint32_t want = le32(src + p);
        if ((uint32_t)mmt_xxh64(out + start, produced, 0) != want) return E_CHECKSUM;
        p += 4;
    }
    return (int64_t)p;
}

int64_t mmt_zstd_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
    Frame *f = (Frame *)malloc(sizeof(Frame));  /* per call: calls may run in threads */
    if (!f) return E_MEMORY;
    predefined_tables(f);
    size_t p = 0, pos = 0;
    int64_t r = 0;
    while (p < n && r >= 0) {
        if (n - p < 4) {
            r = E_TRUNCATED;
            break;
        }
        uint32_t magic = le32(src + p);
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  /* skippable frame */
            size_t len = n - p < 8 ? 0 : le32(src + p + 4);
            if (n - p < 8 || n - p - 8 < len) r = E_TRUNCATED;
            p += 8 + len;
            continue;
        }
        if (magic != ZSTD_MAGIC) {
            r = E_MAGIC;
            break;
        }
        r = frame(f, src + p, n - p, dst, &pos, cap);
        if (r >= 0) p += (size_t)r;
    }
    free(f);
    return r < 0 ? r : (int64_t)pos;
}

int64_t mmt_zstd_content_size(const uint8_t *src, size_t n) {
    size_t p = 0;
    int64_t total = 0;
    while (p < n) {
        if (n - p < 4) return E_TRUNCATED;
        uint32_t magic = le32(src + p);
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
            if (n - p < 8) return E_TRUNCATED;
            size_t len = le32(src + p + 4);
            if (n - p - 8 < len) return E_TRUNCATED;
            p += 8 + len;
            continue;
        }
        if (magic != ZSTD_MAGIC) return E_MAGIC;
        FrameHeader h;
        int r = frame_header(src + p, n - p, &h);
        if (r) return r;
        if (h.content_size < 0) return -1;
        total += h.content_size;
        /* walk the blocks to the next frame */
        size_t q = p + h.header;
        for (;;) {
            if (q + 3 > n) return E_TRUNCATED;
            uint32_t bh = src[q] | (src[q + 1] << 8) | ((uint32_t)src[q + 2] << 16);
            unsigned kind = (bh >> 1) & 3;
            q += 3 + (kind == 1 ? 1 : (kind == 3 ? 0 : (bh >> 3)));
            if (kind == 3) return E_RESERVED;
            if (bh & 1) break;
        }
        p = q + (h.checksum ? 4 : 0);
        if (p > n) return E_TRUNCATED;
    }
    return total;
}
