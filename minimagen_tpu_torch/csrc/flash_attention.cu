// Attention forward and backward for Hopper: softmax(q k^T + bias) v with the
// logits in float32, never written to device memory.
//
// Replaces the Pallas kernels of minimagen_tpu/ops/flash_attention.py:
//   _mqa_kernel (:92, launched by _mqa_forward) -> mmt_mqa_forward
//     q (b, h, n, d) pre-scaled, one K/V head shared by all heads: k, v (b, j, d)
//   _mha_kernel (:97, launched by _mha_forward) and
//   _mha_bias_kernel (:349, launched by _mha_bias_forward) -> mmt_mha_forward
//     q (b, h, n, d), per-head k, v (b, h, j, d)
//   _mqa_bwd_kernel (:174, launched by _mqa_bwd_pallas) -> mmt_mqa_backward
//   _mha_bias_bwd_kernel (:394, launched by _mha_bias_bwd_pallas) -> mmt_mha_backward
// An optional float32 bias row per sample, (b, j), is added to the logits:
// the mask-derived bias of _mask_bias (0 keep, -1e30 drop). A null pointer
// means no bias, the U-Net's path. The forward optionally writes the row's
// log-sum-exp (float32, (b, h, n)), which the backward needs; sampling asks
// for none. j is odd on the main path (n + 1 for the null token of
// self-attention; 2 or 4 time tokens + 256 text tokens + 1 null for
// cross-attention), so the last K/V tile is ragged and masked here.
//
// What bounds it on the card: the forward is 4*b*h*n*j*d operations, the
// backward 10*b*h*n*j*d (five products, S recomputed), over (q, k, v, o [,
// do, dq, dk, dv]) bytes, so at the main path's shapes (n, j ~ 1024) both
// are compute-bound, and the products belong on the tensor cores.
//
// bfloat16 (the main path): FlashAttention-2 style on mma.sync m16n8k16.
// A block of 4 warps owns 64 query rows (16 per warp, held as bf16 A
// fragments); K/V stream through shared memory in tiles of 64 keys, read
// with ldmatrix (V transposed) from rows padded to 72 elements so the reads
// are conflict-free. S = Q K^T accumulates in float32 registers; the online
// softmax keeps a float32 running max and row sum per row, P = exp(S - max)
// is rounded to bf16 as the A operand of P V (the TPU kernel's
// p.astype(v.dtype)), and the division by the row sum happens once at the
// end (its late divide). No cp.async pipelining yet: loads and products of a
// tile do not overlap.
//
// The backward is two passes, because the TPU kernel's way of summing dk/dv
// (a revisited output block across its sequential grid) has no counterpart
// when blocks run in no order:
//   1. Q-major (one block per 64 query rows): D = rowsum(dO * O) in float32
//      (from the stored O, one bf16 rounding away from the TPU kernel's
//      sum(p * dp)), then over all key tiles P = exp(S + bias - lse),
//      dP = dO V^T, dS = P (dP - D), dq += dS K.
//   2. K/V-major (one block per 64 keys and (sample, head)): over the n query
//      rows of that head, P^T and dS^T rebuilt the same way, dv += P^T dO,
//      dk += dS^T Q, into a float32 buffer of one slice per (sample, head).
//   Then a small pass sums the slices over the heads that share a K/V head
//   (multi-query: all h; multi-head: just the one) in head order and casts.
// No atomics: every sum is taken in a fixed order, so two runs give the same
// bits. P and dS are rounded to bf16 as the A operands of the last three
// products (the TPU kernel rounds dS for dq and keeps float32 for dk/dv).
//
// float32 (tests and the float32 reference run): the same passes on the
// CUDA cores, one thread per query row (forward, dq) or per key (dk/dv).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;  // ATTN_DIM_HEAD of the U-Net
constexpr int kBlockQ = 64;   // float32 forward: query rows (= threads) per block
constexpr int kBlockK = 32;   // float32 forward: keys per shared-memory tile
constexpr int kMaxGridYZ = 65535;  // the most blocks along grid y or z

// Every launch's grid is (tiles, heads, batch): x walks the query rows or
// keys of one (sample, head), y the heads and z the samples, so batch and
// heads may each reach 65535 (batch * heads past 65535 included) and the
// blocks of one (sample, head) still run next to each other.
__device__ __forceinline__ int sample_head() {
  return static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
}

// K/V of (batch * heads + head) bh sit at index bh / kv_group: kv_group is
// the head count for multi-query (one K/V per sample), 1 for multi-head.
// The bias row of bh is row bh / heads.
__device__ __forceinline__ const float* bias_row(const float* bias, int bh, int heads, int j) {
  return bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * j;
}

// ---- float32 on the CUDA cores ---------------------------------------------
__global__ void __launch_bounds__(kBlockQ)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         float* __restrict__ o, float* __restrict__ lse, int kv_group, int heads,
                         int n, int j) {
  __shared__ float ks[kBlockK][kHeadDim];
  __shared__ float vs[kBlockK][kHeadDim];
  __shared__ float bs[kBlockK];

  const int bh = sample_head();
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < n;
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const float* kp = k + kv_base;
  const float* vp = v + kv_base;
  const float* brow = bias_row(bias, bh, heads, j);

  float qr[kHeadDim];
  float acc[kHeadDim];
  const float* qp = q + (static_cast<size_t>(bh) * n + (active ? row : 0)) * kHeadDim;
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) {
    qr[c] = active ? qp[c] : 0.f;
    acc[c] = 0.f;
  }
  float row_max = -INFINITY;
  float row_sum = 0.f;

  for (int k0 = 0; k0 < j; k0 += kBlockK) {
    const int kt = min(kBlockK, j - k0);  // >= 1
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kBlockK * kHeadDim; e += kBlockQ) {
      const int r = e / kHeadDim, c = e % kHeadDim;
      float kv = 0.f, vv = 0.f;
      if (r < kt) {
        const size_t idx = static_cast<size_t>(k0 + r) * kHeadDim + c;
        kv = kp[idx];
        vv = vp[idx];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    if (threadIdx.x < kBlockK)
      bs[threadIdx.x] = (brow != nullptr && threadIdx.x < kt) ? brow[k0 + threadIdx.x] : 0.f;
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < kBlockK; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) dot = fmaf(qr[c], ks[r][c], dot);
      s[r] = r < kt ? dot + bs[r] : -INFINITY;  // ragged tail of the last tile
      tile_max = fmaxf(tile_max, s[r]);
    }
    const float new_max = fmaxf(row_max, tile_max);  // finite: kt >= 1
    const float correction = expf(row_max - new_max);  // 0 on the first tile
    row_sum *= correction;
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) acc[c] *= correction;
#pragma unroll
    for (int r = 0; r < kBlockK; ++r) {
      const float p = expf(s[r] - new_max);  // 0 for masked keys
      row_sum += p;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) acc[c] = fmaf(p, vs[r][c], acc[c]);
    }
    row_max = new_max;
  }

  if (active) {
    float* op = o + (static_cast<size_t>(bh) * n + row) * kHeadDim;
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) op[c] = acc[c] / row_sum;
    if (lse != nullptr) lse[static_cast<size_t>(bh) * n + row] = row_max + logf(row_sum);
  }
}

constexpr int kF32Pad = kHeadDim + 1;  // per-thread rows in shared memory: conflict-free
constexpr int kDqRows = 64;            // float32 dq pass: query rows (= threads) per block
constexpr int kDqKeys = 16;            // float32 dq pass: keys per tile
constexpr int kKvKeys = 64;            // float32 dk/dv pass: keys (= threads) per block
constexpr int kKvRows = 16;            // float32 dk/dv pass: query rows per tile

// Pass 1 in float32: D, then dq = sum over keys of dS K.
__global__ void __launch_bounds__(kDqRows)
    attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ o, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ delta, int kv_group, int heads, int n, int j) {
  __shared__ float qs[kDqRows][kF32Pad];
  __shared__ float dos[kDqRows][kF32Pad];
  __shared__ float ks[kDqKeys][kHeadDim];
  __shared__ float vs[kDqKeys][kHeadDim];
  __shared__ float bs[kDqKeys];

  const int bh = sample_head();
  const int q0 = blockIdx.x * kDqRows;
  const int row = q0 + threadIdx.x;
  const bool active = row < n;
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const float* brow = bias_row(bias, bh, heads, j);
  const size_t rows_base = (static_cast<size_t>(bh) * n + q0) * kHeadDim;

  for (int e = threadIdx.x; e < kDqRows * kHeadDim; e += kDqRows) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const bool valid = q0 + r < n;
    qs[r][c] = valid ? q[rows_base + e] : 0.f;
    dos[r][c] = valid ? dout[rows_base + e] : 0.f;
  }
  __syncthreads();
  float d_row = 0.f;
  if (active) {
    const float* op = o + rows_base + static_cast<size_t>(threadIdx.x) * kHeadDim;
    for (int c = 0; c < kHeadDim; ++c) d_row = fmaf(dos[threadIdx.x][c], op[c], d_row);
    delta[static_cast<size_t>(bh) * n + row] = d_row;
  }
  const float l_row = active ? lse[static_cast<size_t>(bh) * n + row] : INFINITY;

  float acc[kHeadDim];
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < j; k0 += kDqKeys) {
    const int kt = min(kDqKeys, j - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kDqKeys * kHeadDim; e += kDqRows) {
      const int r = e / kHeadDim, c = e % kHeadDim;
      const size_t idx = kv_base + static_cast<size_t>(k0 + r) * kHeadDim + c;
      ks[r][c] = r < kt ? k[idx] : 0.f;
      vs[r][c] = r < kt ? v[idx] : 0.f;
    }
    if (threadIdx.x < kDqKeys)
      bs[threadIdx.x] = (brow != nullptr && threadIdx.x < kt) ? brow[k0 + threadIdx.x] : 0.f;
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < kDqKeys; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        s = fmaf(qs[threadIdx.x][c], ks[r][c], s);
        dp = fmaf(dos[threadIdx.x][c], vs[r][c], dp);
      }
      const float p = r < kt ? expf(s + bs[r] - l_row) : 0.f;
      const float ds = p * (dp - d_row);
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) acc[c] = fmaf(ds, ks[r][c], acc[c]);
    }
  }
  if (active) {
    float* dqp = dq + (static_cast<size_t>(bh) * n + row) * kHeadDim;
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) dqp[c] = acc[c];
  }
}

// Pass 2 in float32: one thread per key of (sample, head) bh; dk and dv of
// that head's n query rows into the float32 slice bh.
__global__ void __launch_bounds__(kKvKeys)
    attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk_acc,
                              float* __restrict__ dv_acc, int kv_group, int heads, int n, int j) {
  __shared__ float ks[kKvKeys][kF32Pad];
  __shared__ float vs[kKvKeys][kF32Pad];
  __shared__ float qs[kKvRows][kHeadDim];
  __shared__ float dos[kKvRows][kHeadDim];
  __shared__ float lse_s[kKvRows];
  __shared__ float d_s[kKvRows];

  const int bh = sample_head();
  const int k0 = blockIdx.x * kKvKeys;
  const int key = k0 + threadIdx.x;
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const float* brow = bias_row(bias, bh, heads, j);
  for (int e = threadIdx.x; e < kKvKeys * kHeadDim; e += kKvKeys) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const bool valid = k0 + r < j;
    const size_t idx = kv_base + static_cast<size_t>(k0) * kHeadDim + e;
    ks[r][c] = valid ? k[idx] : 0.f;
    vs[r][c] = valid ? v[idx] : 0.f;
  }
  const float b_key = (brow != nullptr && key < j) ? brow[key] : 0.f;

  float dk[kHeadDim], dv[kHeadDim];
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) dk[c] = dv[c] = 0.f;
  const size_t q_base = static_cast<size_t>(bh) * n;
  for (int r0 = 0; r0 < n; r0 += kKvRows) {
    const int rt = min(kKvRows, n - r0);
    __syncthreads();
    for (int e = threadIdx.x; e < kKvRows * kHeadDim; e += kKvKeys) {
      const int r = e / kHeadDim, c = e % kHeadDim;
      const size_t idx = (q_base + r0) * kHeadDim + e;
      qs[r][c] = r < rt ? q[idx] : 0.f;
      dos[r][c] = r < rt ? dout[idx] : 0.f;
    }
    if (threadIdx.x < kKvRows) {
      const bool valid = static_cast<int>(threadIdx.x) < rt;
      lse_s[threadIdx.x] = valid ? lse[q_base + r0 + threadIdx.x] : INFINITY;  // p = 0
      d_s[threadIdx.x] = valid ? delta[q_base + r0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < kKvRows; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        s = fmaf(ks[threadIdx.x][c], qs[r][c], s);
        dp = fmaf(vs[threadIdx.x][c], dos[r][c], dp);
      }
      const float p = expf(s + b_key - lse_s[r]);
      const float ds = p * (dp - d_s[r]);
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) {
        dv[c] = fmaf(p, dos[r][c], dv[c]);
        dk[c] = fmaf(ds, qs[r][c], dk[c]);
      }
    }
  }
  if (key < j) {
    const size_t out = (static_cast<size_t>(bh) * j + key) * kHeadDim;
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) {
      dk_acc[out + c] = dk[c];
      dv_acc[out + c] = dv[c];
    }
  }
}

// ---- bfloat16 on the tensor cores ------------------------------------------
constexpr int kTcRows = 64;       // query rows per block: 4 warps x 16
constexpr int kTcKeys = 64;       // keys per tile
constexpr int kTcThreads = 128;
constexpr int kTcStride = kHeadDim + 8;  // padded row: conflict-free ldmatrix
constexpr float kLog2e = 1.4426950408889634f;

using Tile = __nv_bfloat16[kTcStride];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 tile: bf16 inputs, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, valid) of a row-major (rows, 64) bf16 matrix into a padded
// shared tile of kRows rows, zero-filling the rest; 16-byte moves.
template <int kRows>
__device__ __forceinline__ void load_tile(Tile* dst, const __nv_bfloat16* src, int valid) {
  for (int e = threadIdx.x; e < kRows * (kHeadDim / 8); e += kTcThreads) {
    const int r = e / (kHeadDim / 8), c = (e % (kHeadDim / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kHeadDim + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// Entries [0, valid) of a float row into shared memory, `fill` after them.
__device__ __forceinline__ void load_row(float* dst, const float* src, int valid, float fill) {
  if (threadIdx.x < kTcKeys)
    dst[threadIdx.x] = (src != nullptr && static_cast<int>(threadIdx.x) < valid)
                           ? src[threadIdx.x] : fill;
}

// The A fragments of this warp's 16 rows of a (64, 64) tile, 4 steps over d.
__device__ __forceinline__ void load_a_fragments(uint32_t (&f)[kHeadDim / 16][4], const Tile* s,
                                                 int warp, int mat, int mrow) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    ldmatrix_x4(f[kk], &s[warp * 16 + mrow + (mat & 1) * 8][kk * 16 + (mat >> 1) * 8]);
}

// acc (16 x 64 columns) += A (16 x 64 depth) B^T for B a (64 columns, 64
// depth) row-major shared tile: the S = Q K^T product.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[kHeadDim / 16][4],
                                        const Tile* b_tile, int mat, int mrow) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, &b_tile[(np * 2 + (mat >> 1)) * 8 + mrow][kk * 16 + (mat & 1) * 8]);
      mma_bf16(acc[np * 2], a[kk], b[0], b[1]);
      mma_bf16(acc[np * 2 + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x 64 d) += P B for P the float32 (16 x 64 depth) accumulator tile
// `p` rounded to bf16 and B a (64 depth, 64 d) row-major shared tile: the
// O = P V product.
__device__ __forceinline__ void mma_pb(float (&acc)[8][4], const float (&p)[8][4],
                                       const Tile* b_tile, int mat, int mrow) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kHeadDim / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &b_tile[kk * 16 + (mat & 1) * 8 + mrow][(dp * 2 + (mat >> 1)) * 8]);
      mma_bf16(acc[dp * 2], pa, b[0], b[1]);
      mma_bf16(acc[dp * 2 + 1], pa, b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads)
    attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int kv_group,
                              int heads, int n, int j) {
  __shared__ __align__(16) Tile qs[kTcRows];
  __shared__ __align__(16) Tile ks[kTcKeys];
  __shared__ __align__(16) Tile vs[kTcKeys];
  __shared__ float bs[kTcKeys];

  const int bh = sample_head();
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;        // accumulator row / column pair
  const int mat = lane >> 3, mrow = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const float* brow = bias_row(bias, bh, heads, j);

  load_tile<kTcRows>(qs, q + (static_cast<size_t>(bh) * n + q0) * kHeadDim, n - q0);
  __syncthreads();
  uint32_t qf[kHeadDim / 16][4];  // A fragments of this warp's 16 rows, 4 steps over d
  load_a_fragments(qf, qs, warp, mat, mrow);

  float of[kHeadDim / 8][4] = {};  // output accumulator, 8 column tiles over d
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float row_sum[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int k0 = 0; k0 < j; k0 += kTcKeys) {
    const int kt = min(kTcKeys, j - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<kTcKeys>(ks, k + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
    load_tile<kTcKeys>(vs, v + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
    load_row(bs, brow == nullptr ? nullptr : brow + k0, kt, 0.f);
    __syncthreads();

    float sf[kTcKeys / 8][4] = {};  // S = Q K^T, 8 column tiles of 8 keys
    mma_abt(sf, qf, ks, mat, mrow);
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        sf[nt][e] = col < kt ? sf[nt][e] + bs[col] : -INFINITY;  // ragged tail: keys past j
      }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt) {
      tile_max[0] = fmaxf(tile_max[0], fmaxf(sf[nt][0], sf[nt][1]));
      tile_max[1] = fmaxf(tile_max[1], fmaxf(sf[nt][2], sf[nt][3]));
    }
    float correction[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float new_max = fmaxf(row_max[r], tile_max[r]);  // finite: key k0 is valid
      correction[r] = exp2f((row_max[r] - new_max) * kLog2e);  // 0 on the first tile
      row_max[r] = new_max;
      row_sum[r] *= correction[r];
    }
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt) {
      of[nt][0] *= correction[0];
      of[nt][1] *= correction[0];
      of[nt][2] *= correction[1];
      of[nt][3] *= correction[1];
    }
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sf[nt][e] = exp2f((sf[nt][e] - row_max[e >> 1]) * kLog2e);  // 0 for masked keys
        row_sum[e >> 1] += sf[nt][e];
      }
    }
    mma_pb(of, sf, vs, mat, mrow);  // O += P V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = row_sum[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row < n) {
      __nv_bfloat16* op = o + (static_cast<size_t>(bh) * n + row) * kHeadDim;
#pragma unroll
      for (int nt = 0; nt < kHeadDim / 8; ++nt)
        *reinterpret_cast<uint32_t*>(op + nt * 8 + 2 * t) =
            pack_bf16(of[nt][2 * r] / total, of[nt][2 * r + 1] / total);
      if (lse != nullptr && t == 0)
        lse[static_cast<size_t>(bh) * n + row] = row_max[r] + logf(total);
    }
  }
}

// Pass 1 on the tensor cores: D for the block's 64 query rows, then
// dq = sum over key tiles of dS K.
__global__ void __launch_bounds__(kTcThreads)
    attention_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ bias,
                                 const __nv_bfloat16* __restrict__ o,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                                 float* __restrict__ delta, int kv_group, int heads, int n,
                                 int j) {
  __shared__ __align__(16) Tile qs[kTcRows];
  __shared__ __align__(16) Tile dos[kTcRows];
  __shared__ __align__(16) Tile ks[kTcKeys];
  __shared__ __align__(16) Tile vs[kTcKeys];
  __shared__ float bs[kTcKeys];
  __shared__ float lse_s[kTcRows];
  __shared__ float d_s[kTcRows];

  const int bh = sample_head();
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const size_t rows_base = (static_cast<size_t>(bh) * n + q0) * kHeadDim;
  const float* brow = bias_row(bias, bh, heads, j);

  load_tile<kTcRows>(qs, q + rows_base, n - q0);
  load_tile<kTcRows>(dos, dout + rows_base, n - q0);
  __syncthreads();
  {  // D = rowsum(dO * O): two threads per row, 32 columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < n) {
      const __nv_bfloat16* op = o + rows_base + static_cast<size_t>(r) * kHeadDim + half * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(dos[r][half * 32 + c + e]), __bfloat162float(oe[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_s[r] = acc;
      lse_s[r] = row < n ? lse[static_cast<size_t>(bh) * n + row] : INFINITY;
      if (row < n) delta[static_cast<size_t>(bh) * n + row] = acc;
    }
  }
  __syncthreads();
  uint32_t qf[kHeadDim / 16][4], dof[kHeadDim / 16][4];
  load_a_fragments(qf, qs, warp, mat, mrow);
  load_a_fragments(dof, dos, warp, mat, mrow);
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse_s[warp * 16 + g + r * 8];
    d_r[r] = d_s[warp * 16 + g + r * 8];
  }

  float dqf[kHeadDim / 8][4] = {};
  for (int k0 = 0; k0 < j; k0 += kTcKeys) {
    const int kt = min(kTcKeys, j - k0);
    __syncthreads();
    load_tile<kTcKeys>(ks, k + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
    load_tile<kTcKeys>(vs, v + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
    load_row(bs, brow == nullptr ? nullptr : brow + k0, kt, 0.f);
    __syncthreads();

    float sf[kTcKeys / 8][4] = {};   // S = Q K^T
    float dpf[kTcKeys / 8][4] = {};  // dP = dO V^T
    mma_abt(sf, qf, ks, mat, mrow);
    mma_abt(dpf, dof, vs, mat, mrow);
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p =
            col < kt ? exp2f((sf[nt][e] + bs[col] - lse_r[e >> 1]) * kLog2e) : 0.f;
        sf[nt][e] = p * (dpf[nt][e] - d_r[e >> 1]);  // dS
      }
    mma_pb(dqf, sf, ks, mat, mrow);  // dq += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row < n) {
      __nv_bfloat16* dp = dq + (static_cast<size_t>(bh) * n + row) * kHeadDim;
#pragma unroll
      for (int nt = 0; nt < kHeadDim / 8; ++nt)
        *reinterpret_cast<uint32_t*>(dp + nt * 8 + 2 * t) =
            pack_bf16(dqf[nt][2 * r], dqf[nt][2 * r + 1]);
    }
  }
}

// Pass 2 on the tensor cores: a block owns 64 keys of (sample, head) bh (4
// warps x 16 keys, K and V held as A fragments) and loops over that head's
// query rows in tiles of 64: S^T = K Q^T, dP^T = V dO^T, then
// dv += P^T dO and dk += dS^T Q, into the float32 slice bh.
__global__ void __launch_bounds__(kTcThreads)
    attention_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dk_acc,
                                   float* __restrict__ dv_acc, int kv_group, int heads, int n,
                                   int j) {
  __shared__ __align__(16) Tile ks[kTcKeys];
  __shared__ __align__(16) Tile vs[kTcKeys];
  __shared__ __align__(16) Tile qs[kTcRows];
  __shared__ __align__(16) Tile dos[kTcRows];
  __shared__ float bs[kTcKeys];
  __shared__ float lse_s[kTcRows];
  __shared__ float d_s[kTcRows];

  const int bh = sample_head();
  const int k0 = blockIdx.x * kTcKeys;
  const int kt = min(kTcKeys, j - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const float* brow = bias_row(bias, bh, heads, j);

  load_tile<kTcKeys>(ks, k + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
  load_tile<kTcKeys>(vs, v + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
  load_row(bs, brow == nullptr ? nullptr : brow + k0, kt, 0.f);
  __syncthreads();
  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  load_a_fragments(kf, ks, warp, mat, mrow);
  load_a_fragments(vf, vs, warp, mat, mrow);
  const float b_key[2] = {bs[warp * 16 + g], bs[warp * 16 + g + 8]};

  float dkf[kHeadDim / 8][4] = {}, dvf[kHeadDim / 8][4] = {};
  const size_t q_base = static_cast<size_t>(bh) * n;
  for (int r0 = 0; r0 < n; r0 += kTcRows) {
    const int rt = min(kTcRows, n - r0);
    __syncthreads();
    load_tile<kTcRows>(qs, q + (q_base + r0) * kHeadDim, rt);
    load_tile<kTcRows>(dos, dout + (q_base + r0) * kHeadDim, rt);
    load_row(lse_s, lse + q_base + r0, rt, INFINITY);  // rows past n: p = 0
    load_row(d_s, delta + q_base + r0, rt, 0.f);
    __syncthreads();

    float st[kTcRows / 8][4] = {};   // S^T = K Q^T: rows are keys, columns query rows
    float dpt[kTcRows / 8][4] = {};  // dP^T = V dO^T
    mma_abt(st, kf, qs, mat, mrow);
    mma_abt(dpt, vf, dos, mat, mrow);
#pragma unroll
    for (int nt = 0; nt < kTcRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p = exp2f((st[nt][e] + b_key[e >> 1] - lse_s[col]) * kLog2e);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - d_s[col]);  // dS^T
      }
    mma_pb(dvf, st, dos, mat, mrow);  // dv += P^T dO
    mma_pb(dkf, dpt, qs, mat, mrow);  // dk += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + r * 8;
    if (key < j) {
      const size_t out = (static_cast<size_t>(bh) * j + key) * kHeadDim;
#pragma unroll
      for (int nt = 0; nt < kHeadDim / 8; ++nt) {
        *reinterpret_cast<float2*>(dk_acc + out + nt * 8 + 2 * t) =
            make_float2(dkf[nt][2 * r], dkf[nt][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_acc + out + nt * 8 + 2 * t) =
            make_float2(dvf[nt][2 * r], dvf[nt][2 * r + 1]);
      }
    }
  }
}

// dk/dv of K/V head i = the sum, in order, of the `parts` float32 slices
// i * parts ... i * parts + parts - 1, cast to T.
template <typename T>
__global__ void kv_reduce_kernel(const float* __restrict__ dk_acc,
                                 const float* __restrict__ dv_acc, T* __restrict__ dk,
                                 T* __restrict__ dv, int parts, size_t per_kv, size_t total) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t base = (e / per_kv) * parts * per_kv + e % per_kv;
    float sk = 0.f, sv = 0.f;
    for (int i = 0; i < parts; ++i) {
      sk += dk_acc[base + i * per_kv];
      sv += dv_acc[base + i * per_kv];
    }
    dk[e] = mmt::from_f32<T>(sk);
    dv[e] = mmt::from_f32<T>(sv);
  }
}

bool bad_sizes(int batch, int heads, int n, int j, int head_dim) {
  return head_dim != kHeadDim || batch <= 0 || heads <= 0 || n <= 0 || j <= 0 ||
         batch > kMaxGridYZ || heads > kMaxGridYZ;
}

int launch_forward(const void* q, const void* k, const void* v, const float* bias, void* o,
                   float* lse, int batch, int heads, int n, int j, int head_dim, int dtype,
                   bool shared_kv, cudaStream_t stream) {
  if (bad_sizes(batch, heads, n, j, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const int kv_group = shared_kv ? heads : 1;
  if (dtype == mmt::kFloat32) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
    attention_fwd_kernel<<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(o), lse, kv_group, heads, n, j);
  } else if (dtype == mmt::kBFloat16) {
    const dim3 grid((n + kTcRows - 1) / kTcRows, heads, batch);
    attention_fwd_bf16_kernel<<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(o), lse,
        kv_group, heads, n, j);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_reduce(const float* dk_acc, const float* dv_acc, void* dk, void* dv, int parts,
                   int n_kv, int j, cudaStream_t stream) {
  const size_t per_kv = static_cast<size_t>(j) * kHeadDim;
  const size_t total = per_kv * n_kv;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 132 * 16));
  kv_reduce_kernel<T><<<blocks, 256, 0, stream>>>(dk_acc, dv_acc, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), parts, per_kv, total);
}

// scratch: float32, batch*heads*n (D) + 2 * batch*heads*j*head_dim (dk/dv slices)
int launch_backward(const void* q, const void* k, const void* v, const float* bias,
                    const void* o, const void* dout, const float* lse, void* dq, void* dk,
                    void* dv, float* scratch, int batch, int heads, int n, int j, int head_dim,
                    int dtype, bool shared_kv, cudaStream_t stream) {
  if (bad_sizes(batch, heads, n, j, head_dim) || lse == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_group = shared_kv ? heads : 1;
  const int bh = batch * heads;
  float* delta = scratch;
  float* dk_acc = scratch + static_cast<size_t>(bh) * n;
  float* dv_acc = dk_acc + static_cast<size_t>(bh) * j * kHeadDim;
  if (dtype == mmt::kFloat32) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* dof = static_cast<const float*>(dout);
    attention_bwd_dq_kernel<<<dim3((n + kDqRows - 1) / kDqRows, heads, batch), kDqRows, 0, stream>>>(
        qf, kf, vf, bias, static_cast<const float*>(o), dof, lse, static_cast<float*>(dq), delta,
        kv_group, heads, n, j);
    attention_bwd_dkdv_kernel<<<dim3((j + kKvKeys - 1) / kKvKeys, heads, batch), kKvKeys, 0, stream>>>(
        qf, kf, vf, bias, dof, lse, delta, dk_acc, dv_acc, kv_group, heads, n, j);
    launch_reduce<float>(dk_acc, dv_acc, dk, dv, kv_group, bh / kv_group, j, stream);
  } else if (dtype == mmt::kBFloat16) {
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
    const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(dout);
    attention_bwd_dq_bf16_kernel<<<dim3((n + kTcRows - 1) / kTcRows, heads, batch), kTcThreads, 0,
                                   stream>>>(
        qb, kb, vb, bias, static_cast<const __nv_bfloat16*>(o), dob, lse,
        static_cast<__nv_bfloat16*>(dq), delta, kv_group, heads, n, j);
    attention_bwd_dkdv_bf16_kernel<<<dim3((j + kTcKeys - 1) / kTcKeys, heads, batch), kTcThreads, 0,
                                     stream>>>(qb, kb, vb, bias, dob, lse, delta, dk_acc, dv_acc,
                                               kv_group, heads, n, j);
    launch_reduce<__nv_bfloat16>(dk_acc, dv_acc, dk, dv, kv_group, bh / kv_group, j, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_mqa_forward(const void* q, const void* k, const void* v, const float* bias,
                               void* o, float* lse, int batch, int heads, int n, int j,
                               int head_dim, int dtype, void* stream) {
  return launch_forward(q, k, v, bias, o, lse, batch, heads, n, j, head_dim, dtype, true,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_mha_forward(const void* q, const void* k, const void* v, const float* bias,
                               void* o, float* lse, int batch, int heads, int n, int j,
                               int head_dim, int dtype, void* stream) {
  return launch_forward(q, k, v, bias, o, lse, batch, heads, n, j, head_dim, dtype, false,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_mqa_backward(const void* q, const void* k, const void* v, const float* bias,
                                const void* o, const void* dout, const float* lse, void* dq,
                                void* dk, void* dv, float* scratch, int batch, int heads, int n,
                                int j, int head_dim, int dtype, void* stream) {
  return launch_backward(q, k, v, bias, o, dout, lse, dq, dk, dv, scratch, batch, heads, n, j,
                         head_dim, dtype, true, static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_mha_backward(const void* q, const void* k, const void* v, const float* bias,
                                const void* o, const void* dout, const float* lse, void* dq,
                                void* dk, void* dv, float* scratch, int batch, int heads, int n,
                                int j, int head_dim, int dtype, void* stream) {
  return launch_backward(q, k, v, bias, o, dout, lse, dq, dk, dv, scratch, batch, heads, n, j,
                         head_dim, dtype, false, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
