// Attention forward for Hopper: softmax(q k^T) v with the logits in float32,
// never written to device memory.
//
// Replaces the Pallas kernels of minimagen_tpu/ops/flash_attention.py:
//   _mqa_kernel (:92, launched by _mqa_forward) -> mmt_mqa_forward
//     q (b, h, n, d) pre-scaled, one K/V head shared by all heads: k, v (b, j, d)
//   _mha_kernel (:97, launched by _mha_forward) -> mmt_mha_forward
//     q (b, h, n, d), per-head k, v (b, h, j, d)
// No mask: the U-Net never passes one (padded text rows are replaced by
// learned null embeddings). j is odd on the main path (n + 1 for the null
// token of self-attention; 2 or 4 time tokens + 256 text tokens + 1 null for
// cross-attention), so the last K/V tile is ragged and masked here.
//
// What bounds it on the card: the work is 4*b*h*n*j*d operations over
// (q + k + v + o) bytes, so at the main path's shapes (n, j ~ 1024) it is
// compute-bound, and the products belong on the tensor cores.
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
// float32 (tests and the float32 reference run): one thread owns one query
// row on the CUDA cores, with K/V tiles of 32 keys broadcast from shared
// memory and the same online softmax.

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;  // ATTN_DIM_HEAD of the U-Net
constexpr int kBlockQ = 64;   // float32: query rows (= threads) per block
constexpr int kBlockK = 32;   // float32: keys per shared-memory tile

// K/V of (batch * heads + head) bh sit at index bh / kv_group: kv_group is
// the head count for multi-query (one K/V per sample), 1 for multi-head.

// ---- float32 on the CUDA cores ---------------------------------------------
__global__ void __launch_bounds__(kBlockQ)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int kv_group, int n,
                         int j) {
  __shared__ float ks[kBlockK][kHeadDim];
  __shared__ float vs[kBlockK][kHeadDim];

  const int bh = blockIdx.y;  // batch * heads + head
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < n;
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;
  const float* kp = k + kv_base;
  const float* vp = v + kv_base;

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
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < kBlockK; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) dot = fmaf(qr[c], ks[r][c], dot);
      s[r] = r < kt ? dot : -INFINITY;  // ragged tail of the last tile
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

__global__ void __launch_bounds__(kTcThreads)
    attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int kv_group, int n, int j) {
  __shared__ __align__(16) Tile qs[kTcRows];
  __shared__ __align__(16) Tile ks[kTcKeys];
  __shared__ __align__(16) Tile vs[kTcKeys];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;        // accumulator row / column pair
  const int mat = lane >> 3, mrow = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const size_t kv_base = static_cast<size_t>(bh / kv_group) * j * kHeadDim;

  load_tile<kTcRows>(qs, q + (static_cast<size_t>(bh) * n + q0) * kHeadDim, n - q0);
  __syncthreads();
  uint32_t qf[kHeadDim / 16][4];  // A fragments of this warp's 16 rows, 4 steps over d
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    ldmatrix_x4(qf[kk], &qs[warp * 16 + mrow + (mat & 1) * 8][kk * 16 + (mat >> 1) * 8]);

  float of[kHeadDim / 8][4] = {};  // output accumulator, 8 column tiles over d
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float row_sum[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int k0 = 0; k0 < j; k0 += kTcKeys) {
    const int kt = min(kTcKeys, j - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<kTcKeys>(ks, k + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
    load_tile<kTcKeys>(vs, v + kv_base + static_cast<size_t>(k0) * kHeadDim, kt);
    __syncthreads();

    float sf[kTcKeys / 8][4] = {};  // S = Q K^T, 8 column tiles of 8 keys
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, &ks[(np * 2 + (mat >> 1)) * 8 + mrow][kk * 16 + (mat & 1) * 8]);
        mma_bf16(sf[np * 2], qf[kk], b[0], b[1]);
        mma_bf16(sf[np * 2 + 1], qf[kk], b[2], b[3]);
      }
    }
    if (kt < kTcKeys) {  // ragged tail: keys past j
#pragma unroll
      for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t + (e & 1) >= kt) sf[nt][e] = -INFINITY;
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

    // O += P V: the S accumulators of two key tiles form one A fragment
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sf[2 * kk][0], sf[2 * kk][1]),
                              pack_bf16(sf[2 * kk][2], sf[2 * kk][3]),
                              pack_bf16(sf[2 * kk + 1][0], sf[2 * kk + 1][1]),
                              pack_bf16(sf[2 * kk + 1][2], sf[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &vs[kk * 16 + (mat & 1) * 8 + mrow][(dp * 2 + (mat >> 1)) * 8]);
        mma_bf16(of[dp * 2], pa, b[0], b[1]);
        mma_bf16(of[dp * 2 + 1], pa, b[2], b[3]);
      }
    }
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
    }
  }
}


int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int n, int j, int head_dim, int dtype, bool shared_kv, cudaStream_t stream) {
  if (head_dim != kHeadDim || batch <= 0 || heads <= 0 || n <= 0 || j <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_group = shared_kv ? heads : 1;
  if (dtype == mmt::kFloat32) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch * heads);
    attention_fwd_kernel<<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), kv_group, n, j);
  } else if (dtype == mmt::kBFloat16) {
    const dim3 grid((n + kTcRows - 1) / kTcRows, batch * heads);
    attention_fwd_bf16_kernel<<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), kv_group, n, j);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_mqa_forward(const void* q, const void* k, const void* v, void* o,
                               int batch, int heads, int n, int j, int head_dim, int dtype,
                               void* stream) {
  return launch(q, k, v, o, batch, heads, n, j, head_dim, dtype, true,
                static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_mha_forward(const void* q, const void* k, const void* v, void* o,
                               int batch, int heads, int n, int j, int head_dim, int dtype,
                               void* stream) {
  return launch(q, k, v, o, batch, heads, n, j, head_dim, dtype, false,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
