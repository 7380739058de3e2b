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
//     (also the unbiased _mha_bwd, :320, which the JAX package leaves to XLA)
// An optional float32 bias row per sample, (b, j), is added to the logits:
// the mask-derived bias of _mask_bias (0 keep, -1e30 drop). A null pointer
// means no bias, the U-Net's path. The forward optionally writes the row's
// log-sum-exp (float32, (b, h, n)), which the backward needs; sampling asks
// for none. j is odd on the main path (n + 1 for the null token of
// self-attention; 2 or 4 time tokens + 256 text tokens + 1 null for
// cross-attention), so the last K/V tile is ragged and masked here.
//
// Every bfloat16 call runs a Hopper kernel: warp-specialised blocks, one
// thread of a producer warpgroup keeping (64 rows x 64) bf16 tiles in flight
// into a ring of 4 stages with TMA (128-byte swizzle, 128-byte rows,
// completion on mbarriers; the consumers free a stage with an arrive), and
// consumer warpgroups running wgmma: S = Q K^T with both operands in shared
// memory, O += P V with P from registers (the float32 accumulator layout
// rounded to bf16 is the register A layout) and V through an MN-major
// descriptor. A consumer runs one tile behind on the tensor cores: it issues
// S of tile i + 1 and O += P V of tile i together, and takes the
// exponentials of tile i + 1 while O += P V runs; the last tile is peeled
// off so no product is issued under a branch (ptxas then keeps the wgmmas
// asynchronous). The lean softmax instance (no bias, no mask) runs on every
// full unbiased tile; O is rescaled only when a row's max moved. The online
// softmax keeps a float32 running max and row sum; P is rounded to bf16 as
// the A operand of P V (the TPU kernel's p.astype(v.dtype)) and O is divided
// by the row sum once at the end (its late divide).
//
// The backward is two passes, because the TPU kernels' way of summing dk/dv
// (a revisited output block across their sequential grid) has no
// counterpart when blocks run in no order:
//   1. Q-major: D = rowsum(dO * O) in float32 (from the stored O, one bf16
//      rounding away from the TPU kernel's sum(p * dp)), then over all key
//      tiles P = exp(S + bias - lse), dP = dO V^T, dS = P (dP - D),
//      dq += dS K. A row whose every key the bias drops is measured from its
//      floor and gets P = 1/j, as the TPU kernel's renormalised row
//      (dropped_row), in both passes.
//   2. K-major: a block owns key tiles (K and V loaded once) and walks the
//      query rows: S^T = K Q^T and dP^T = V dO^T rebuilt, dv += P^T dO,
//      dk += dS^T Q, in registers.
// No atomics: every sum is taken in a fixed order, so two runs give the same
// bits. P and dS are rounded to bf16 as the A operands of the last three
// products (the TPU kernel rounds dS for dq and keeps float32 for dk/dv).
//
// bfloat16 multi-query (self-attention), mqa_*_hopper_kernel. One K/V head
// serves all h heads of a sample, so the sample's queries are one (h * n, 64)
// matrix and a block takes 64 rows per consumer warpgroup across head
// boundaries: K/V is fetched once per 128 or 256 rows, and a block is full at
// n = 64. Forward: four consumer warpgroups (256 rows) where that still fills
// the SMs, else two. Pass 1 takes 128 rows across heads; pass 2 owns 128
// keys of a sample, walks the sample's rows of every head and sums dk/dv in
// registers over the heads; to fill the last wave the rows split into 1, 2
// or 4 fixed chunks (row_splits), whose float32 slices kv_reduce_kernel sums
// in chunk order. Bound at (16, 8, 1024, 1025): the forward's 34.4 GFLOP
// take 0.035 ms at 989 TFLOP/s and its 134M exponentials 0.033 ms on the
// SFUs (16 per SM per clock at 1.98 GHz), two rooflines of the same height,
// which is why the exponentials overlap the products; the backward (seven
// products, S and dP rebuilt in both passes) is 0.12 ms of tensor work.
//
// bfloat16 multi-head (cross-attention), mha_*_hopper_kernel. Per (sample,
// head) it is multi-query with one head: the n query rows of (b, h) are
// contiguous, a block owns 64 of them per consumer warpgroup, and its
// producer streams that head's K/V (tensor-map coordinate b * heads + head;
// the bias row is the sample's). The grid stays (tiles, heads, batch), so
// batch * heads may pass 65535. Bound at (16, 8, 1024, 259), the lite
// path's: the forward's 8.7 GFLOP take 0.0088 ms of tensor time and its 34M
// exponentials 0.0081 ms, but its ~42 MB of q, k, v and o take 0.0125 ms:
// it is byte-bound, so what counts is keeping every SM streaming (enough
// blocks in flight, loads ahead of the products) and wasting no tensor work
// on padding. The backward moves 0.0253 ms of bytes against 0.031 ms of
// tensor work with S and dP rebuilt in both passes. What the design does:
//   - The narrow ragged tail. At j = 259 or 261 the last 64-key tile holds 3
//     or 5 keys, ~19% of the tensor work if computed in full. The tail is
//     taken first (tile (j - 1) / 64; TMA zero-fills the box past j and those
//     logits are masked to -inf before the max) and, where it holds at most 16
//     keys, its S (and dP) is one m64n16 product per k16 step and its P V
//     (dq += dS K) one k16 step instead of four; the full tiles then run the
//     multi-query loop. Tail width is a template parameter (16 or 64), not a
//     branch around the products; where a branch does hold products (no
//     full tile, the tail's owner in pass 2) it holds whole fenced, committed
//     and waited groups, and ptxas keeps every wgmma asynchronous.
//   - Blocks that fill the card at every n on the path (n = 1024, 256, 64):
//     the forward takes the most consumer warpgroups of {4, 2, 1} that
//     divides the head's 64-row tiles (so no warpgroup is idle by design)
//     and still gives 15/16 of the SMs a block, else 1; pass 1 likewise of
//     {2, 1}. One warpgroup is a 256-thread block, two of which fit an SM.
//   - A forward block takes up to 4 row blocks of its head in turn (as many
//     as still fill the card), Q double-buffered and the ring running on
//     across them, so the next row block's loads overlap the current one's
//     products and stores: at (16, 8, 1024, 259) each block walks all 1024
//     rows of one head, one wave of 128 blocks.
//   - Pass 2 owns the full key tiles, two per block where their count is
//     even, and writes bf16 dk/dv straight from registers: no heads share
//     K/V, so no float32 per-head slices exist. Only where row_splits splits
//     the rows to fill the last wave does it keep float32 slices, summed in
//     fixed order by kv_reduce_kernel. A narrow tail (<= 16 keys) rides with
//     the warpgroup that owns the last full tile: per row tile it computes
//     S and dP of the tail as m64n16 products, stages P and dS (bf16) in
//     shared memory, and accumulates dv^T += dO^T P and dk^T += Q^T dS with
//     dO and Q read M-major, so no block walks the n rows for 3-5 keys.
//   - With the bias, pass 1's full tiles take each thread's 16 bias values
//     once and mask nothing (ds_tile_biased): the masked per-element loads
//     of the edge instance made the biased backward 1.5x the unbiased one.
//
// float32 (the train CLI without --BF16, the inference CLI, the float32
// references), attention_tf32_*_kernel: the same passes on the tensor cores
// in 3xTF32. A one-pass TF32 product keeps ~11 bits of each operand, ~1e-3
// relative, where the float32 kernels are held to 2e-5; so each operand x is
// split into big = tf32(x) (cvt.rna) and small = tf32(x - big), and a
// product is A_small B_big + A_big B_small + A_big B_big in float32
// accumulators (~22 bits; small x small is dropped). What bounds them is the
// tensor work: at (16, 8, 1024, 1025) the forward's 3 x 34.4 GFLOP take
// 0.208 ms at 495 TFLOP/s (TF32 dense), the backward's five products 0.52
// ms, against 0.51 and 1.28 ms of float32 products on the CUDA cores; the
// bytes (float32: 75.5 MB forward) take 0.023 ms. What the design does:
//   - wgmma takes tf32 from shared memory K-major only (no transposed
//     descriptor as for bf16), so the B operands of O += P V, dq += dS K,
//     dv += P^T dO and dk += dS^T Q are written transposed and split by a
//     pre-pass (attention_tf32_split_t_kernel, which also writes the
//     untransposed parts; attention_tf32_split_kernel), and TMA loads every
//     operand as (rows, 32-float) boxes with 128-byte swizzle: a 64-wide
//     row is two swizzle atoms. The forward's Q is split in shared memory
//     by its warpgroup, once per block. The pre-pass moves ~5x the inputs'
//     bytes: ~6% of the multi-query backward at (16, 8, 1024, 1025).
//   - The tensor cores' float32 sums truncate at each step: over the 8192
//     rows of a multi-query dk/dv that left ~1e-4 relative. A tile's
//     products go to a fresh accumulator, added on the CUDA cores (pass 2:
//     every kF32Window tiles, into float32 totals in shared memory).
//   - P and dS enter as register A fragments, split in registers; the
//     accumulator holds columns 2t, 2t + 1 of each 8 where the tf32 A layout
//     reads t, t + 4, so the transposed operands order each 8 keys (rows)
//     that way (split_a) and no shuffle is needed.
//   - Shared memory: a float32 tile is twice a bf16 one and the split doubles
//     it again, so the rings are 2 stages deep: the forward 64 keys a stage
//     (K and V^T, big and small: 64 KB) beside Q (32 KB a warpgroup), two
//     warpgroups where that fills the card (193 KB); pass 1 32 keys a stage
//     (K, V, K^T: 48 KB) beside Q and dO (64 KB a warpgroup; 225 KB for two);
//     pass 2 one warpgroup of 64 keys (K and V, 64 KB), 32 query rows a
//     stage (Q, dO, Q^T, dO^T: 64 KB) and the dk/dv totals (32 KB; 225 KB).
//     Pass 2 is the slowest part: with one consumer warpgroup an SM and
//     m64n32 products whose operands both come from shared memory, it
//     reaches ~30% of its bound (1.4 of 2.4 ms at the multi-query shape).
//   - As the bf16 kernels: warp-specialised blocks with one TMA producer
//     thread; one tile behind on the tensor cores; the last tile peeled off;
//     multi-query rows across heads and dk/dv summed over the heads in
//     registers (at most 4 row-split float32 slices, summed in fixed order);
//     dropped rows as dropped_row; no atomics.

#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver call comes through the runtime

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;  // ATTN_DIM_HEAD of the U-Net
constexpr int kMaxGridYZ = 65535;  // the most blocks along grid y or z

// Every launch's grid is (tiles, heads, batch): x walks the query rows or
// keys of one (sample, head), y the heads and z the samples, so batch and
// heads may each reach 65535 (batch * heads past 65535 included) and the
// blocks of one (sample, head) still run next to each other.
__device__ __forceinline__ int sample_head() {
  return static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
}

// A row whose every key the bias drops: all its logits sit at the mask floor
// (-1e30 absorbs S in float32), so its log-sum-exp is that floor and the
// log j term of floor + log j is lost to rounding. The backward measures such
// a row from its floor: S + bias - floor is 0 for every key, and the row's
// P = exp(0 - log j) = 1/j, the reference's renormalised row
// (_mha_bias_bwd_kernel). Every other row keeps floor 0 and its bits.
constexpr float kDroppedRowLse = -1e29f;  // a tenth of the mask floor

__device__ __forceinline__ bool dropped_row(float lse) { return lse < kDroppedRowLse; }

// ---- bfloat16 helpers ------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <typename T>
void launch_reduce(const float* dk_acc, const float* dv_acc, void* dk, void* dv, int parts,
                   int n_kv, int j, cudaStream_t stream) {
  const size_t per_kv = static_cast<size_t>(j) * kHeadDim;
  const size_t total = per_kv * n_kv;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 132 * 16));
  kv_reduce_kernel<T><<<blocks, 256, 0, stream>>>(dk_acc, dv_acc, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), parts, per_kv, total);
}

// ---- bfloat16 multi-query attention for Hopper: TMA ring + wgmma ----------
// (design note at the head of the file)
constexpr int kWgRows = 64;                     // rows of one consumer warpgroup: wgmma M
constexpr int kRingTile = 64;                   // keys (forward, dq) or rows (dk/dv) per stage
constexpr int kStages = 4;                      // depth of the TMA ring
constexpr int kTileBytes = 64 * kHeadDim * 2;   // one (64, 64) bf16 tile: 128-byte rows, 8 KB
constexpr int kMaxRowSplits = 4;                // dk/dv: most float32 partial slices per sample
constexpr int kSmemAlign = 1024;                // 128-byte swizzle atoms: 8 rows of 128 B

// Shared memory of each kernel with kWgs consumer warpgroups, alignment
// slack included: the tiles loaded once, the ring, then the barriers.
constexpr int fwd_smem(int wgs) {
  return kSmemAlign + wgs * kTileBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
}
constexpr int dq_smem(int wgs) {
  return kSmemAlign + 2 * wgs * kTileBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
}
constexpr int dkdv_smem(int wgs) {
  return kSmemAlign + 2 * wgs * kTileBytes + 2 * kStages * kTileBytes +
         2 * kStages * kRingTile * 4 + 8 * (1 + 2 * kStages);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of `parity` has completed. A wait that lasts ~10 s
// means a copy never landed: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_flat(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int c0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(0)
      : "memory");
}

// wgmma shared-memory descriptor of a (64, 64) bf16 tile written by TMA with
// 128-byte swizzle: 8-row groups 1024 B apart. `lbo` is 16 B for a K-major
// operand (unused there) and 1024 B for an MN-major one.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait (the asynchronous product owns the registers between).
template <int kR>
__device__ __forceinline__ void fence_regs(float (&r)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define MMT_WGMMA_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MMT_WGMMA_OUT32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, float32) (+)= A B, A and B both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MMT_WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A B, A (64 x 16) from registers, B (16 x 64) an
// MN-major shared tile (rows of B contiguous).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : MMT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 16, float32) (+)= A B, both from shared memory: B K-major, A
// K-major (kTransA 0) or M-major (kTransA 1, A's rows contiguous).
template <int kTransA>
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA));
}

// acc = A B^T over the 64 columns of two K-major (64, 64) tiles: S = Q K^T,
// dP = dO V^T, S^T = K Q^T, dP^T = V dO^T. Issued, not waited for.
__device__ __forceinline__ void gemm_abt(float (&acc)[32], uint32_t a_tile, uint32_t b_tile) {
  const uint64_t da = tile_desc(a_tile, 16), db = tile_desc(b_tile, 16);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) wgmma_ss(acc, da + 2 * kk, db + 2 * kk, kk);
}

// acc (64 x 16) = A B^T for the first 16 rows of the K-major tile B: S and
// dP of a narrow key tail (at most 16 keys). Issued, not waited for.
__device__ __forceinline__ void gemm_abt(float (&acc)[8], uint32_t a_tile, uint32_t b_tile) {
  const uint64_t da = tile_desc(a_tile, 16), db = tile_desc(b_tile, 16);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) wgmma_ss16<0>(acc, da + 2 * kk, db + 2 * kk, kk);
}

// acc (64 x 16) += A^T B over the 64 rows of both: A a (64, 64) tile read
// M-major (rows of the tile are the contraction, as the MN-major B of
// gemm_pb), B a K-major (16, 64) tile staged by stage_kmajor: dv^T += dO^T P
// and dk^T += Q^T dS of a narrow key tail. Issued, not waited for.
__device__ __forceinline__ void gemm_atb(float (&acc)[8], uint32_t a_tile, uint32_t b_tile) {
  const uint64_t da = tile_desc(a_tile, 1024), db = tile_desc(b_tile, 16);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss16<1>(acc, da + 128 * kk, db + 2 * kk, 1);
}

// acc += P B: P the (64, 64) float32 accumulator `p` as bf16 register A
// operands (packed by pack_a), B a (64, 64) tile whose rows are P's columns:
// O += P V, dq += dS K, dv += P^T dO, dk += dS^T Q. Issued, not waited for.
__device__ __forceinline__ void gemm_pb(float (&acc)[32], const uint32_t (&pa)[4][4],
                                        uint32_t b_tile) {
  const uint64_t db = tile_desc(b_tile, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pa[kk], db + 128 * kk);  // 16 rows = 2048 B
}

// acc += P B over one k16 step: P the (64, 16) accumulator of a narrow key
// tail packed by pack_a, B the first 16 rows of a tile: O += P V and
// dq += dS K of the tail. Issued, not waited for.
__device__ __forceinline__ void gemm_pb(float (&acc)[32], const uint32_t (&pa)[1][4],
                                        uint32_t b_tile) {
  wgmma_rs(acc, pa[0], tile_desc(b_tile, 1024));
}

// The float32 accumulator layout of a 64 x 64 tile (d[4c + 2i + e] at row
// 16 * warp + g + 8i, column 8c + 2t + e) rounded to bf16 is the register A
// layout of four k16 steps.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4], const float (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// pack_a of a 64 x 16 accumulator: one k16 step.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[1][4], const float (&p)[8]) {
  pa[0][0] = pack_bf16(p[0], p[1]);
  pa[0][1] = pack_bf16(p[2], p[3]);
  pa[0][2] = pack_bf16(p[4], p[5]);
  pa[0][3] = pack_bf16(p[6], p[7]);
}

__device__ __forceinline__ uint32_t align_smem(const void* raw) {
  return (smem_addr(raw) + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
}

__device__ __forceinline__ float fast_exp2(float x) {  // MUFU.EX2; exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The ring's barriers: `full` completes when a stage's copies have landed,
// `empty` when every consumer warp is done with it.
template <int kS>
struct StageRing {
  uint32_t full0, empty0;
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
  __device__ static uint32_t parity(int it) { return (it / kS) & 1; }
};
using Ring = StageRing<kStages>;

// One-time setup by thread 0: the "loaded once" barrier and the ring.
template <int kWgs, int kS = kStages>
__device__ __forceinline__ StageRing<kS> init_barriers(uint32_t bars) {
  const StageRing<kS> ring{bars + 8, bars + 8 + 8 * kS};
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 4 * kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int kS>
__device__ __forceinline__ void release(const StageRing<kS>& ring, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty(s));
}

// Registers move from the producer warpgroup (24 a thread) to the consumers,
// within the block's pool (65536 / threads a thread at launch, in steps of
// 8): 240 each for two consumer warpgroups, 112 for four.
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
}
// One consumer warpgroup keeps the registers it was compiled with.
template <int kWgs>
__device__ __forceinline__ void consumer_registers() {
  static_assert(kWgs == 1 || kWgs == 2 || kWgs == 4, "one, two or four consumer warpgroups");
  if constexpr (kWgs == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else if constexpr (kWgs == 4) asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
}

// The producer's loop over key tiles (forward, dq): K and V of tile `it`
// into stage it % kStages once the consumers have released it.
__device__ __forceinline__ void produce_kv(const Ring& ring, const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, uint32_t k_s, uint32_t v_s,
                                           int sample, int tiles) {
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(ring.empty(s), Ring::parity(it) ^ 1);
    mbar_expect_tx(ring.full(s), 2 * kTileBytes);
    tma_load_3d(k_s + s * kTileBytes, k_map, ring.full(s), 0, it * kRingTile, sample);
    tma_load_3d(v_s + s * kTileBytes, v_map, ring.full(s), 0, it * kRingTile, sample);
  }
}

// The online softmax of one 64-key tile of S (this thread's two rows, 16
// columns each), in place: the bias added and keys past j masked (only
// where kEdge: a biased call or the ragged last tile), the running max and
// this thread's share of the row sums updated, S replaced by
// P = exp(S - max); returns in `corr` the factor the output must take.
// kExact: exp2((S - max) log2e) instead of the fused multiply-add with
// -max log2e, whose rounding (~1e23 at max = -1e30) is fatal where every key
// so far was dropped by the bias.
template <bool kEdge, bool kExact = false, int kR = 32>  // kR 32 (64 keys) or 8 (16 keys)
__device__ __forceinline__ void softmax_tile(float (&s_acc)[kR], float (&row_max)[2],
                                             float (&row_sum)[2], float (&corr)[2],
                                             const float* brow, int k0, int kt, int t) {
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < kR / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s_acc[4 * c + e];
      if constexpr (kEdge) {
        const int col = 8 * c + 2 * t + (e & 1);
        if (brow != nullptr && col < kt) x += __ldg(brow + k0 + col);
        x = col < kt ? x : -INFINITY;  // ragged tail: keys past j
        s_acc[4 * c + e] = x;
      }
      tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
    }
  float neg_max[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the 4 threads of a quad share a row
    tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
    tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
    const float new_max = fmaxf(row_max[i], tile_max[i]);  // finite: key k0 is valid
    corr[i] = fast_exp2((row_max[i] - new_max) * kLog2e);  // 0 on the first tile
    row_max[i] = new_max;
    row_sum[i] *= corr[i];
    neg_max[i] = -new_max * kLog2e;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float p = kExact ? fast_exp2((s_acc[r] - row_max[(r >> 1) & 1]) * kLog2e)
                           : fast_exp2(fmaf(s_acc[r], kLog2e, neg_max[(r >> 1) & 1]));  // 0 when masked
    row_sum[(r >> 1) & 1] += p;
    s_acc[r] = p;
  }
}

// softmax_tile for key tile `tile`: the lean instance unless the tile is
// biased or ragged (warp-uniform branch); a biased tile is always exact, since
// the bias may drop every key of a row.
template <bool kExact = false>
__device__ __forceinline__ void softmax_at(float (&s_acc)[32], float (&row_max)[2],
                                           float (&row_sum)[2], float (&corr)[2],
                                           const float* brow, int tile, int j, int t) {
  const int k0 = tile * kRingTile, kt = min(kRingTile, j - k0);
  if (brow != nullptr)
    softmax_tile<true, true>(s_acc, row_max, row_sum, corr, brow, k0, kt, t);
  else if (kt < kRingTile)
    softmax_tile<true, kExact>(s_acc, row_max, row_sum, corr, brow, k0, kt, t);
  else
    softmax_tile<false>(s_acc, row_max, row_sum, corr, brow, k0, kt, t);
}

// O *= corr, skipped when no row of the warp changed its max (corr == 1),
// as happens on most tiles once the max has settled.
__device__ __forceinline__ void rescale(float (&o_acc)[32], const float (&corr)[2]) {
  if (__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
  for (int r = 0; r < 32; ++r) o_acc[r] *= corr[(r >> 1) & 1];
}

// Forward. Grid (ceil(rows / (64 kWgs)), batch), rows = heads * n: a block
// owns 64 kWgs consecutive rows of the sample's (rows, 64) queries, across
// heads; consumer warpgroup wg the wg-th 64. Each consumer runs one tile
// behind on the tensor cores: while O += P V of tile it runs, it takes the
// exponentials of tile it + 1, whose S it issued just before.
template <int kWgs>
__global__ void __launch_bounds__(128 * (kWgs + 1), 1)
    mqa_fwd_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int rows, int j) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t k_s = q_s + kWgs * kTileBytes, v_s = k_s + kStages * kTileBytes;
  const uint32_t q_full = v_s + kStages * kTileBytes;
  const Ring ring = init_barriers<kWgs>(q_full);
  const int sample = blockIdx.y, row0 = blockIdx.x * kWgs * kWgRows;
  const int tiles = (j + kRingTile - 1) / kRingTile;
  const int warp = threadIdx.x >> 5;

  if (warp < 4) {  // producer warpgroup: one thread issues every copy
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kWgs * kTileBytes);
      for (int h = 0; h < kWgs; ++h)
        tma_load_3d(q_s + h * kTileBytes, &q_map, q_full, 0, row0 + h * kWgRows, sample);
      produce_kv(ring, &k_map, &v_map, k_s, v_s, sample, tiles);
    }
    return;
  }
  consumer_registers<kWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_q = q_s + wg * kTileBytes;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(sample) * j;

  float o_acc[32], s_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this thread's share of the two rows' sums
  float corr[2];

  mbar_wait(q_full, 0);
  mbar_wait(ring.full(0), 0);
  wgmma_fence();
  gemm_abt(s_acc, my_q, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s_acc);
  softmax_at(s_acc, row_max, row_sum, corr, brow, 0, j, t);

  // every tile but the last: issue S of the next tile and O += P V of this
  // one, then take the next tile's exponentials while O += P V runs (the
  // last tile is peeled off, so no product is issued under a branch)
  for (int it = 0; it + 1 < tiles; ++it) {
    const int s = it % kStages, sn = (it + 1) % kStages;
    uint32_t pa[4][4];
    pack_a(pa, s_acc);
    rescale(o_acc, corr);
    mbar_wait(ring.full(sn), Ring::parity(it + 1));
    fence_regs(s_acc);
    fence_regs(o_acc);
    wgmma_fence();
    gemm_abt(s_acc, my_q, k_s + sn * kTileBytes);  // into the registers P was packed from
    wgmma_commit();
    wgmma_fence();
    gemm_pb(o_acc, pa, v_s + s * kTileBytes);  // O += P V
    wgmma_commit();
    wgmma_wait<1>();  // the next S is done; O += P V may still run
    fence_regs(s_acc);
    softmax_at(s_acc, row_max, row_sum, corr, brow, it + 1, j, t);
    wgmma_wait<0>();
    fence_regs(o_acc);
    release(ring, s);
  }
  {
    uint32_t pa[4][4];
    pack_a(pa, s_acc);
    rescale(o_acc, corr);
    fence_regs(o_acc);
    wgmma_fence();
    gemm_pb(o_acc, pa, v_s + ((tiles - 1) % kStages) * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    release(ring, (tiles - 1) % kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float total = row_sum[i];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (row < rows) {
      const size_t r = static_cast<size_t>(sample) * rows + row;
      __nv_bfloat16* op = o + r * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c)  // the late divide
        *reinterpret_cast<uint32_t*>(op + 8 * c + 2 * t) =
            pack_bf16(o_acc[4 * c + 2 * i] / total, o_acc[4 * c + 2 * i + 1] / total);
      if (lse != nullptr && t == 0) lse[r] = row_max[i] + logf(total);
    }
  }
}

// dS of one 64-key tile for this thread's two rows, in place of S:
// P = exp(S + bias - lse), 0 past j (bias and mask only where kEdge);
// dS = P (dP - D). Where kEdge the logits are first measured from the row's
// floor (row_scalars: 0, or the mask floor of a dropped row, whose neg_lse
// is then -log2 j).
template <bool kEdge, int kR>  // kR = 32 (64 keys) or 8 (a 16-key tail)
__device__ __forceinline__ void ds_tile(float (&s_acc)[kR], const float (&dp_acc)[kR],
                                        const float (&neg_lse)[2], const float (&floor_r)[2],
                                        const float (&d_r)[2], const float* brow, int k0, int kt,
                                        int t) {
#pragma unroll
  for (int c = 0; c < kR / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * c + 2 * t + (e & 1), i = e >> 1;
      float x = s_acc[4 * c + e];
      if constexpr (kEdge) {
        if (brow != nullptr && col < kt) x += __ldg(brow + k0 + col);
        x -= floor_r[i];
      }
      float p = fast_exp2(fmaf(x, kLog2e, neg_lse[i]));
      if constexpr (kEdge) p = col < kt ? p : 0.f;
      s_acc[4 * c + e] = p * (dp_acc[4 * c + e] - d_r[i]);
    }
}

// ds_tile for key tile `tile` of 2 kR keys (warp-uniform branch).
template <int kR>
__device__ __forceinline__ void ds_at(float (&s_acc)[kR], const float (&dp_acc)[kR],
                                      const float (&neg_lse)[2], const float (&floor_r)[2],
                                      const float (&d_r)[2], const float* brow, int tile, int j,
                                      int t) {
  const int k0 = tile * 2 * kR, kt = min(2 * kR, j - k0);
  if (brow != nullptr || kt < 2 * kR)
    ds_tile<true>(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, k0, kt, t);
  else
    ds_tile<false>(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, k0, kt, t);
}

// The per-row scalars of pass 1 from the row's log-sum-exp `l` (+inf past
// the rows: P = 0): the floor its logits are measured from and -lse log2e,
// for a dropped row its floor and -log2 j.
__device__ __forceinline__ void row_scalars(float l, int j, float& floor_r, float& neg_lse) {
  const bool dropped = dropped_row(l);
  floor_r = dropped ? l : 0.f;
  neg_lse = dropped ? -log2f(static_cast<float>(j)) : -l * kLog2e;
}

// Backward pass 1 (Q-major). Grid (ceil(rows / 128), batch), a block's 128
// rows across heads as in the forward: D = rowsum(dO * O) of the block's
// rows into `delta`, then over all key tiles S = Q K^T,
// dP = dO V^T, dS = P (dP - D), dq += dS K; one tile behind on the tensor
// cores as the forward (dS of tile it + 1 while dq += dS K of tile it runs).
constexpr int kBwdWgs = 2;  // consumer warpgroups of the backward passes

__global__ void __launch_bounds__(128 * (kBwdWgs + 1), 1)
    mqa_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ bias, const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ delta, float* __restrict__ lse_copy, int rows,
                             int rows32, int j) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t do_s = q_s + kBwdWgs * kTileBytes;
  const uint32_t k_s = do_s + kBwdWgs * kTileBytes, v_s = k_s + kStages * kTileBytes;
  const uint32_t rows_full = v_s + kStages * kTileBytes;
  const Ring ring = init_barriers<kBwdWgs>(rows_full);
  const int sample = blockIdx.y, row0 = blockIdx.x * kBwdWgs * kWgRows;
  const int tiles = (j + kRingTile - 1) / kRingTile;
  const int warp = threadIdx.x >> 5;

  if (warp < 4) {
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(rows_full, 2 * kBwdWgs * kTileBytes);
      for (int h = 0; h < kBwdWgs; ++h) {
        tma_load_3d(q_s + h * kTileBytes, &q_map, rows_full, 0, row0 + h * kWgRows, sample);
        tma_load_3d(do_s + h * kTileBytes, &do_map, rows_full, 0, row0 + h * kWgRows, sample);
      }
      produce_kv(ring, &k_map, &v_map, k_s, v_s, sample, tiles);
    }
    return;
  }
  consumer_registers<kBwdWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_q = q_s + wg * kTileBytes, my_do = do_s + wg * kTileBytes;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(sample) * j;

  // D and the log-sum-exp of this thread's two rows: each of a quad's 4
  // threads sums 16 of the 64 columns
  float d_r[2], neg_lse[2], floor_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    const bool valid = row < rows;
    const size_t r = static_cast<size_t>(sample) * rows + (valid ? row : 0);
    float acc = 0.f;
    if (valid) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + r * kHeadDim + t * 16 + h * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + r * kHeadDim + t * 16 + h * 8);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
        const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(de[e]), __bfloat162float(oe[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    d_r[i] = acc;
    const float l = valid ? lse[r] : INFINITY;  // past the sample: P = 0
    row_scalars(l, j, floor_r[i], neg_lse[i]);
    if (valid && t == 0) {
      const size_t r32 = static_cast<size_t>(sample) * rows32 + row;
      delta[r32] = acc;
      lse_copy[r32] = l;
    }
  }

  float dq_acc[32], s_acc[32], dp_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  mbar_wait(rows_full, 0);
  mbar_wait(ring.full(0), 0);
  wgmma_fence();
  gemm_abt(s_acc, my_q, k_s);
  gemm_abt(dp_acc, my_do, v_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s_acc);
  fence_regs(dp_acc);
  ds_at(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, 0, j, t);

  for (int it = 0; it + 1 < tiles; ++it) {  // the last tile peeled off, as the forward
    const int s = it % kStages, sn = (it + 1) % kStages;
    uint32_t pa[4][4];
    pack_a(pa, s_acc);
    mbar_wait(ring.full(sn), Ring::parity(it + 1));
    fence_regs(s_acc);
    fence_regs(dp_acc);
    fence_regs(dq_acc);
    wgmma_fence();
    gemm_abt(s_acc, my_q, k_s + sn * kTileBytes);
    gemm_abt(dp_acc, my_do, v_s + sn * kTileBytes);
    wgmma_commit();
    wgmma_fence();
    gemm_pb(dq_acc, pa, k_s + s * kTileBytes);  // dq += dS K
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    ds_at(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, it + 1, j, t);
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(ring, s);
  }
  {
    uint32_t pa[4][4];
    pack_a(pa, s_acc);
    fence_regs(dq_acc);
    wgmma_fence();
    gemm_pb(dq_acc, pa, k_s + ((tiles - 1) % kStages) * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(ring, (tiles - 1) % kStages);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (row < rows) {
      __nv_bfloat16* dst = dq + (static_cast<size_t>(sample) * rows + row) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c + 2 * t) =
            pack_bf16(dq_acc[4 * c + 2 * i], dq_acc[4 * c + 2 * i + 1]);
    }
  }
}

// P^T and dS^T of one 64-row tile for this thread's two keys, in place of
// S^T and dP^T; rows past the sample (only in a ragged tile) get P = 0, a
// dropped row (its lse the mask floor) 1/j: fmaf(x, log2e, 0) rounds as the
// product alone, so every other row keeps its bits.
template <bool kEdge, int kR>  // kR = 32 (64 rows) or 16 (32 rows)
__device__ __forceinline__ void dst_tile(float (&st)[kR], float (&dpt)[kR], const float* ls,
                                         const float* ds, const float (&b_key)[2], int valid_rows,
                                         float neg_log2_j, int t) {
#pragma unroll
  for (int c = 0; c < kR / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * c + 2 * t + (e & 1);
      float l = ls[col], d = ds[col];
      if constexpr (kEdge) {
        l = col < valid_rows ? l : INFINITY;
        d = col < valid_rows ? d : 0.f;
      }
      const float adj = dropped_row(l) ? neg_log2_j : 0.f;
      const float p = fast_exp2(fmaf(st[4 * c + e] + b_key[e >> 1] - l, kLog2e, adj));
      st[4 * c + e] = p;
      dpt[4 * c + e] = p * (dpt[4 * c + e] - d);
    }
}

template <int kR>
__device__ __forceinline__ void dst_at(float (&st)[kR], float (&dpt)[kR], const float* ls,
                                       const float* ds, const float (&b_key)[2], int valid_rows,
                                       float neg_log2_j, int t) {
  if (valid_rows < 2 * kR)
    dst_tile<true>(st, dpt, ls, ds, b_key, valid_rows, neg_log2_j, t);
  else
    dst_tile<false>(st, dpt, ls, ds, b_key, valid_rows, neg_log2_j, t);
}

// Backward pass 2 (K/V-major). Grid (ceil(j / 128) * splits, batch): a
// block owns 128 keys of one sample (64 per consumer warpgroup, K and V
// loaded once) and walks row tiles [split * T / splits, (split + 1) * T /
// splits) of the sample's T = ceil(rows / 64), every head: S^T = K Q^T,
// dP^T = V dO^T, dv += P^T dO, dk += dS^T Q, summed in registers over the
// heads, one tile behind on the tensor cores as the forward. One split
// writes dk/dv in bf16; more write float32 slices (sample, split) that
// kv_reduce_kernel sums in split order.
__global__ void __launch_bounds__(128 * (kBwdWgs + 1), 1)
    mqa_bwd_dkdv_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap lse_map,
                               const __grid_constant__ CUtensorMap delta_map,
                               const float* __restrict__ bias, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, float* __restrict__ dk_acc,
                               float* __restrict__ dv_acc, int rows, int rows32, int j,
                               int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = align_smem(smem_raw);
  const uint32_t v_s = k_s + kBwdWgs * kTileBytes;
  const uint32_t q_s = v_s + kBwdWgs * kTileBytes, do_s = q_s + kStages * kTileBytes;
  const uint32_t lse_s = do_s + kStages * kTileBytes;
  const uint32_t delta_s = lse_s + kStages * kRingTile * 4;
  const uint32_t kv_full = delta_s + kStages * kRingTile * 4;
  const Ring ring = init_barriers<kBwdWgs>(kv_full);
  const int sample = blockIdx.y;
  const int key_block = blockIdx.x / splits, split = blockIdx.x % splits;
  const int key0 = key_block * kBwdWgs * kWgRows;
  const int row_tiles = (rows + kRingTile - 1) / kRingTile;
  const int t_begin = split * row_tiles / splits, t_end = (split + 1) * row_tiles / splits;
  const int tiles = t_end - t_begin;
  const int warp = threadIdx.x >> 5;

  if (warp < 4) {
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * kBwdWgs * kTileBytes);
      for (int h = 0; h < kBwdWgs; ++h) {
        tma_load_3d(k_s + h * kTileBytes, &k_map, kv_full, 0, key0 + h * kWgRows, sample);
        tma_load_3d(v_s + h * kTileBytes, &v_map, kv_full, 0, key0 + h * kWgRows, sample);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages, r0 = (t_begin + it) * kRingTile;
        const int flat = sample * rows32 + r0;  // lse / delta: rows at sample * rows32
        mbar_wait(ring.empty(s), Ring::parity(it) ^ 1);
        mbar_expect_tx(ring.full(s), 2 * kTileBytes + 2 * kRingTile * 4);
        tma_load_3d(q_s + s * kTileBytes, &q_map, ring.full(s), 0, r0, sample);
        tma_load_3d(do_s + s * kTileBytes, &do_map, ring.full(s), 0, r0, sample);
        tma_load_flat(lse_s + s * kRingTile * 4, &lse_map, ring.full(s), flat);
        tma_load_flat(delta_s + s * kRingTile * 4, &delta_map, ring.full(s), flat);
      }
    }
    return;
  }
  consumer_registers<kBwdWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_k = k_s + wg * kTileBytes, my_v = v_s + wg * kTileBytes;
  // generic pointers to the ring's lse and delta rows
  const float* lse_p = reinterpret_cast<const float*>(smem_raw + (lse_s - smem_addr(smem_raw)));
  const float* delta_p = reinterpret_cast<const float*>(smem_raw + (delta_s - smem_addr(smem_raw)));
  float b_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + wg * kWgRows + w * 16 + g + 8 * i;
    b_key[i] = (bias != nullptr && key < j) ? bias[static_cast<size_t>(sample) * j + key] : 0.f;
  }

  float dk_r[32], dv_r[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_r[i] = dv_r[i] = 0.f;
  mbar_wait(kv_full, 0);
  mbar_wait(ring.full(0), 0);  // tiles >= 1: row_splits keeps splits <= row tiles
  wgmma_fence();
  gemm_abt(st, my_k, q_s);    // S^T: rows are keys, columns query rows
  gemm_abt(dpt, my_v, do_s);  // dP^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  const float neg_log2_j = -log2f(static_cast<float>(j));
  dst_at(st, dpt, lse_p, delta_p, b_key, rows - t_begin * kRingTile, neg_log2_j, t);
  for (int it = 0; it + 1 < tiles; ++it) {  // the last tile peeled off, as the forward
    const int s = it % kStages, sn = (it + 1) % kStages;
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, dpt);
    mbar_wait(ring.full(sn), Ring::parity(it + 1));
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dv_r);
    fence_regs(dk_r);
    wgmma_fence();
    gemm_abt(st, my_k, q_s + sn * kTileBytes);
    gemm_abt(dpt, my_v, do_s + sn * kTileBytes);
    wgmma_commit();
    wgmma_fence();
    gemm_pb(dv_r, pa, do_s + s * kTileBytes);  // dv += P^T dO
    gemm_pb(dk_r, da, q_s + s * kTileBytes);   // dk += dS^T Q
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    fence_regs(dpt);
    dst_at(st, dpt, lse_p + sn * kRingTile, delta_p + sn * kRingTile, b_key,
           rows - (t_begin + it + 1) * kRingTile, neg_log2_j, t);
    wgmma_wait<0>();
    fence_regs(dv_r);
    fence_regs(dk_r);
    release(ring, s);
  }
  {
    const int s = (tiles - 1) % kStages;
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, dpt);
    fence_regs(dv_r);
    fence_regs(dk_r);
    wgmma_fence();
    gemm_pb(dv_r, pa, do_s + s * kTileBytes);
    gemm_pb(dk_r, da, q_s + s * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_r);
    fence_regs(dk_r);
    release(ring, s);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (key >= j) continue;
    if (splits == 1) {
      const size_t out = (static_cast<size_t>(sample) * j + key) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + out + 8 * c + 2 * t) =
            pack_bf16(dk_r[4 * c + 2 * i], dk_r[4 * c + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + out + 8 * c + 2 * t) =
            pack_bf16(dv_r[4 * c + 2 * i], dv_r[4 * c + 2 * i + 1]);
      }
    } else {
      const size_t out = ((static_cast<size_t>(sample) * splits + split) * j + key) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<float2*>(dk_acc + out + 8 * c + 2 * t) =
            make_float2(dk_r[4 * c + 2 * i], dk_r[4 * c + 2 * i + 1]);
        *reinterpret_cast<float2*>(dv_acc + out + 8 * c + 2 * t) =
            make_float2(dv_r[4 * c + 2 * i], dv_r[4 * c + 2 * i + 1]);
      }
    }
  }
}

// ---- bfloat16 multi-head attention for Hopper: TMA ring + wgmma -----------
// (design note at the head of the file). The forward and pass 1 take the key
// tiles of (sample, head) bh tail first: the tail, tile full = (j - 1) / 64
// with keys 64 full .. j - 1, at ring position pos0, then the full tiles
// 0 .. full - 1 at positions pos0 + 1 .. pos0 + full.
__device__ __forceinline__ void produce_kv_tail_first(const Ring& ring, const CUtensorMap* k_map,
                                                      const CUtensorMap* v_map, uint32_t k_s,
                                                      uint32_t v_s, int bh, int full,
                                                      int pos0 = 0) {
  for (int l = 0; l <= full; ++l) {
    const int pos = pos0 + l, s = pos % kStages, key0 = (l == 0 ? full : l - 1) * kRingTile;
    mbar_wait(ring.empty(s), Ring::parity(pos) ^ 1);
    mbar_expect_tx(ring.full(s), 2 * kTileBytes);
    tma_load_3d(k_s + s * kTileBytes, k_map, ring.full(s), 0, key0, bh);
    tma_load_3d(v_s + s * kTileBytes, v_map, ring.full(s), 0, key0, bh);
  }
}

// Shared memory of the MHA forward: two buffers of kWgs query tiles, the
// ring, then the barriers (two "Q landed", two "Q free", the ring's).
constexpr int mha_fwd_smem(int wgs) {
  return kSmemAlign + 2 * wgs * kTileBytes + 2 * kStages * kTileBytes + 8 * (4 + 2 * kStages);
}

// Forward. Grid (ceil(row_blocks / items), heads, batch), row_blocks =
// ceil(n / (64 kWgs)): a block takes `items` consecutive blocks of 64 kWgs
// query rows of one (sample, head) in turn (consumer warpgroup wg the wg-th
// 64 rows of each), so one block's loads of the next item overlap the
// products and stores of the current one: Q is double-buffered (a buffer is
// freed once the item's last S is done) and the ring's positions run on
// across items. Per item: the tail, kTail keys wide (16, or 64 where it
// holds more than 16 keys), then the full tiles one behind on the tensor
// cores as the multi-query forward, the tail's O = P V issued with S of the
// first full tile.
template <int kWgs, int kTail>
__global__ void __launch_bounds__(128 * (kWgs + 1), kWgs == 1 ? 2 : 1)
    mha_fwd_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int n, int j, int items) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t k_s = q_s + 2 * kWgs * kTileBytes, v_s = k_s + kStages * kTileBytes;
  const uint32_t bars = v_s + kStages * kTileBytes;
  const auto q_full = [&](int b) { return bars + 8 * b; };
  const auto q_free = [&](int b) { return bars + 16 + 8 * b; };
  const Ring ring{bars + 32, bars + 32 + 8 * kStages};
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_free(b), 4 * kWgs);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 4 * kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int bh = sample_head(), row_blocks = (n + kWgs * kWgRows - 1) / (kWgs * kWgRows);
  const int first = blockIdx.x * items, n_items = min(items, row_blocks - first);
  const int full = (j - 1) / kRingTile;
  const int warp = threadIdx.x >> 5;

  if (warp < 4) {  // producer warpgroup: one thread issues every copy
    producer_registers();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_items; ++i) {
        const int b = i & 1, row0 = (first + i) * kWgs * kWgRows;
        mbar_wait(q_free(b), ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(b), kWgs * kTileBytes);
        for (int h = 0; h < kWgs; ++h)
          tma_load_3d(q_s + (b * kWgs + h) * kTileBytes, &q_map, q_full(b), 0,
                      row0 + h * kWgRows, bh);
        produce_kv_tail_first(ring, &k_map, &v_map, k_s, v_s, bh, full, i * (full + 1));
      }
    }
    return;
  }
  consumer_registers<kWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(blockIdx.z) * j;

  for (int i = 0; i < n_items; ++i) {
    const int b = i & 1, pos = i * (full + 1);  // ring position of this item's tail
    const uint32_t my_q = q_s + (b * kWgs + wg) * kTileBytes;
    float o_acc[32], s_acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) o_acc[r] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // this thread's share of the two rows' sums
    float corr[2];

    // the tail: keys past j read as zeros and are masked to -inf
    const int st = pos % kStages;
    float s_tail[kTail / 2];
    uint32_t pt[kTail / 16][4];
    mbar_wait(q_full(b), (i >> 1) & 1);
    mbar_wait(ring.full(st), Ring::parity(pos));
    wgmma_fence();
    gemm_abt(s_tail, my_q, k_s + st * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_tail);
    softmax_tile<true, true>(s_tail, row_max, row_sum, corr, brow, full * kRingTile,
                             j - full * kRingTile, t);
    pack_a(pt, s_tail);
    fence_regs(o_acc);
    if (full == 0) {  // the tail alone: O = P V
      warp_arrive(q_free(b));
      wgmma_fence();
      gemm_pb(o_acc, pt, v_s + st * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      release(ring, st);
    } else {  // full tile f at ring position pos + 1 + f
      // S of full tile 0 and the tail's O = P V together
      const int s1 = (pos + 1) % kStages;
      mbar_wait(ring.full(s1), Ring::parity(pos + 1));
      wgmma_fence();
      gemm_abt(s_acc, my_q, k_s + s1 * kTileBytes);
      wgmma_commit();
      wgmma_fence();
      gemm_pb(o_acc, pt, v_s + st * kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s_acc);
      softmax_at<true>(s_acc, row_max, row_sum, corr, brow, 0, j, t);
      wgmma_wait<0>();
      fence_regs(o_acc);
      release(ring, st);
      for (int f = 0; f + 1 < full; ++f) {  // the last full tile peeled off
        const int s = (pos + 1 + f) % kStages, sn = (pos + 2 + f) % kStages;
        uint32_t pa[4][4];
        pack_a(pa, s_acc);
        rescale(o_acc, corr);
        mbar_wait(ring.full(sn), Ring::parity(pos + 2 + f));
        fence_regs(s_acc);
        fence_regs(o_acc);
        wgmma_fence();
        gemm_abt(s_acc, my_q, k_s + sn * kTileBytes);
        wgmma_commit();
        wgmma_fence();
        gemm_pb(o_acc, pa, v_s + s * kTileBytes);  // O += P V
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s_acc);
        softmax_at<true>(s_acc, row_max, row_sum, corr, brow, f + 1, j, t);
        wgmma_wait<0>();
        fence_regs(o_acc);
        release(ring, s);
      }
      warp_arrive(q_free(b));  // every S of the item is done: Q's buffer is free
      const int s = (pos + full) % kStages;
      uint32_t pa[4][4];
      pack_a(pa, s_acc);
      rescale(o_acc, corr);
      fence_regs(o_acc);
      wgmma_fence();
      gemm_pb(o_acc, pa, v_s + s * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      release(ring, s);
    }

    const int row0 = (first + i) * kWgs * kWgRows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float total = row_sum[h];
      total += __shfl_xor_sync(0xffffffffu, total, 1);
      total += __shfl_xor_sync(0xffffffffu, total, 2);
      const int row = row0 + wg * kWgRows + w * 16 + g + 8 * h;
      if (row < n) {
        const size_t r = static_cast<size_t>(bh) * n + row;
        __nv_bfloat16* op = o + r * kHeadDim;
#pragma unroll
        for (int c = 0; c < 8; ++c)  // the late divide
          *reinterpret_cast<uint32_t*>(op + 8 * c + 2 * t) =
              pack_bf16(o_acc[4 * c + 2 * h] / total, o_acc[4 * c + 2 * h + 1] / total);
        if (lse != nullptr && t == 0) lse[r] = row_max[h] + logf(total);
      }
    }
  }
}

// ds_tile of a full 64-key tile with the bias, `bcol` its first key's entry
// of the bias row: each thread's 16 bias values loaded once, nothing masked
// (the multi-head pass 1's biased full tiles).
__device__ __forceinline__ void ds_tile_biased(float (&s_acc)[32], const float (&dp_acc)[32],
                                               const float (&neg_lse)[2],
                                               const float (&floor_r)[2], const float (&d_r)[2],
                                               const float* bcol, int t) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float b[2] = {__ldg(bcol + 8 * c + 2 * t), __ldg(bcol + 8 * c + 2 * t + 1)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s_acc[4 * c + e] + b[e & 1] - floor_r[e >> 1];
      const float p = fast_exp2(fmaf(x, kLog2e, neg_lse[e >> 1]));
      s_acc[4 * c + e] = p * (dp_acc[4 * c + e] - d_r[e >> 1]);
    }
  }
}

// dS of full key tile `tile` in the multi-head pass 1 (warp-uniform branch).
__device__ __forceinline__ void mha_ds_full(float (&s_acc)[32], const float (&dp_acc)[32],
                                            const float (&neg_lse)[2], const float (&floor_r)[2],
                                            const float (&d_r)[2], const float* brow, int tile,
                                            int t) {
  if (brow != nullptr)
    ds_tile_biased(s_acc, dp_acc, neg_lse, floor_r, d_r, brow + tile * kRingTile, t);
  else
    ds_tile<false>(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, 0, kRingTile, t);
}

// Backward pass 1 (Q-major). Grid (ceil(n / (64 kWgs)), heads, batch), a
// block's rows as in the forward: D = rowsum(dO * O) into `delta`, then the
// tail (S and dP kTail keys wide, dq = dS K over kTail / 16 steps) and the
// full tiles one behind on the tensor cores as the multi-query pass 1.
template <int kWgs, int kTail>
__global__ void __launch_bounds__(128 * (kWgs + 1), 1)
    mha_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ bias, const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ delta, float* __restrict__ lse_copy, int n,
                             int n32, int j) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t do_s = q_s + kWgs * kTileBytes;
  const uint32_t k_s = do_s + kWgs * kTileBytes, v_s = k_s + kStages * kTileBytes;
  const uint32_t rows_full = v_s + kStages * kTileBytes;
  const Ring ring = init_barriers<kWgs>(rows_full);
  const int bh = sample_head(), row0 = blockIdx.x * kWgs * kWgRows;
  const int full = (j - 1) / kRingTile;
  const int warp = threadIdx.x >> 5;

  if (warp < 4) {
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(rows_full, 2 * kWgs * kTileBytes);
      for (int h = 0; h < kWgs; ++h) {
        tma_load_3d(q_s + h * kTileBytes, &q_map, rows_full, 0, row0 + h * kWgRows, bh);
        tma_load_3d(do_s + h * kTileBytes, &do_map, rows_full, 0, row0 + h * kWgRows, bh);
      }
      produce_kv_tail_first(ring, &k_map, &v_map, k_s, v_s, bh, full);
    }
    return;
  }
  consumer_registers<kWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_q = q_s + wg * kTileBytes, my_do = do_s + wg * kTileBytes;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(blockIdx.z) * j;

  // D and the log-sum-exp of this thread's two rows: each of a quad's 4
  // threads sums 16 of the 64 columns
  float d_r[2], neg_lse[2], floor_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    const bool valid = row < n;
    const size_t r = static_cast<size_t>(bh) * n + (valid ? row : 0);
    float acc = 0.f;
    if (valid) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + r * kHeadDim + t * 16 + h * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + r * kHeadDim + t * 16 + h * 8);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
        const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(de[e]), __bfloat162float(oe[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    d_r[i] = acc;
    const float l = valid ? lse[r] : INFINITY;  // past n: P = 0
    row_scalars(l, j, floor_r[i], neg_lse[i]);
    if (valid && t == 0) {
      const size_t r32 = static_cast<size_t>(bh) * n32 + row;
      delta[r32] = acc;
      lse_copy[r32] = l;
    }
  }

  float dq_acc[32], s_acc[32], dp_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  mbar_wait(rows_full, 0);
  mbar_wait(ring.full(0), 0);
  {  // the tail
    float s_tail[kTail / 2], dp_tail[kTail / 2];
    uint32_t pa[kTail / 16][4];
    wgmma_fence();
    gemm_abt(s_tail, my_q, k_s);
    gemm_abt(dp_tail, my_do, v_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_tail);
    fence_regs(dp_tail);
    ds_tile<true>(s_tail, dp_tail, neg_lse, floor_r, d_r, brow, full * kRingTile,
                  j - full * kRingTile, t);
    pack_a(pa, s_tail);
    fence_regs(dq_acc);
    wgmma_fence();
    gemm_pb(dq_acc, pa, k_s);  // dq = dS K (dq is zero)
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(ring, 0);
  }
  if (full > 0) {  // full tile i at ring position i + 1
    const int s1 = 1 % kStages;
    mbar_wait(ring.full(s1), Ring::parity(1));
    wgmma_fence();
    gemm_abt(s_acc, my_q, k_s + s1 * kTileBytes);
    gemm_abt(dp_acc, my_do, v_s + s1 * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    mha_ds_full(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, 0, t);
    for (int it = 0; it + 1 < full; ++it) {  // the last full tile peeled off
      const int s = (it + 1) % kStages, sn = (it + 2) % kStages;
      uint32_t pa[4][4];
      pack_a(pa, s_acc);
      mbar_wait(ring.full(sn), Ring::parity(it + 2));
      fence_regs(s_acc);
      fence_regs(dp_acc);
      fence_regs(dq_acc);
      wgmma_fence();
      gemm_abt(s_acc, my_q, k_s + sn * kTileBytes);
      gemm_abt(dp_acc, my_do, v_s + sn * kTileBytes);
      wgmma_commit();
      wgmma_fence();
      gemm_pb(dq_acc, pa, k_s + s * kTileBytes);  // dq += dS K
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      mha_ds_full(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, it + 1, t);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      release(ring, s);
    }
    const int s = full % kStages;
    uint32_t pa[4][4];
    pack_a(pa, s_acc);
    fence_regs(dq_acc);
    wgmma_fence();
    gemm_pb(dq_acc, pa, k_s + s * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(ring, s);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (row < n) {
      __nv_bfloat16* dst = dq + (static_cast<size_t>(bh) * n + row) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c + 2 * t) =
            pack_bf16(dq_acc[4 * c + 2 * i], dq_acc[4 * c + 2 * i + 1]);
    }
  }
}

constexpr int kStagedBytes = 16 * 128;  // a K-major (16, 64) bf16 tile: one 128 B row a key

// The (64 rows, 16 keys) accumulator `x` rounded to bf16 into a K-major
// (16 keys, 64 rows) tile at generic address `tile` (1024-aligned), in TMA's
// 128-byte swizzle (16-byte chunk c of line r at chunk c ^ (r % 8)): the B
// operand of gemm_atb.
__device__ __forceinline__ void stage_kmajor(uint8_t* tile, const float (&x)[8], int w, int g,
                                             int t) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * c + 2 * t + (e & 1), row = 16 * w + g + 8 * (e >> 1);
      const int off = key * 128 + (((row >> 3) ^ (key & 7)) << 4) + (row & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(tile + off) = __float2bfloat16_rn(x[4 * c + e]);
    }
}

// Shared-memory tiles of a narrow key tail in pass 2: its K and V (TMA), and
// its P and dS of the current row tile (staged; shared addresses and generic
// pointers).
struct TailTiles {
  uint32_t k, v, p, ds;
  uint8_t *p_gen, *ds_gen;
};

// The narrow tail's share of one row tile of pass 2 (at most 16 keys, taken
// by the warpgroup that owns the last full key tile): S = Q K^T and
// dP = dO V^T as m64n16 products (rows x keys), P = exp(S + bias - lse) and
// dS = P (dP - D), 0 past j and past n, staged as K-major bf16 tiles, then
// dv^T += dO^T P and dk^T += Q^T dS (dims x keys) with dO and Q read M-major.
// Every product is waited for here.
__device__ __forceinline__ void tail_kv_step(float (&dkt)[8], float (&dvt)[8], uint32_t q_tile,
                                             uint32_t do_tile, const TailTiles& tail,
                                             const float* ls, const float* ds,
                                             const float* tail_bias, int kt, int valid_rows,
                                             float neg_log2_j, int w, int g, int t) {
  float st[8], dpt[8];
  wgmma_fence();
  gemm_abt(st, q_tile, tail.k);
  gemm_abt(dpt, do_tile, tail.v);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * c + 2 * t + (e & 1), row = 16 * w + g + 8 * (e >> 1);
      const bool valid = key < kt && row < valid_rows;
      const float b = (tail_bias != nullptr && key < kt) ? __ldg(tail_bias + key) : 0.f;
      const float l = ls[row], adj = dropped_row(l) ? neg_log2_j : 0.f;
      const float p = valid ? fast_exp2(fmaf(st[4 * c + e] + b - l, kLog2e, adj)) : 0.f;
      dpt[4 * c + e] = valid ? p * (dpt[4 * c + e] - ds[row]) : 0.f;
      st[4 * c + e] = p;
    }
  stage_kmajor(tail.p_gen, st, w, g, t);
  stage_kmajor(tail.ds_gen, dpt, w, g, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, 128;\n" ::: "memory");                 // this warpgroup's stores
  fence_regs(dkt);
  fence_regs(dvt);
  wgmma_fence();
  gemm_atb(dvt, do_tile, tail.p);
  gemm_atb(dkt, q_tile, tail.ds);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dkt);
  fence_regs(dvt);
}

// Backward pass 2 (K-major). Grid (key_blocks * splits, heads, batch): a
// block owns kWgs key tiles of one (sample, head) (64 keys a consumer
// warpgroup, K and V loaded once) and walks row tiles [split * T / splits,
// (split + 1) * T / splits) of the head's T = ceil(n / 64): S^T = K Q^T,
// dP^T = V dO^T, dv += P^T dO, dk += dS^T Q, one tile behind on the tensor
// cores as the multi-query pass 2. Where kTail, the key tiles are the full
// ones and the last block's last warpgroup also takes the narrow tail
// (tail_kv_step). One split writes dk/dv in bf16; more write float32 slices
// (sample-head, split) that kv_reduce_kernel sums in split order.
template <int kWgs, bool kTail>
__global__ void __launch_bounds__(128 * (kWgs + 1), 1)
    mha_bwd_dkdv_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap lse_map,
                               const __grid_constant__ CUtensorMap delta_map,
                               const float* __restrict__ bias, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, float* __restrict__ dk_acc,
                               float* __restrict__ dv_acc, int n, int n32, int j, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = align_smem(smem_raw);
  const uint32_t v_s = k_s + kWgs * kTileBytes;
  const uint32_t q_s = v_s + kWgs * kTileBytes, do_s = q_s + kStages * kTileBytes;
  const uint32_t tail_s = do_s + kStages * kTileBytes;  // tail K, V, then staged P, dS
  const uint32_t lse_s = tail_s + (kTail ? 2 * kTileBytes + 2 * kStagedBytes : 0);
  const uint32_t delta_s = lse_s + kStages * kRingTile * 4;
  const uint32_t kv_full = delta_s + kStages * kRingTile * 4;
  const Ring ring = init_barriers<kWgs>(kv_full);
  const int bh = sample_head();
  const int key_block = blockIdx.x / splits, split = blockIdx.x % splits;
  const int key0 = key_block * kWgs * kWgRows;
  const int full = (j - 1) / kRingTile;
  const bool tail_block = kTail && key_block == static_cast<int>(gridDim.x) / splits - 1;
  const int row_tiles = (n + kRingTile - 1) / kRingTile;
  const int t_begin = split * row_tiles / splits, t_end = (split + 1) * row_tiles / splits;
  const int tiles = t_end - t_begin;
  const int warp = threadIdx.x >> 5;

  if (warp < 4) {
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, (2 * kWgs + (tail_block ? 2 : 0)) * kTileBytes);
      for (int h = 0; h < kWgs; ++h) {
        tma_load_3d(k_s + h * kTileBytes, &k_map, kv_full, 0, key0 + h * kWgRows, bh);
        tma_load_3d(v_s + h * kTileBytes, &v_map, kv_full, 0, key0 + h * kWgRows, bh);
      }
      if (tail_block) {
        tma_load_3d(tail_s, &k_map, kv_full, 0, full * kRingTile, bh);
        tma_load_3d(tail_s + kTileBytes, &v_map, kv_full, 0, full * kRingTile, bh);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages, r0 = (t_begin + it) * kRingTile;
        const int flat = bh * n32 + r0;  // lse / delta: rows at (sample, head) * n32
        mbar_wait(ring.empty(s), Ring::parity(it) ^ 1);
        mbar_expect_tx(ring.full(s), 2 * kTileBytes + 2 * kRingTile * 4);
        tma_load_3d(q_s + s * kTileBytes, &q_map, ring.full(s), 0, r0, bh);
        tma_load_3d(do_s + s * kTileBytes, &do_map, ring.full(s), 0, r0, bh);
        tma_load_flat(lse_s + s * kRingTile * 4, &lse_map, ring.full(s), flat);
        tma_load_flat(delta_s + s * kRingTile * 4, &delta_map, ring.full(s), flat);
      }
    }
    return;
  }
  consumer_registers<kWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_k = k_s + wg * kTileBytes, my_v = v_s + wg * kTileBytes;
  const auto generic = [&](uint32_t addr) { return smem_raw + (addr - smem_addr(smem_raw)); };
  const float* lse_p = reinterpret_cast<const float*>(generic(lse_s));
  const float* delta_p = reinterpret_cast<const float*>(generic(delta_s));
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(blockIdx.z) * j;
  const bool tail_owner = tail_block && wg == kWgs - 1;
  const TailTiles tail{tail_s, tail_s + kTileBytes, tail_s + 2 * kTileBytes,
                       tail_s + 2 * kTileBytes + kStagedBytes, generic(tail_s + 2 * kTileBytes),
                       generic(tail_s + 2 * kTileBytes + kStagedBytes)};
  const float* tail_bias = brow == nullptr ? nullptr : brow + full * kRingTile;
  const int tail_kt = j - full * kRingTile;
  float b_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + wg * kWgRows + w * 16 + g + 8 * i;
    b_key[i] = (brow != nullptr && key < j) ? brow[key] : 0.f;
  }

  float dk_r[32], dv_r[32], st[32], dpt[32], dkt[8], dvt[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_r[i] = dv_r[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dkt[i] = dvt[i] = 0.f;
  mbar_wait(kv_full, 0);
  mbar_wait(ring.full(0), 0);  // tiles >= 1: row_splits keeps splits <= row tiles
  wgmma_fence();
  gemm_abt(st, my_k, q_s);    // S^T: rows are keys, columns query rows
  gemm_abt(dpt, my_v, do_s);  // dP^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  const float neg_log2_j = -log2f(static_cast<float>(j));
  dst_at(st, dpt, lse_p, delta_p, b_key, n - t_begin * kRingTile, neg_log2_j, t);
  for (int it = 0; it + 1 < tiles; ++it) {  // the last tile peeled off
    const int s = it % kStages, sn = (it + 1) % kStages;
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, dpt);
    mbar_wait(ring.full(sn), Ring::parity(it + 1));
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dv_r);
    fence_regs(dk_r);
    wgmma_fence();
    gemm_abt(st, my_k, q_s + sn * kTileBytes);
    gemm_abt(dpt, my_v, do_s + sn * kTileBytes);
    wgmma_commit();
    wgmma_fence();
    gemm_pb(dv_r, pa, do_s + s * kTileBytes);  // dv += P^T dO
    gemm_pb(dk_r, da, q_s + s * kTileBytes);   // dk += dS^T Q
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    fence_regs(dpt);
    dst_at(st, dpt, lse_p + sn * kRingTile, delta_p + sn * kRingTile, b_key,
           n - (t_begin + it + 1) * kRingTile, neg_log2_j, t);
    wgmma_wait<0>();
    fence_regs(dv_r);
    fence_regs(dk_r);
    if (tail_owner)
      tail_kv_step(dkt, dvt, q_s + s * kTileBytes, do_s + s * kTileBytes, tail,
                   lse_p + s * kRingTile, delta_p + s * kRingTile, tail_bias, tail_kt,
                   n - (t_begin + it) * kRingTile, neg_log2_j, w, g, t);
    release(ring, s);
  }
  {
    const int s = (tiles - 1) % kStages;
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, dpt);
    fence_regs(dv_r);
    fence_regs(dk_r);
    wgmma_fence();
    gemm_pb(dv_r, pa, do_s + s * kTileBytes);
    gemm_pb(dk_r, da, q_s + s * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_r);
    fence_regs(dk_r);
    if (tail_owner)
      tail_kv_step(dkt, dvt, q_s + s * kTileBytes, do_s + s * kTileBytes, tail,
                   lse_p + s * kRingTile, delta_p + s * kRingTile, tail_bias, tail_kt,
                   n - (t_begin + tiles - 1) * kRingTile, neg_log2_j, w, g, t);
    release(ring, s);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (key >= j) continue;
    if (splits == 1) {
      const size_t out = (static_cast<size_t>(bh) * j + key) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + out + 8 * c + 2 * t) =
            pack_bf16(dk_r[4 * c + 2 * i], dk_r[4 * c + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + out + 8 * c + 2 * t) =
            pack_bf16(dv_r[4 * c + 2 * i], dv_r[4 * c + 2 * i + 1]);
      }
    } else {
      const size_t out = ((static_cast<size_t>(bh) * splits + split) * j + key) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<float2*>(dk_acc + out + 8 * c + 2 * t) =
            make_float2(dk_r[4 * c + 2 * i], dk_r[4 * c + 2 * i + 1]);
        *reinterpret_cast<float2*>(dv_acc + out + 8 * c + 2 * t) =
            make_float2(dv_r[4 * c + 2 * i], dv_r[4 * c + 2 * i + 1]);
      }
    }
  }
  if (tail_owner) {  // dk^T, dv^T of the tail: rows are the 64 dims, columns its keys
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = full * kRingTile + 8 * c + 2 * t + (e & 1);
        const int dim = 16 * w + g + 8 * (e >> 1);
        if (key >= j) continue;
        if (splits == 1) {
          const size_t out = (static_cast<size_t>(bh) * j + key) * kHeadDim + dim;
          dk[out] = __float2bfloat16_rn(dkt[4 * c + e]);
          dv[out] = __float2bfloat16_rn(dvt[4 * c + e]);
        } else {
          const size_t out =
              ((static_cast<size_t>(bh) * splits + split) * j + key) * kHeadDim + dim;
          dk_acc[out] = dkt[4 * c + e];
          dv_acc[out] = dvt[4 * c + e];
        }
      }
  }
}

// ---- float32 attention for Hopper: 3xTF32 on wgmma -------------------------
// (design note at the head of the file). Each float32 operand x enters the
// tensor cores as two tf32 parts, big = tf32(x) and small = tf32(x - big),
// and a product A B is taken as A_small B_big + A_big B_small + A_big B_big
// in float32 accumulators. wgmma reads tf32 from shared memory K-major only,
// so every operand whose contraction runs over keys or query rows (V in
// O += P V, K in dq += dS K, dO and Q in dv += P^T dO and dk += dS^T Q) is
// written transposed by attention_tf32_split_t_kernel, already split (in
// the backward the same read also writes q, dO and K split in their own
// layout); V in the backward and K in the forward are split by
// attention_tf32_split_kernel, and the forward splits Q in shared memory.
// A P or dS accumulator enters as register A fragments.
// q-batch qb: a sample (multi-query, its rows the h * n rows across heads)
// or a (sample, head) (multi-head, its n rows); its K/V are the same index,
// its bias row qb / bias_div.
constexpr int kF32Stages = 2;                      // depth of the float32 rings
constexpr int kF32Tile = 64 * kHeadDim * 4;        // (64, 64) float32: two swizzle atoms, 16 KB
constexpr int kF32Half = kF32Tile / 2;             // (32, 64) or (64, 32) float32, 8 KB
constexpr int kF32Keys1 = 32;                      // keys per ring stage of pass 1
constexpr int kF32Rows2 = 32;                      // query rows per ring stage of pass 2
constexpr int kF32Window = 4;  // pass 2: row tiles summed on the tensor cores between flushes
constexpr int kF32Totals = 64 * 128 * 4;  // pass 2: dk, dv float32 totals, 64 per thread

using F32Ring = StageRing<kF32Stages>;

constexpr int f32_fwd_smem(int wgs) {  // Q raw/big and small per warpgroup, ring of Kb Ks VTb VTs
  return kSmemAlign + 2 * wgs * kF32Tile + 4 * kF32Stages * kF32Tile + 8 * (1 + 2 * kF32Stages);
}
constexpr int f32_dq_smem(int wgs) {  // Qb Qs dOb dOs per warpgroup, ring of Kb Ks Vb Vs KTb KTs
  return kSmemAlign + 4 * wgs * kF32Tile + 6 * kF32Stages * kF32Half + 8 * (1 + 2 * kF32Stages);
}
constexpr int f32_dkdv_smem() {  // Kb Ks Vb Vs, ring of Qb Qs dOb dOs QTb QTs dOTb dOTs, lse,
                                 // D; dk/dv totals
  return kSmemAlign + 4 * kF32Tile + kF32Stages * (8 * kF32Half + 2 * kF32Rows2 * 4) +
         kF32Totals + 8 * (1 + 2 * kF32Stages);
}
static_assert(f32_dq_smem(2) <= 232448 && f32_dkdv_smem() <= 232448,
              "a float32 backward pass exceeds the shared memory of a block");

__device__ __forceinline__ uint32_t tf32_rna(float x) {  // round to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to ~2^-22 |x|: big = tf32(x), small = tf32(x - big) (exact difference)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Byte offset of k8 step kk in a K-major float32 tile of `rows` rows: 32
// floats (128 bytes) of each row per swizzle atom, atoms `rows` * 128 B apart.
__host__ __device__ constexpr uint32_t kstep_off(int kk, int rows) {
  return static_cast<uint32_t>((kk >> 2) * rows * 128 + (kk & 3) * 32);
}

#define MMT_WGMMA_D16                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MMT_WGMMA_OUT16(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x 64 or 64 x 32, float32) (+)= A B over one k8 step, tf32 A and B
// K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MMT_WGMMA_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : MMT_WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " MMT_WGMMA_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : MMT_WGMMA_OUT16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) (+)= A B over one k8 step, A (64 x 8) tf32 from
// registers, B a K-major tf32 tile in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MMT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MMT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// acc (64 x 2 kR) = A B^T over d = 64 in 3xTF32: A a 64-row tile and B a
// (2 kR)-row tile, each K-major over d (two swizzle atoms) in big and small
// parts: S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T. The small
// products first. Issued, not waited for.
template <int kR>
__device__ __forceinline__ void gemm_abt_x3(float (&acc)[kR], uint32_t a_big, uint32_t a_small,
                                            uint32_t b_big, uint32_t b_small) {
  const uint64_t ab = tile_desc(a_big, 16), as = tile_desc(a_small, 16);
  const uint64_t bb = tile_desc(b_big, 16), bs = tile_desc(b_small, 16);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk) {
    const uint32_t oa = kstep_off(kk, 64) >> 4, ob = kstep_off(kk, 2 * kR) >> 4;
    wgmma_tf32(acc, as + oa, bb + ob, kk);
    wgmma_tf32(acc, ab + oa, bs + ob, 1);
    wgmma_tf32(acc, ab + oa, bb + ob, 1);
  }
}

// acc (64 x 64) (+)= P B over 8 kSteps keys (or rows) in 3xTF32: P in
// registers as big and small A fragments (split_a), B a 64-row tile K-major
// over them (tf32_split_t's order): O = P V, dq = dS K, dv += P^T dO,
// dk += dS^T Q; kFresh overwrites acc. Issued, not waited for.
template <bool kFresh, int kSteps>
__device__ __forceinline__ void gemm_pb_x3(float (&acc)[32], const uint32_t (&pb)[kSteps][4],
                                           const uint32_t (&ps)[kSteps][4], uint32_t b_big,
                                           uint32_t b_small) {
  const uint64_t bb = tile_desc(b_big, 16), bs = tile_desc(b_small, 16);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t ob = kstep_off(kk, 64) >> 4;
    wgmma_tf32(acc, ps[kk], bb + ob, kFresh && kk == 0 ? 0 : 1);
    wgmma_tf32(acc, pb[kk], bs + ob, 1);
    wgmma_tf32(acc, pb[kk], bb + ob, 1);
  }
}

// acc += tile on the CUDA cores, rounded to nearest: the promotion of the
// tensor cores' truncating sums (header note).
__device__ __forceinline__ void add_regs(float (&acc)[32], const float (&tile)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tile[i];
}

// The float32 accumulator p of a 64 x (8 kSteps) tile as big and small tf32
// A fragments, one per k8 step. Thread (g, t) holds columns 2t and 2t + 1 of
// each 8, where the A layout reads columns t and t + 4: so column i of a k8
// step's B is key (or row) perm(i) = i < 4 ? 2i : 2(i - 4) + 1 of those 8,
// the order attention_tf32_split_t_kernel writes.
template <int kSteps>
__device__ __forceinline__ void split_a(uint32_t (&pb)[kSteps][4], uint32_t (&ps)[kSteps][4],
                                        const float (&p)[4 * kSteps]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    split_tf32(p[4 * kk + 0], pb[kk][0], ps[kk][0]);  // row g,     column t
    split_tf32(p[4 * kk + 2], pb[kk][1], ps[kk][1]);  // row g + 8, column t
    split_tf32(p[4 * kk + 1], pb[kk][2], ps[kk][2]);  // row g,     column t + 4
    split_tf32(p[4 * kk + 3], pb[kk][3], ps[kk][3]);  // row g + 8, column t + 4
  }
}

// The big and small tf32 parts of `count4` float4s, same layout.
__global__ void attention_tf32_split_kernel(const float4* __restrict__ x, float4* __restrict__ big,
                                            float4* __restrict__ small, size_t count4) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < count4;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[e];
    uint32_t b[4], s[4];
    split_tf32(v.x, b[0], s[0]);
    split_tf32(v.y, b[1], s[1]);
    split_tf32(v.z, b[2], s[2]);
    split_tf32(v.w, b[3], s[3]);
    big[e] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                         __uint_as_float(b[3]));
    small[e] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                           __uint_as_float(s[3]));
  }
}

// (batch, rows, 64) float32 transposed to (batch, 64, rows_pad) in big and
// small tf32 parts, zero past `rows`; within each 8 columns, column i holds
// row perm(i) (split_a). Where `big` is not null, also the parts in x's own
// layout (attention_tf32_split_kernel's), from the same read. One block per
// 32 rows of a batch entry.
__global__ void __launch_bounds__(256)
    attention_tf32_split_t_kernel(const float* __restrict__ x, float* __restrict__ big,
                                  float* __restrict__ small, float* __restrict__ big_t,
                                  float* __restrict__ small_t, int rows, int rows_pad) {
  __shared__ float tile[32][kHeadDim + 1];
  const int tiles = rows_pad / 32;
  const size_t b = blockIdx.x / tiles;
  const int r0 = static_cast<int>(blockIdx.x % tiles) * 32;
  for (int e = threadIdx.x; e < 32 * kHeadDim; e += 256) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const size_t at = (b * rows + r0 + r) * kHeadDim + c;
    const float v = r0 + r < rows ? x[at] : 0.f;
    tile[r][c] = v;
    if (big != nullptr && r0 + r < rows) {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      big[at] = __uint_as_float(hi);
      small[at] = __uint_as_float(lo);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * kHeadDim; e += 256) {
    const int c = e / 32, p = e % 32, i = p & 7;
    const int src = (p & ~7) + (i < 4 ? 2 * i : 2 * (i - 4) + 1);
    uint32_t hi, lo;
    split_tf32(tile[src][c], hi, lo);
    const size_t out = (b * kHeadDim + c) * rows_pad + r0 + p;
    big_t[out] = __uint_as_float(hi);
    small_t[out] = __uint_as_float(lo);
  }
}

// Rows r0 .. r0 + box_rows - 1 of entry b of a (batch, rows, 64) float32
// map (boxes of 32 floats) into two swizzle atoms at dst.
__device__ __forceinline__ void tma_rows_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int r0, int b, int box_rows) {
  tma_load_3d(dst, map, bar, 0, r0, b);
  tma_load_3d(dst + box_rows * 128, map, bar, 32, r0, b);
}

// Columns c0 .. c0 + 32 atoms - 1 of entry b of a (batch, 64, cols) map
// (boxes of 64 rows x 32 floats): `atoms` swizzle atoms at dst.
__device__ __forceinline__ void tma_cols_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c0, int b, int atoms) {
  for (int a = 0; a < atoms; ++a) tma_load_3d(dst + a * kF32Half, map, bar, c0 + 32 * a, 0, b);
}

// The consumer warpgroup's (64, 64) float32 tile at `tile` split in place
// into its big part, the small part to `small` (same swizzled layout), and
// made visible to wgmma once the warpgroup has passed a barrier. `tid` is
// the thread's index in the warpgroup.
__device__ __forceinline__ void split_in_smem(uint8_t* tile, uint8_t* small, int tid) {
  float4* x = reinterpret_cast<float4*>(tile);
  float4* lo = reinterpret_cast<float4*>(small);
#pragma unroll 4
  for (int e = tid; e < kF32Tile / 16; e += 128) {
    const float4 v = x[e];
    uint32_t b[4], s[4];
    split_tf32(v.x, b[0], s[0]);
    split_tf32(v.y, b[1], s[1]);
    split_tf32(v.z, b[2], s[2]);
    split_tf32(v.w, b[3], s[3]);
    x[e] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                       __uint_as_float(b[3]));
    lo[e] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                        __uint_as_float(s[3]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Forward, float32. Grid (ceil(rows / (64 kWgs)), heads or 1, batch): a
// block owns 64 kWgs rows of q-batch qb, consumer warpgroup wg the wg-th 64;
// the producer streams K (big, small) and V^T (big, small) of 64 keys a
// stage. Each consumer runs one tile behind on the tensor cores as the bf16
// forward: S of tile it + 1 is issued with O += P V of tile it.
template <int kWgs>
__global__ void __launch_bounds__(128 * (kWgs + 1), 1)
    attention_tf32_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap kb_map,
                              const __grid_constant__ CUtensorMap ks_map,
                              const __grid_constant__ CUtensorMap vtb_map,
                              const __grid_constant__ CUtensorMap vts_map,
                              const float* __restrict__ bias, float* __restrict__ o,
                              float* __restrict__ lse, int rows, int j, int bias_div) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = align_smem(smem_raw);
  const uint32_t qs_s = q_s + kWgs * kF32Tile;
  const uint32_t ring_s = qs_s + kWgs * kF32Tile;  // a stage: Kb, Ks, VTb, VTs
  const uint32_t q_full = ring_s + kF32Stages * 4 * kF32Tile;
  const F32Ring ring = init_barriers<kWgs, kF32Stages>(q_full);
  const int qb = sample_head(), row0 = blockIdx.x * kWgs * kWgRows;
  const int tiles = (j + kRingTile - 1) / kRingTile;
  const int warp = threadIdx.x >> 5;
  const auto stage = [&](int s) { return ring_s + s * 4 * kF32Tile; };

  if (warp < 4) {  // producer warpgroup: one thread issues every copy
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kWgs * kF32Tile);
      for (int h = 0; h < kWgs; ++h)
        tma_rows_f32(q_s + h * kF32Tile, &q_map, q_full, row0 + h * kWgRows, qb, 64);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kF32Stages;
        mbar_wait(ring.empty(s), F32Ring::parity(it) ^ 1);
        mbar_expect_tx(ring.full(s), 4 * kF32Tile);
        tma_rows_f32(stage(s), &kb_map, ring.full(s), it * kRingTile, qb, 64);
        tma_rows_f32(stage(s) + kF32Tile, &ks_map, ring.full(s), it * kRingTile, qb, 64);
        tma_cols_f32(stage(s) + 2 * kF32Tile, &vtb_map, ring.full(s), it * kRingTile, qb, 2);
        tma_cols_f32(stage(s) + 3 * kF32Tile, &vts_map, ring.full(s), it * kRingTile, qb, 2);
      }
    }
    return;
  }
  consumer_registers<kWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_q = q_s + wg * kF32Tile, my_qs = qs_s + wg * kF32Tile;
  const auto generic = [&](uint32_t addr) { return smem_raw + (addr - smem_addr(smem_raw)); };
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(qb / bias_div) * j;

  float o_acc[32], o_tile[32], s_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this thread's share of the two rows' sums
  float corr[2];

  mbar_wait(q_full, 0);
  split_in_smem(generic(my_q), generic(my_qs), threadIdx.x & 127);
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");  // this warpgroup's split
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
  mbar_wait(ring.full(0), 0);
  wgmma_fence();
  gemm_abt_x3(s_acc, my_q, my_qs, stage(0), stage(0) + kF32Tile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s_acc);
  softmax_at(s_acc, row_max, row_sum, corr, brow, 0, j, t);

  for (int it = 0; it + 1 < tiles; ++it) {  // the last tile peeled off
    const int s = it % kF32Stages, sn = (it + 1) % kF32Stages;
    uint32_t pb[8][4], ps[8][4];
    split_a(pb, ps, s_acc);
    rescale(o_acc, corr);
    mbar_wait(ring.full(sn), F32Ring::parity(it + 1));
    fence_regs(s_acc);
    fence_regs(o_tile);
    wgmma_fence();
    gemm_abt_x3(s_acc, my_q, my_qs, stage(sn), stage(sn) + kF32Tile);
    wgmma_commit();
    wgmma_fence();
    gemm_pb_x3<true>(o_tile, pb, ps, stage(s) + 2 * kF32Tile, stage(s) + 3 * kF32Tile);  // P V
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s_acc);
    softmax_at(s_acc, row_max, row_sum, corr, brow, it + 1, j, t);
    wgmma_wait<0>();
    fence_regs(o_tile);
    add_regs(o_acc, o_tile);
    release(ring, s);
  }
  {
    const int s = (tiles - 1) % kF32Stages;
    uint32_t pb[8][4], ps[8][4];
    split_a(pb, ps, s_acc);
    rescale(o_acc, corr);
    fence_regs(o_tile);
    wgmma_fence();
    gemm_pb_x3<true>(o_tile, pb, ps, stage(s) + 2 * kF32Tile, stage(s) + 3 * kF32Tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_tile);
    add_regs(o_acc, o_tile);
    release(ring, s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float total = row_sum[i];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (row < rows) {
      const size_t r = static_cast<size_t>(qb) * rows + row;
      float* op = o + r * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c)  // the late divide
        *reinterpret_cast<float2*>(op + 8 * c + 2 * t) =
            make_float2(o_acc[4 * c + 2 * i] / total, o_acc[4 * c + 2 * i + 1] / total);
      if (lse != nullptr && t == 0) lse[r] = row_max[i] + logf(total);
    }
  }
}

// Backward pass 1, float32 (Q-major). Grid (ceil(rows / (64 kWgs)), heads or
// 1, batch), rows as the forward: D = rowsum(dO * O) into `delta` and the
// rows' lse into `lse_copy`, each q-batch's rows at a multiple of 32 floats
// (qb * rows32: pass 2's boxes start 16-byte aligned, as TMA needs), then over
// key tiles of 32: S = Q K^T, dP = dO V^T, dS = P (dP - D), dq += dS K, one
// tile behind on the tensor cores. Q and dO (big, small) are loaded once; a
// stage holds K and V (big, small; 32 keys) and K^T (big, small).
template <int kWgs>
__global__ void __launch_bounds__(128 * (kWgs + 1), 1)
    attention_tf32_bwd_dq_kernel(const __grid_constant__ CUtensorMap qb_map,
                                 const __grid_constant__ CUtensorMap qs_map,
                                 const __grid_constant__ CUtensorMap dob_map,
                                 const __grid_constant__ CUtensorMap dos_map,
                                 const __grid_constant__ CUtensorMap kb_map,
                                 const __grid_constant__ CUtensorMap ks_map,
                                 const __grid_constant__ CUtensorMap vb_map,
                                 const __grid_constant__ CUtensorMap vs_map,
                                 const __grid_constant__ CUtensorMap ktb_map,
                                 const __grid_constant__ CUtensorMap kts_map,
                                 const float* __restrict__ bias, const float* __restrict__ o,
                                 const float* __restrict__ dout, const float* __restrict__ lse,
                                 float* __restrict__ dq, float* __restrict__ delta,
                                 float* __restrict__ lse_copy, int rows, int rows32, int j,
                                 int bias_div) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t rows_s = align_smem(smem_raw);  // per warpgroup: Qb, Qs, dOb, dOs
  const uint32_t ring_s = rows_s + 4 * kWgs * kF32Tile;  // a stage: Kb Ks Vb Vs KTb KTs
  const uint32_t rows_full = ring_s + kF32Stages * 6 * kF32Half;
  const F32Ring ring = init_barriers<kWgs, kF32Stages>(rows_full);
  const int qb = sample_head(), row0 = blockIdx.x * kWgs * kWgRows;
  const int tiles = (j + kF32Keys1 - 1) / kF32Keys1;
  const int warp = threadIdx.x >> 5;
  const auto stage = [&](int s) { return ring_s + s * 6 * kF32Half; };

  if (warp < 4) {
    producer_registers();
    if (threadIdx.x == 0) {
      mbar_expect_tx(rows_full, 4 * kWgs * kF32Tile);
      for (int h = 0; h < kWgs; ++h) {
        const uint32_t dst = rows_s + 4 * h * kF32Tile;
        const int r0 = row0 + h * kWgRows;
        tma_rows_f32(dst, &qb_map, rows_full, r0, qb, 64);
        tma_rows_f32(dst + kF32Tile, &qs_map, rows_full, r0, qb, 64);
        tma_rows_f32(dst + 2 * kF32Tile, &dob_map, rows_full, r0, qb, 64);
        tma_rows_f32(dst + 3 * kF32Tile, &dos_map, rows_full, r0, qb, 64);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kF32Stages, k0 = it * kF32Keys1;
        mbar_wait(ring.empty(s), F32Ring::parity(it) ^ 1);
        mbar_expect_tx(ring.full(s), 6 * kF32Half);
        tma_rows_f32(stage(s), &kb_map, ring.full(s), k0, qb, kF32Keys1);
        tma_rows_f32(stage(s) + kF32Half, &ks_map, ring.full(s), k0, qb, kF32Keys1);
        tma_rows_f32(stage(s) + 2 * kF32Half, &vb_map, ring.full(s), k0, qb, kF32Keys1);
        tma_rows_f32(stage(s) + 3 * kF32Half, &vs_map, ring.full(s), k0, qb, kF32Keys1);
        tma_cols_f32(stage(s) + 4 * kF32Half, &ktb_map, ring.full(s), k0, qb, 1);
        tma_cols_f32(stage(s) + 5 * kF32Half, &kts_map, ring.full(s), k0, qb, 1);
      }
    }
    return;
  }
  consumer_registers<kWgs>();
  const int wg = (warp >> 2) - 1, w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t my_rows = rows_s + 4 * wg * kF32Tile;
  const uint32_t my_qb = my_rows, my_qs = my_rows + kF32Tile;
  const uint32_t my_dob = my_rows + 2 * kF32Tile, my_dos = my_rows + 3 * kF32Tile;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(qb / bias_div) * j;

  // D and the log-sum-exp of this thread's two rows: each of a quad's 4
  // threads sums 16 of the 64 columns
  float d_r[2], neg_lse[2], floor_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    const bool valid = row < rows;
    const size_t r = static_cast<size_t>(qb) * rows + (valid ? row : 0);
    float acc = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 ov = *reinterpret_cast<const float4*>(o + r * kHeadDim + t * 16 + c * 4);
        const float4 dv = *reinterpret_cast<const float4*>(dout + r * kHeadDim + t * 16 + c * 4);
        acc = fmaf(dv.x, ov.x, acc);
        acc = fmaf(dv.y, ov.y, acc);
        acc = fmaf(dv.z, ov.z, acc);
        acc = fmaf(dv.w, ov.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    d_r[i] = acc;
    const float l = valid ? lse[r] : INFINITY;  // past the rows: P = 0
    row_scalars(l, j, floor_r[i], neg_lse[i]);
    if (valid && t == 0) {
      const size_t r32 = static_cast<size_t>(qb) * rows32 + row;
      delta[r32] = acc;
      lse_copy[r32] = l;
    }
  }

  float dq_acc[32], dq_tile[32], s_acc[16], dp_acc[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  mbar_wait(rows_full, 0);
  mbar_wait(ring.full(0), 0);
  wgmma_fence();
  gemm_abt_x3(s_acc, my_qb, my_qs, stage(0), stage(0) + kF32Half);
  gemm_abt_x3(dp_acc, my_dob, my_dos, stage(0) + 2 * kF32Half, stage(0) + 3 * kF32Half);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s_acc);
  fence_regs(dp_acc);
  ds_at(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, 0, j, t);

  for (int it = 0; it + 1 < tiles; ++it) {  // the last tile peeled off
    const int s = it % kF32Stages, sn = (it + 1) % kF32Stages;
    uint32_t db[4][4], ds[4][4];
    split_a(db, ds, s_acc);
    mbar_wait(ring.full(sn), F32Ring::parity(it + 1));
    fence_regs(s_acc);
    fence_regs(dp_acc);
    fence_regs(dq_tile);
    wgmma_fence();
    gemm_abt_x3(s_acc, my_qb, my_qs, stage(sn), stage(sn) + kF32Half);
    gemm_abt_x3(dp_acc, my_dob, my_dos, stage(sn) + 2 * kF32Half, stage(sn) + 3 * kF32Half);
    wgmma_commit();
    wgmma_fence();
    gemm_pb_x3<true>(dq_tile, db, ds, stage(s) + 4 * kF32Half, stage(s) + 5 * kF32Half);  // dS K
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    ds_at(s_acc, dp_acc, neg_lse, floor_r, d_r, brow, it + 1, j, t);
    wgmma_wait<0>();
    fence_regs(dq_tile);
    add_regs(dq_acc, dq_tile);
    release(ring, s);
  }
  {
    const int s = (tiles - 1) % kF32Stages;
    uint32_t db[4][4], ds[4][4];
    split_a(db, ds, s_acc);
    fence_regs(dq_tile);
    wgmma_fence();
    gemm_pb_x3<true>(dq_tile, db, ds, stage(s) + 4 * kF32Half, stage(s) + 5 * kF32Half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_tile);
    add_regs(dq_acc, dq_tile);
    release(ring, s);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * kWgRows + w * 16 + g + 8 * i;
    if (row < rows) {
      float* dst = dq + (static_cast<size_t>(qb) * rows + row) * kHeadDim;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<float2*>(dst + 8 * c + 2 * t) =
            make_float2(dq_acc[4 * c + 2 * i], dq_acc[4 * c + 2 * i + 1]);
    }
  }
}

// This thread's dk/dv registers added to its float32 totals in shared
// memory (64 slots, consecutive threads on consecutive words), then cleared.
__device__ __forceinline__ void flush_totals(float* tot, float (&dk)[32], float (&dv)[32],
                                             int tid) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    tot[i * 128 + tid] += dk[i];
    tot[(32 + i) * 128 + tid] += dv[i];
    dk[i] = dv[i] = 0.f;
  }
}

// Backward pass 2, float32 (K-major). Grid (ceil(j / 64) * splits, heads or
// 1, batch): a block owns 64 keys of q-batch qb (K and V, big and small,
// loaded once: the A operands of S^T = K Q^T and dP^T = V dO^T) and walks
// its rows [split * T / splits, (split + 1) * T / splits) of T = ceil(rows /
// 32) tiles of 32, every head for multi-query, summing dv += P^T dO and
// dk += dS^T Q on the tensor cores over kF32Window tiles at a time, then
// into float32 totals in shared memory; one tile behind on the tensor
// cores. A stage
// holds Q, dO (big, small; 32 rows), Q^T, dO^T (big, small) and the rows'
// lse and D. One split writes dk/dv; more write float32 slices (qb, split)
// that kv_reduce_kernel sums in split order.
__global__ void __launch_bounds__(256, 1)
    attention_tf32_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap kb_map,
                                   const __grid_constant__ CUtensorMap ks_map,
                                   const __grid_constant__ CUtensorMap vb_map,
                                   const __grid_constant__ CUtensorMap vs_map,
                                   const __grid_constant__ CUtensorMap qb_map,
                                   const __grid_constant__ CUtensorMap qs_map,
                                   const __grid_constant__ CUtensorMap dob_map,
                                   const __grid_constant__ CUtensorMap dos_map,
                                   const __grid_constant__ CUtensorMap qtb_map,
                                   const __grid_constant__ CUtensorMap qts_map,
                                   const __grid_constant__ CUtensorMap dotb_map,
                                   const __grid_constant__ CUtensorMap dots_map,
                                   const __grid_constant__ CUtensorMap lse_map,
                                   const __grid_constant__ CUtensorMap delta_map,
                                   const float* __restrict__ bias, float* __restrict__ dk,
                                   float* __restrict__ dv, float* __restrict__ dk_acc,
                                   float* __restrict__ dv_acc, int rows, int rows32, int j,
                                   int bias_div, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t kv_s = align_smem(smem_raw);  // Kb, Ks, Vb, Vs
  const uint32_t ring_s = kv_s + 4 * kF32Tile;  // a stage: Qb Qs dOb dOs QTb QTs dOTb dOTs
  const uint32_t lse_s = ring_s + kF32Stages * 8 * kF32Half;
  const uint32_t delta_s = lse_s + kF32Stages * kF32Rows2 * 4;
  const uint32_t tot_s = delta_s + kF32Stages * kF32Rows2 * 4;
  const uint32_t kv_full = tot_s + kF32Totals;
  const F32Ring ring = init_barriers<1, kF32Stages>(kv_full);
  const int qb = sample_head();
  const int key_block = blockIdx.x / splits, split = blockIdx.x % splits;
  const int key0 = key_block * kWgRows;
  const int row_tiles = (rows + kF32Rows2 - 1) / kF32Rows2;
  const int t_begin = split * row_tiles / splits, t_end = (split + 1) * row_tiles / splits;
  const int tiles = t_end - t_begin;
  const int warp = threadIdx.x >> 5;
  const auto stage = [&](int s) { return ring_s + s * 8 * kF32Half; };

  if (warp < 4) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 4 * kF32Tile);
      tma_rows_f32(kv_s, &kb_map, kv_full, key0, qb, 64);
      tma_rows_f32(kv_s + kF32Tile, &ks_map, kv_full, key0, qb, 64);
      tma_rows_f32(kv_s + 2 * kF32Tile, &vb_map, kv_full, key0, qb, 64);
      tma_rows_f32(kv_s + 3 * kF32Tile, &vs_map, kv_full, key0, qb, 64);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kF32Stages, r0 = (t_begin + it) * kF32Rows2;
        const int flat = qb * rows32 + r0;  // lse / delta: rows at qb * rows32
        mbar_wait(ring.empty(s), F32Ring::parity(it) ^ 1);
        mbar_expect_tx(ring.full(s), 8 * kF32Half + 2 * kF32Rows2 * 4);
        tma_rows_f32(stage(s), &qb_map, ring.full(s), r0, qb, kF32Rows2);
        tma_rows_f32(stage(s) + kF32Half, &qs_map, ring.full(s), r0, qb, kF32Rows2);
        tma_rows_f32(stage(s) + 2 * kF32Half, &dob_map, ring.full(s), r0, qb, kF32Rows2);
        tma_rows_f32(stage(s) + 3 * kF32Half, &dos_map, ring.full(s), r0, qb, kF32Rows2);
        tma_cols_f32(stage(s) + 4 * kF32Half, &qtb_map, ring.full(s), r0, qb, 1);
        tma_cols_f32(stage(s) + 5 * kF32Half, &qts_map, ring.full(s), r0, qb, 1);
        tma_cols_f32(stage(s) + 6 * kF32Half, &dotb_map, ring.full(s), r0, qb, 1);
        tma_cols_f32(stage(s) + 7 * kF32Half, &dots_map, ring.full(s), r0, qb, 1);
        tma_load_flat(lse_s + s * kF32Rows2 * 4, &lse_map, ring.full(s), flat);
        tma_load_flat(delta_s + s * kF32Rows2 * 4, &delta_map, ring.full(s), flat);
      }
    }
    return;
  }
  const int w = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const auto generic = [&](uint32_t addr) { return smem_raw + (addr - smem_addr(smem_raw)); };
  const float* lse_p = reinterpret_cast<const float*>(generic(lse_s));
  const float* delta_p = reinterpret_cast<const float*>(generic(delta_s));
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(qb / bias_div) * j;
  float b_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + w * 16 + g + 8 * i;
    b_key[i] = (brow != nullptr && key < j) ? brow[key] : 0.f;
  }

  const int tid = threadIdx.x & 127;
  float* tot = reinterpret_cast<float*>(generic(tot_s));
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i * 128 + tid] = 0.f;
  float dk_r[32], dv_r[32], st[16], dpt[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_r[i] = dv_r[i] = 0.f;
  mbar_wait(kv_full, 0);
  mbar_wait(ring.full(0), 0);  // tiles >= 1: f32_row_splits keeps splits <= row tiles
  wgmma_fence();
  gemm_abt_x3(st, kv_s, kv_s + kF32Tile, stage(0), stage(0) + kF32Half);  // S^T
  gemm_abt_x3(dpt, kv_s + 2 * kF32Tile, kv_s + 3 * kF32Tile, stage(0) + 2 * kF32Half,
              stage(0) + 3 * kF32Half);  // dP^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  const float neg_log2_j = -log2f(static_cast<float>(j));
  dst_at(st, dpt, lse_p, delta_p, b_key, rows - t_begin * kF32Rows2, neg_log2_j, t);
  uint32_t pb[4][4], ps[4][4], db[4][4], ds[4][4];
  split_a(pb, ps, st);
  split_a(db, ds, dpt);
  // S^T and dP^T of the next tile, then dv and dk of this one, as three
  // commit groups: P^T of the next tile is split once dv is done, while dk
  // still runs
  for (int it = 0; it + 1 < tiles; ++it) {  // the last tile peeled off
    const int s = it % kF32Stages, sn = (it + 1) % kF32Stages;
    mbar_wait(ring.full(sn), F32Ring::parity(it + 1));
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dv_r);
    fence_regs(dk_r);
    wgmma_fence();
    gemm_abt_x3(st, kv_s, kv_s + kF32Tile, stage(sn), stage(sn) + kF32Half);
    gemm_abt_x3(dpt, kv_s + 2 * kF32Tile, kv_s + 3 * kF32Tile, stage(sn) + 2 * kF32Half,
                stage(sn) + 3 * kF32Half);
    wgmma_commit();
    gemm_pb_x3<false>(dv_r, pb, ps, stage(s) + 6 * kF32Half, stage(s) + 7 * kF32Half);  // P^T dO
    wgmma_commit();
    gemm_pb_x3<false>(dk_r, db, ds, stage(s) + 4 * kF32Half, stage(s) + 5 * kF32Half);  // dS^T Q
    wgmma_commit();
    wgmma_wait<2>();
    fence_regs(st);
    fence_regs(dpt);
    dst_at(st, dpt, lse_p + sn * kF32Rows2, delta_p + sn * kF32Rows2, b_key,
           rows - (t_begin + it + 1) * kF32Rows2, neg_log2_j, t);
    wgmma_wait<1>();
    fence_regs(dv_r);
    split_a(pb, ps, st);
    wgmma_wait<0>();
    fence_regs(dk_r);
    split_a(db, ds, dpt);
    if ((it + 1) % kF32Window == 0) flush_totals(tot, dk_r, dv_r, tid);
    release(ring, s);
  }
  {
    const int s = (tiles - 1) % kF32Stages;
    fence_regs(dv_r);
    fence_regs(dk_r);
    wgmma_fence();
    gemm_pb_x3<false>(dv_r, pb, ps, stage(s) + 6 * kF32Half, stage(s) + 7 * kF32Half);
    gemm_pb_x3<false>(dk_r, db, ds, stage(s) + 4 * kF32Half, stage(s) + 5 * kF32Half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_r);
    fence_regs(dk_r);
    release(ring, s);
  }
  flush_totals(tot, dk_r, dv_r, tid);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk_r[i] = tot[i * 128 + tid];
    dv_r[i] = tot[(32 + i) * 128 + tid];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + w * 16 + g + 8 * i;
    if (key >= j) continue;
    const size_t out = splits == 1
                           ? (static_cast<size_t>(qb) * j + key) * kHeadDim
                           : ((static_cast<size_t>(qb) * splits + split) * j + key) * kHeadDim;
    float* dk_dst = (splits == 1 ? dk : dk_acc) + out;
    float* dv_dst = (splits == 1 ? dv : dv_acc) + out;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<float2*>(dk_dst + 8 * c + 2 * t) =
          make_float2(dk_r[4 * c + 2 * i], dk_r[4 * c + 2 * i + 1]);
      *reinterpret_cast<float2*>(dv_dst + 8 * c + 2 * t) =
          make_float2(dv_r[4 * c + 2 * i], dv_r[4 * c + 2 * i + 1]);
    }
  }
}

// ---- host side: tensor maps and launches of the Hopper kernels -------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (batch, rows, 64) bf16 rows as (64, 64) boxes with 128-byte swizzle; rows
// past `rows` read as zeros.
bool encode_rows(CUtensorMap* map, const void* ptr, int rows, int batch) {
  const cuuint64_t dims[3] = {kHeadDim, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {kHeadDim * 2, static_cast<cuuint64_t>(rows) * kHeadDim * 2};
  const cuuint32_t box[3] = {kHeadDim, kRingTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A flat float32 vector as boxes of `box` (a 2-D map of one row: the
// well-trodden form); entries past `count` read as zeros.
size_t pad64(size_t x) { return (x + 63) / 64 * 64; }

bool encode_flat(CUtensorMap* map, const float* ptr, size_t count, int box = kRingTile) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(count), 1};
  const cuuint64_t strides[1] = {(static_cast<cuuint64_t>(count) * 4 + 15) / 16 * 16};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t elem[2] = {1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, boxes,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Make the device that holds `ptr` current in the calling thread, which
// makes its primary context current for the CUDA driver's tensor-map
// encoding: a thread that PyTorch's autograd engine runs a backward on may
// have none (the encoding then fails where a plain launch would not).
cudaError_t use_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  return err != cudaSuccess ? err : cudaSetDevice(attr.device);
}

// Opt a kernel into its dynamic shared memory (above the 48 KB default) on
// the current device, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& devices_done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (devices_done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) devices_done |= 1u << dev;
  return err;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Row splits of the dk/dv pass: the count in {1, 2, 4} (at most the row
// tiles) whose blocks fill the last wave best; a larger count must gain 5%.
int row_splits(int blocks, int row_tiles) {
  const int sms = sm_count();
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= kMaxRowSplits && s <= row_tiles; s *= 2) {
    const long long total = static_cast<long long>(blocks) * s;
    const double fill = static_cast<double>(total) / (((total + sms - 1) / sms) * sms);
    if (fill > best_fill + 0.05) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

template <int kWgs>
int launch_fwd(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
               const float* bias, void* o, float* lse, int batch, int rows, int j,
               cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err = allow_smem(mqa_fwd_hopper_kernel<kWgs>, fwd_smem(kWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + kWgs * kWgRows - 1) / (kWgs * kWgRows), batch);
  mqa_fwd_hopper_kernel<kWgs><<<grid, 128 * (kWgs + 1), fwd_smem(kWgs), stream>>>(
      q_map, k_map, v_map, bias, static_cast<__nv_bfloat16*>(o), lse, rows, j);
  return static_cast<int>(cudaGetLastError());
}

int launch_mqa_forward_hopper(const void* q, const void* k, const void* v, const float* bias,
                              void* o, float* lse, int batch, int heads, int n, int j,
                              cudaStream_t stream) {
  const int rows = heads * n;
  const cudaError_t dev_err = use_device_of(q);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_rows(&q_map, q, rows, batch) || !encode_rows(&k_map, k, j, batch) ||
      !encode_rows(&v_map, v, j, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  // four consumer warpgroups (256 rows a block) hide more latency; two
  // where four would leave SMs idle (short sequences)
  const long long blocks4 =
      static_cast<long long>((rows + 4 * kWgRows - 1) / (4 * kWgRows)) * batch;
  return blocks4 >= sm_count()
             ? launch_fwd<4>(q_map, k_map, v_map, bias, o, lse, batch, rows, j, stream)
             : launch_fwd<2>(q_map, k_map, v_map, bias, o, lse, batch, rows, j, stream);
}

int launch_dq(const CUtensorMap& q_map, const CUtensorMap& do_map, const CUtensorMap& k_map,
              const CUtensorMap& v_map, const float* bias, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, float* lse_copy, int batch, int rows,
              int rows32, int j, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err = allow_smem(mqa_bwd_dq_hopper_kernel, dq_smem(kBwdWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + kBwdWgs * kWgRows - 1) / (kBwdWgs * kWgRows), batch);
  mqa_bwd_dq_hopper_kernel<<<grid, 128 * (kBwdWgs + 1), dq_smem(kBwdWgs), stream>>>(
      q_map, do_map, k_map, v_map, bias, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, static_cast<__nv_bfloat16*>(dq), delta,
      lse_copy, rows, rows32, j);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkdv(const CUtensorMap& q_map, const CUtensorMap& do_map, const CUtensorMap& k_map,
                const CUtensorMap& v_map, const CUtensorMap& lse_map, const CUtensorMap& delta_map,
                const float* bias, void* dk, void* dv, float* dk_acc, float* dv_acc, int batch,
                int rows, int rows32, int j, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err = allow_smem(mqa_bwd_dkdv_hopper_kernel, dkdv_smem(kBwdWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int key_blocks = (j + kBwdWgs * kWgRows - 1) / (kBwdWgs * kWgRows);
  const int splits = row_splits(key_blocks * batch, (rows + kRingTile - 1) / kRingTile);
  mqa_bwd_dkdv_hopper_kernel<<<dim3(key_blocks * splits, batch), 128 * (kBwdWgs + 1),
                               dkdv_smem(kBwdWgs), stream>>>(
      q_map, do_map, k_map, v_map, lse_map, delta_map, bias, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dk_acc, dv_acc, rows, rows32, j, splits);
  if (splits > 1) launch_reduce<__nv_bfloat16>(dk_acc, dv_acc, dk, dv, splits, batch, j, stream);
  return static_cast<int>(cudaGetLastError());
}

// scratch: float32, D and a copy of the lse (pad64(batch * rows32) each,
// rows32 = rows rounded up to 32: pass 2's boxes start 16-byte aligned, as
// TMA needs), then two regions of kMaxRowSplits * batch * j * 64 (dk, dv
// partial slices)
int launch_mqa_backward_hopper(const void* q, const void* k, const void* v, const float* bias,
                               const void* o, const void* dout, const float* lse, void* dq,
                               void* dk, void* dv, float* scratch, int batch, int heads, int n,
                               int j, cudaStream_t stream) {
  const int rows = heads * n, rows32 = (rows + 31) / 32 * 32;
  const size_t flat32 = pad64(static_cast<size_t>(batch) * rows32);
  float* delta = scratch;
  float* lse_copy = delta + flat32;
  float* dk_acc = lse_copy + flat32;
  float* dv_acc = dk_acc + static_cast<size_t>(kMaxRowSplits) * batch * j * kHeadDim;
  const cudaError_t dev_err = use_device_of(q);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  CUtensorMap q_map, do_map, k_map, v_map, lse_map, delta_map;
  if (!encode_rows(&q_map, q, rows, batch) || !encode_rows(&do_map, dout, rows, batch) ||
      !encode_rows(&k_map, k, j, batch) || !encode_rows(&v_map, v, j, batch) ||
      !encode_flat(&lse_map, lse_copy, flat32) || !encode_flat(&delta_map, delta, flat32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_dq(q_map, do_map, k_map, v_map, bias, o, dout, lse, dq, delta, lse_copy,
                            batch, rows, rows32, j, stream);
  if (err != 0) return err;
  return launch_dkdv(q_map, do_map, k_map, v_map, lse_map, delta_map, bias, dk, dv, dk_acc,
                     dv_acc, batch, rows, rows32, j, stream);
}

// ---- launches of the multi-head kernels ----
// The tail of j keys (tile (j - 1) / 64) is narrow where it holds at most 16.
bool narrow_tail(int j) { return j - (j - 1) / kRingTile * kRingTile <= 16; }

// A launch fills the card where its blocks reach 15/16 of the SMs.
long long blocks_to_fill() { return sm_count() * 15LL / 16; }

// Consumer warpgroups of an MHA forward or pass 1 over `tiles` 64-row tiles
// of each of `bh` (sample, head)s: the most of max_wgs, ..., 2 that divides
// `tiles` (no warpgroup idle by design) and still fills the card, else 1.
int mha_wgs(int tiles, long long bh, int max_wgs) {
  for (int w = max_wgs; w > 1; w /= 2)
    if (tiles % w == 0 && tiles / w * bh >= blocks_to_fill()) return w;
  return 1;
}

// Row blocks of one head a forward block takes in turn: the most (a power of
// two) that still fills the card.
int mha_items(int row_blocks, long long bh) {
  int items = 1;
  while (items < row_blocks &&
         (row_blocks + 2 * items - 1) / (2 * items) * bh >= blocks_to_fill())
    items *= 2;
  return items;
}

// Pass 2's key tiles: the full ones where a narrow tail rides along (and
// there is a full tile to carry it), else every tile, the last ragged; two
// a block where their count is even, else one.
struct KeyBlocking {
  bool tail;
  int wgs, blocks;
};
KeyBlocking mha_key_blocking(int j) {
  const int full = (j - 1) / kRingTile;
  const bool tail = full > 0 && narrow_tail(j);
  const int tiles = tail ? full : full + 1;
  const int wgs = tiles % 2 == 0 ? 2 : 1;
  return {tail, wgs, tiles / wgs};
}

int mha_row_splits(int batch, int heads, int n, int j) {
  return row_splits(mha_key_blocking(j).blocks * batch * heads, (n + kRingTile - 1) / kRingTile);
}

template <int kWgs, int kTail>
int launch_mha_fwd(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
                   const float* bias, void* o, float* lse, int batch, int heads, int n, int j,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err =
      allow_smem(mha_fwd_hopper_kernel<kWgs, kTail>, mha_fwd_smem(kWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n + kWgs * kWgRows - 1) / (kWgs * kWgRows);
  const int items = mha_items(row_blocks, static_cast<long long>(batch) * heads);
  const dim3 grid((row_blocks + items - 1) / items, heads, batch);
  mha_fwd_hopper_kernel<kWgs, kTail><<<grid, 128 * (kWgs + 1), mha_fwd_smem(kWgs), stream>>>(
      q_map, k_map, v_map, bias, static_cast<__nv_bfloat16*>(o), lse, n, j, items);
  return static_cast<int>(cudaGetLastError());
}

template <int kTail>
int launch_mha_fwd_wgs(int wgs, const CUtensorMap& q_map, const CUtensorMap& k_map,
                       const CUtensorMap& v_map, const float* bias, void* o, float* lse,
                       int batch, int heads, int n, int j, cudaStream_t stream) {
  if (wgs == 4)
    return launch_mha_fwd<4, kTail>(q_map, k_map, v_map, bias, o, lse, batch, heads, n, j, stream);
  if (wgs == 2)
    return launch_mha_fwd<2, kTail>(q_map, k_map, v_map, bias, o, lse, batch, heads, n, j, stream);
  return launch_mha_fwd<1, kTail>(q_map, k_map, v_map, bias, o, lse, batch, heads, n, j, stream);
}

int launch_mha_forward_hopper(const void* q, const void* k, const void* v, const float* bias,
                              void* o, float* lse, int batch, int heads, int n, int j,
                              cudaStream_t stream) {
  const int bh = batch * heads;
  const cudaError_t dev_err = use_device_of(q);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_rows(&q_map, q, n, bh) || !encode_rows(&k_map, k, j, bh) ||
      !encode_rows(&v_map, v, j, bh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wgs = mha_wgs((n + kWgRows - 1) / kWgRows, bh, 4);
  return narrow_tail(j)
             ? launch_mha_fwd_wgs<16>(wgs, q_map, k_map, v_map, bias, o, lse, batch, heads, n, j,
                                      stream)
             : launch_mha_fwd_wgs<64>(wgs, q_map, k_map, v_map, bias, o, lse, batch, heads, n, j,
                                      stream);
}

template <int kWgs, int kTail>
int launch_mha_dq(const CUtensorMap& q_map, const CUtensorMap& do_map, const CUtensorMap& k_map,
                  const CUtensorMap& v_map, const float* bias, const void* o, const void* dout,
                  const float* lse, void* dq, float* delta, float* lse_copy, int batch, int heads,
                  int n, int n32, int j, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err =
      allow_smem(mha_bwd_dq_hopper_kernel<kWgs, kTail>, dq_smem(kWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kWgs * kWgRows - 1) / (kWgs * kWgRows), heads, batch);
  mha_bwd_dq_hopper_kernel<kWgs, kTail><<<grid, 128 * (kWgs + 1), dq_smem(kWgs), stream>>>(
      q_map, do_map, k_map, v_map, bias, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, static_cast<__nv_bfloat16*>(dq), delta,
      lse_copy, n, n32, j);
  return static_cast<int>(cudaGetLastError());
}

template <int kWgs, bool kTail>
int launch_mha_dkdv(const CUtensorMap& q_map, const CUtensorMap& do_map, const CUtensorMap& k_map,
                    const CUtensorMap& v_map, const CUtensorMap& lse_map,
                    const CUtensorMap& delta_map, const float* bias, void* dk, void* dv,
                    float* dk_acc, float* dv_acc, int key_blocks, int splits, int batch,
                    int heads, int n, int n32, int j, cudaStream_t stream) {
  constexpr int smem = dkdv_smem(kWgs) + (kTail ? 2 * kTileBytes + 2 * kStagedBytes : 0);
  static unsigned smem_set = 0;
  const cudaError_t err = allow_smem(mha_bwd_dkdv_hopper_kernel<kWgs, kTail>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkdv_hopper_kernel<kWgs, kTail>
      <<<dim3(key_blocks * splits, heads, batch), 128 * (kWgs + 1), smem, stream>>>(
          q_map, do_map, k_map, v_map, lse_map, delta_map, bias, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), dk_acc, dv_acc, n, n32, j, splits);
  return static_cast<int>(cudaGetLastError());
}

// scratch: float32, D and a copy of the lse (pad64(batch * heads * n32)
// each, n32 = n rounded up to 32: pass 2's boxes start 16-byte aligned), then,
// only where pass 2 splits the rows, two regions of splits * batch * heads * j
// * 64 (dk, dv partial slices); mmt_mha_backward_row_splits gives the count
int launch_mha_backward_hopper(const void* q, const void* k, const void* v, const float* bias,
                               const void* o, const void* dout, const float* lse, void* dq,
                               void* dk, void* dv, float* scratch, int batch, int heads, int n,
                               int j, cudaStream_t stream) {
  const int bh = batch * heads, n32 = (n + 31) / 32 * 32;
  const size_t flat32 = pad64(static_cast<size_t>(bh) * n32);
  const KeyBlocking kb = mha_key_blocking(j);
  const int splits = mha_row_splits(batch, heads, n, j);
  float* delta = scratch;
  float* lse_copy = delta + flat32;
  float* dk_acc = lse_copy + flat32;
  float* dv_acc = dk_acc + static_cast<size_t>(splits) * bh * j * kHeadDim;
  const cudaError_t dev_err = use_device_of(q);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  CUtensorMap q_map, do_map, k_map, v_map, lse_map, delta_map;
  if (!encode_rows(&q_map, q, n, bh) || !encode_rows(&do_map, dout, n, bh) ||
      !encode_rows(&k_map, k, j, bh) || !encode_rows(&v_map, v, j, bh) ||
      !encode_flat(&lse_map, lse_copy, flat32) || !encode_flat(&delta_map, delta, flat32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide_dq = mha_wgs((n + kWgRows - 1) / kWgRows, bh, 2) == 2;
  int err;
  if (narrow_tail(j))
    err = wide_dq ? launch_mha_dq<2, 16>(q_map, do_map, k_map, v_map, bias, o, dout, lse, dq, delta,
                                         lse_copy, batch, heads, n, n32, j, stream)
                  : launch_mha_dq<1, 16>(q_map, do_map, k_map, v_map, bias, o, dout, lse, dq, delta,
                                         lse_copy, batch, heads, n, n32, j, stream);
  else
    err = wide_dq ? launch_mha_dq<2, 64>(q_map, do_map, k_map, v_map, bias, o, dout, lse, dq, delta,
                                         lse_copy, batch, heads, n, n32, j, stream)
                  : launch_mha_dq<1, 64>(q_map, do_map, k_map, v_map, bias, o, dout, lse, dq, delta,
                                         lse_copy, batch, heads, n, n32, j, stream);
  if (err != 0) return err;
  const auto dkdv = kb.wgs == 2 ? (kb.tail ? launch_mha_dkdv<2, true> : launch_mha_dkdv<2, false>)
                                : (kb.tail ? launch_mha_dkdv<1, true> : launch_mha_dkdv<1, false>);
  err = dkdv(q_map, do_map, k_map, v_map, lse_map, delta_map, bias, dk, dv, dk_acc, dv_acc,
             kb.blocks, splits, batch, heads, n, n32, j, stream);
  if (err != 0 || splits == 1) return err;
  launch_reduce<__nv_bfloat16>(dk_acc, dv_acc, dk, dv, splits, bh, j, stream);
  return static_cast<int>(cudaGetLastError());
}

// ---- launches of the float32 kernels ----
// (batch, rows, inner) float32 as boxes of (box_rows rows x 32 floats) with
// 128-byte swizzle: one swizzle atom a box; rows past `rows` read as zeros.
bool encode_f32(CUtensorMap* map, const float* ptr, int inner, int rows, int batch, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 4,
                                 static_cast<cuuint64_t>(rows) * inner * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// The big and small parts of `count` floats at x (count a multiple of 4).
void launch_split(const float* x, float* big, float* small, size_t count, cudaStream_t stream) {
  const size_t count4 = count / 4;
  const int blocks = static_cast<int>(std::min<size_t>((count4 + 255) / 256, 132 * 16));
  attention_tf32_split_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(big),
      reinterpret_cast<float4*>(small), count4);
}

// (batch, rows, 64) at x transposed, split, to (batch, 64, pad64(rows)) at
// big_t and small_t; and split in its own layout to big and small unless
// those are null.
void launch_split_t(const float* x, float* big, float* small, float* big_t, float* small_t,
                    int batch, int rows, cudaStream_t stream) {
  const int rows_pad = static_cast<int>(pad64(rows));
  const long long blocks = static_cast<long long>(batch) * (rows_pad / 32);
  attention_tf32_split_t_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      x, big, small, big_t, small_t, rows, rows_pad);
}

// The q-batches of a float32 call: a sample for multi-query (its rows the
// h * n rows across heads), a (sample, head) for multi-head (its n rows);
// rows32 is rows rounded up to 32 (the backward's lse and D copies).
struct F32Shape {
  int qbatch, rows, rows32, bias_div, grid_y;
};
F32Shape f32_shape(int batch, int heads, int n, bool shared_kv) {
  const int rows = shared_kv ? heads * n : n;
  return {shared_kv ? batch : batch * heads, rows, (rows + 31) / 32 * 32, shared_kv ? 1 : heads,
          shared_kv ? 1 : heads};
}

// Consumer warpgroups of the forward and pass 1: two (128 rows a block)
// where their blocks still fill the card, else one.
int f32_wgs(const F32Shape& s) {
  const long long tiles2 = (s.rows + 2 * kWgRows - 1) / (2 * kWgRows);
  return tiles2 * s.qbatch >= blocks_to_fill() ? 2 : 1;
}

// Row splits of float32 pass 2 (64 keys a block, 32-row tiles).
int f32_row_splits(const F32Shape& s, int j) {
  const int key_blocks = (j + kWgRows - 1) / kWgRows;
  return row_splits(key_blocks * s.qbatch, (s.rows + kF32Rows2 - 1) / kF32Rows2);
}

template <int kWgs>
int launch_f32_fwd(const CUtensorMap* maps, const float* bias, float* o, float* lse,
                   const F32Shape& s, int batch, int j, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err =
      allow_smem(attention_tf32_fwd_kernel<kWgs>, f32_fwd_smem(kWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.rows + kWgs * kWgRows - 1) / (kWgs * kWgRows), s.grid_y, batch);
  attention_tf32_fwd_kernel<kWgs><<<grid, 128 * (kWgs + 1), f32_fwd_smem(kWgs), stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], bias, o, lse, s.rows, j, s.bias_div);
  return static_cast<int>(cudaGetLastError());
}

// scratch (float32): K big and small (qbatch * j * 64 each), then V^T big
// and small (qbatch * 64 * pad64(j) each)
int launch_forward_f32(const float* q, const float* k, const float* v, const float* bias,
                       float* o, float* lse, float* scratch, int batch, int heads, int n, int j,
                       bool shared_kv, cudaStream_t stream) {
  const F32Shape s = f32_shape(batch, heads, n, shared_kv);
  const size_t kv = static_cast<size_t>(s.qbatch) * j * kHeadDim;
  const size_t vt = static_cast<size_t>(s.qbatch) * kHeadDim * pad64(j);
  float* kb = scratch;
  float* ks = kb + kv;
  float* vtb = ks + kv;
  float* vts = vtb + vt;
  const cudaError_t dev_err = use_device_of(q);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  CUtensorMap maps[5];
  const int jp = static_cast<int>(pad64(j));
  if (!encode_f32(&maps[0], q, kHeadDim, s.rows, s.qbatch, 64) ||
      !encode_f32(&maps[1], kb, kHeadDim, j, s.qbatch, 64) ||
      !encode_f32(&maps[2], ks, kHeadDim, j, s.qbatch, 64) ||
      !encode_f32(&maps[3], vtb, jp, kHeadDim, s.qbatch, 64) ||
      !encode_f32(&maps[4], vts, jp, kHeadDim, s.qbatch, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  launch_split(k, kb, ks, kv, stream);
  launch_split_t(v, nullptr, nullptr, vtb, vts, s.qbatch, j, stream);
  return f32_wgs(s) == 2 ? launch_f32_fwd<2>(maps, bias, o, lse, s, batch, j, stream)
                         : launch_f32_fwd<1>(maps, bias, o, lse, s, batch, j, stream);
}

template <int kWgs>
int launch_f32_dq(const CUtensorMap* maps, const float* bias, const float* o, const float* dout,
                  const float* lse, float* dq, float* delta, float* lse_copy, const F32Shape& s,
                  int batch, int j, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err =
      allow_smem(attention_tf32_bwd_dq_kernel<kWgs>, f32_dq_smem(kWgs), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.rows + kWgs * kWgRows - 1) / (kWgs * kWgRows), s.grid_y, batch);
  attention_tf32_bwd_dq_kernel<kWgs><<<grid, 128 * (kWgs + 1), f32_dq_smem(kWgs), stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], maps[8], maps[9],
      bias, o, dout, lse, dq, delta, lse_copy, s.rows, s.rows32, j, s.bias_div);
  return static_cast<int>(cudaGetLastError());
}

// scratch (float32), each region a multiple of 64 floats: D and a copy of
// the lse (pad64(qbatch * rows32) each, rows32 = rows rounded up to 32);
// where pass 2 splits the rows, dk and dv slices (splits * qbatch *
// j * 64 each); Q, Q small, dO, dO small (qbatch * rows * 64 each); K, K
// small, V, V small (qbatch * j * 64 each); K^T, K^T small (qbatch * 64 *
// pad64(j) each); Q^T, Q^T small, dO^T, dO^T small (qbatch * 64 *
// pad64(rows) each). mmt_tf32_backward_row_splits gives the splits.
int launch_backward_f32(const float* q, const float* k, const float* v, const float* bias,
                        const float* o, const float* dout, const float* lse, float* dq, float* dk,
                        float* dv, float* scratch, int batch, int heads, int n, int j,
                        bool shared_kv, cudaStream_t stream) {
  const F32Shape s = f32_shape(batch, heads, n, shared_kv);
  const int splits = f32_row_splits(s, j);
  const int jp = static_cast<int>(pad64(j)), rows_p = static_cast<int>(pad64(s.rows));
  const size_t flat32 = pad64(static_cast<size_t>(s.qbatch) * s.rows32);
  const size_t rows64 = static_cast<size_t>(s.qbatch) * s.rows * kHeadDim;
  const size_t kv = static_cast<size_t>(s.qbatch) * j * kHeadDim;
  const size_t slices = splits > 1 ? splits * kv : 0;
  const size_t kt = static_cast<size_t>(s.qbatch) * kHeadDim * jp;
  const size_t qt = static_cast<size_t>(s.qbatch) * kHeadDim * rows_p;
  float* delta = scratch;
  float* lse_copy = delta + flat32;
  float* dk_acc = lse_copy + flat32;
  float* dv_acc = dk_acc + slices;
  float* split = dv_acc + slices;  // Qb Qs dOb dOs, Kb Ks Vb Vs, KTb KTs, QTb QTs dOTb dOTs
  float* part[14];
  for (int i = 0; i < 4; ++i) part[i] = split + i * rows64;
  for (int i = 0; i < 4; ++i) part[4 + i] = split + 4 * rows64 + i * kv;
  for (int i = 0; i < 2; ++i) part[8 + i] = split + 4 * rows64 + 4 * kv + i * kt;
  for (int i = 0; i < 4; ++i) part[10 + i] = split + 4 * rows64 + 4 * kv + 2 * kt + i * qt;
  const cudaError_t dev_err = use_device_of(q);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  // pass 1: Qb Qs dOb dOs (64 rows), Kb Ks Vb Vs (32 keys), KTb KTs
  // pass 2: Kb Ks Vb Vs (64 keys), Qb Qs dOb dOs (32 rows), QTb QTs dOTb dOTs, lse, D
  CUtensorMap m1[10], m2[14];
  bool ok = true;
  for (int i = 0; i < 4; ++i) {
    ok = ok && encode_f32(&m1[i], part[i], kHeadDim, s.rows, s.qbatch, 64);
    ok = ok && encode_f32(&m1[4 + i], part[4 + i], kHeadDim, j, s.qbatch, kF32Keys1);
    ok = ok && encode_f32(&m2[i], part[4 + i], kHeadDim, j, s.qbatch, 64);
    ok = ok && encode_f32(&m2[4 + i], part[i], kHeadDim, s.rows, s.qbatch, kF32Rows2);
    ok = ok && encode_f32(&m2[8 + i], part[10 + i], rows_p, kHeadDim, s.qbatch, 64);
  }
  for (int i = 0; i < 2; ++i) ok = ok && encode_f32(&m1[8 + i], part[8 + i], jp, kHeadDim, s.qbatch, 64);
  ok = ok && encode_flat(&m2[12], lse_copy, flat32, kF32Rows2) &&
       encode_flat(&m2[13], delta, flat32, kF32Rows2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  launch_split_t(q, part[0], part[1], part[10], part[11], s.qbatch, s.rows, stream);
  launch_split_t(dout, part[2], part[3], part[12], part[13], s.qbatch, s.rows, stream);
  launch_split_t(k, part[4], part[5], part[8], part[9], s.qbatch, j, stream);
  launch_split(v, part[6], part[7], kv, stream);
  const int err = f32_wgs(s) == 2
                      ? launch_f32_dq<2>(m1, bias, o, dout, lse, dq, delta, lse_copy, s, batch, j,
                                         stream)
                      : launch_f32_dq<1>(m1, bias, o, dout, lse, dq, delta, lse_copy, s, batch, j,
                                         stream);
  if (err != 0) return err;
  static unsigned smem_set = 0;
  const cudaError_t smem_err =
      allow_smem(attention_tf32_bwd_dkdv_kernel, f32_dkdv_smem(), smem_set);
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  const dim3 grid((j + kWgRows - 1) / kWgRows * splits, s.grid_y, batch);
  attention_tf32_bwd_dkdv_kernel<<<grid, 256, f32_dkdv_smem(), stream>>>(
      m2[0], m2[1], m2[2], m2[3], m2[4], m2[5], m2[6], m2[7], m2[8], m2[9], m2[10], m2[11],
      m2[12], m2[13], bias, dk, dv, dk_acc, dv_acc, s.rows, s.rows32, j, s.bias_div, splits);
  if (splits > 1) launch_reduce<float>(dk_acc, dv_acc, dk, dv, splits, s.qbatch, j, stream);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int batch, int heads, int n, int j, int head_dim) {
  return head_dim != kHeadDim || batch <= 0 || heads <= 0 || n <= 0 || j <= 0 ||
         batch > kMaxGridYZ || heads > kMaxGridYZ;
}

// scratch: float32 only, as launch_forward_f32 lays it out (null for bf16)
int launch_forward(const void* q, const void* k, const void* v, const float* bias, void* o,
                   float* lse, float* scratch, int batch, int heads, int n, int j, int head_dim,
                   int dtype, bool shared_kv, cudaStream_t stream) {
  if (bad_sizes(batch, heads, n, j, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == mmt::kFloat32) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_forward_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), bias, static_cast<float*>(o), lse,
                              scratch, batch, heads, n, j, shared_kv, stream);
  }
  if (dtype == mmt::kBFloat16 && shared_kv)
    return launch_mqa_forward_hopper(q, k, v, bias, o, lse, batch, heads, n, j, stream);
  if (dtype == mmt::kBFloat16)
    return launch_mha_forward_hopper(q, k, v, bias, o, lse, batch, heads, n, j, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// scratch: float32, laid out as launch_mqa_backward_hopper,
// launch_mha_backward_hopper and launch_backward_f32 say
int launch_backward(const void* q, const void* k, const void* v, const float* bias,
                    const void* o, const void* dout, const float* lse, void* dq, void* dk,
                    void* dv, float* scratch, int batch, int heads, int n, int j, int head_dim,
                    int dtype, bool shared_kv, cudaStream_t stream) {
  if (bad_sizes(batch, heads, n, j, head_dim) || lse == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == mmt::kBFloat16 && shared_kv)
    return launch_mqa_backward_hopper(q, k, v, bias, o, dout, lse, dq, dk, dv, scratch, batch,
                                      heads, n, j, stream);
  if (dtype == mmt::kBFloat16)
    return launch_mha_backward_hopper(q, k, v, bias, o, dout, lse, dq, dk, dv, scratch, batch,
                                      heads, n, j, stream);
  if (dtype != mmt::kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_backward_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), bias, static_cast<const float*>(o),
                             static_cast<const float*>(dout), lse, static_cast<float*>(dq),
                             static_cast<float*>(dk), static_cast<float*>(dv), scratch, batch,
                             heads, n, j, shared_kv, stream);
}

}  // namespace

extern "C" int mmt_mqa_forward(const void* q, const void* k, const void* v, const float* bias,
                               void* o, float* lse, float* scratch, int batch, int heads, int n,
                               int j, int head_dim, int dtype, void* stream) {
  return launch_forward(q, k, v, bias, o, lse, scratch, batch, heads, n, j, head_dim, dtype, true,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_mha_forward(const void* q, const void* k, const void* v, const float* bias,
                               void* o, float* lse, float* scratch, int batch, int heads, int n,
                               int j, int head_dim, int dtype, void* stream) {
  return launch_forward(q, k, v, bias, o, lse, scratch, batch, heads, n, j, head_dim, dtype, false,
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

// Row splits the bf16 multi-head backward takes on the current device (its
// scratch holds float32 dk/dv slices only where this is above 1).
extern "C" int mmt_mha_backward_row_splits(int batch, int heads, int n, int j) {
  return mha_row_splits(batch, heads, n, j);
}

// Row splits the float32 backward's dk/dv pass takes on the current device
// (its scratch holds float32 dk/dv slices only where this is above 1).
extern "C" int mmt_tf32_backward_row_splits(int batch, int heads, int n, int j, int shared_kv) {
  return f32_row_splits(f32_shape(batch, heads, n, shared_kv != 0), j);
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
