// Depth-to-space with the stem bias, for Hopper.
//
// Replaces the Pallas kernel of minimagen_tpu/ops/stem_conv.py::
// _depth_to_space_bias_pallas (:146, pallas_call at :191) ->
// mmt_depth_to_space_bias.
//   y2 (b, H', W', f*f*c), channels ordered (py, px, c): the output of the
//   space-to-depth stem convolution; bias (c); both float32 or bfloat16.
//   out (b, f*H', f*W', c) with out[n, f*Y + py, f*X + px, ch] =
//   y2[n, Y, X, (py*f + px)*c + ch] + bias[ch], the add taken in float32 and
//   rounded once to the activation type: a sum of two bfloat16 values is
//   exact in float32, so this is the bits of the plain reshape/permute + bias
//   (ops/stem_conv.py::depth_to_space_bias_plain) in either type.
//
// What bounds it on the card: one read and one write of every element and
// one add, so memory bytes. The TPU kernel shuffled a (batch, row) block in
// VMEM. Here each thread owns one 16-byte vector of one output pixel's
// channels (8 bfloat16 or 4 float32; c is 32-512 on the U-Nets' stems) and
// computes its source from its own index: consecutive threads write
// consecutive vectors of the output, and the f output pixels of one input
// row segment read f runs of c contiguous channels, so both sides are
// coalesced. Channel counts that are not a multiple of a vector take a
// one-element-per-thread instance of the same kernel.

#include <algorithm>

#include "common.cuh"

namespace {

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

template <typename T, int kVec>
__global__ void __launch_bounds__(256)
    depth_to_space_bias_kernel(const T* __restrict__ y2, const T* __restrict__ bias,
                               T* __restrict__ out, int h, int w, int f, int c, size_t vectors) {
  using V = Vec<T, kVec>;
  const int per_pixel = c / kVec;
  const int out_w = f * w, out_h = f * h;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < vectors;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(e % per_pixel) * kVec;
    const size_t pixel = e / per_pixel;
    const int ox = static_cast<int>(pixel % out_w);
    const size_t rest = pixel / out_w;
    const int oy = static_cast<int>(rest % out_h);
    const size_t n = rest / out_h;
    const size_t src_pixel = (n * h + oy / f) * w + ox / f;
    const size_t src = (src_pixel * f * f + (oy % f) * f + ox % f) * c + ch;
    const V a = *reinterpret_cast<const V*>(y2 + src);
    const V b = *reinterpret_cast<const V*>(bias + ch);
    V r;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      r.v[i] = mmt::from_f32<T>(mmt::to_f32(a.v[i]) + mmt::to_f32(b.v[i]));
    *reinterpret_cast<V*>(out + pixel * c + ch) = r;
  }
}

template <typename T>
int launch(const void* y2, const void* bias, void* out, int batch, int h, int w, int f, int c,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t elements = static_cast<size_t>(batch) * f * h * f * w * c;
  const bool vector = c % kVec == 0 && reinterpret_cast<uintptr_t>(y2) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t vectors = vector ? elements / kVec : elements;
  const int blocks = static_cast<int>(std::min<size_t>((vectors + 255) / 256, 132 * 64));
  const T* yt = static_cast<const T*>(y2);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (vector)
    depth_to_space_bias_kernel<T, kVec><<<blocks, 256, 0, stream>>>(yt, bt, ot, h, w, f, c,
                                                                    vectors);
  else
    depth_to_space_bias_kernel<T, 1><<<blocks, 256, 0, stream>>>(yt, bt, ot, h, w, f, c, vectors);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_depth_to_space_bias(const void* y2, const void* bias, void* out, int batch,
                                       int h, int w, int f, int c, int dtype, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || f <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mmt::kFloat32) return launch<float>(y2, bias, out, batch, h, w, f, c, s);
  if (dtype == mmt::kBFloat16) return launch<__nv_bfloat16>(y2, bias, out, batch, h, w, f, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
