// FlowNetC correlation (cost volume), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel flownet2_tf_tpu/ops/pallas/correlation_kernel.py
// (_corr_row_kernel, launched by _correlation_pallas_fwd) and the XLA
// einsum form ops/correlation.py::_correlation_mxu that the JAX package
// runs on the TPU. It computes, for the configuration family
// kernel_size=1, stride_1=1, pad == max_displacement,
// max_displacement % stride_2 == 0:
//
//   out[n, y, x, dyi*D + dxi] = (1/C) * sum_c a[n, y, x, c]
//                                     * b[n, y + (dyi-r)*s2, x + (dxi-r)*s2, c]
//
// with r = max_displacement / s2, D = 2r + 1, and b read as zero outside
// the frame (the zero padding is implicit: bounds checks, no b_pad). Inputs
// are NHWC-contiguous f32 or bf16; accumulation and output are f32; the
// output is NHWC (N, H, W, D*D), dy-major, like the JAX package.
//
// What bounds it on this card: at the FlowNet2 448x1024 shape,
// (1, 56, 128, 256) with d=20, s2=2, D=21, the 441 displacements over 256
// channels cost ~0.8 GMAC per pair; the inputs are 2 x 7.3 MB f32 and the
// output 12.6 MB. Every b pixel is read by up to 441 output pixels, so the
// traffic that matters is L1/L2 re-reads and the latency of the per-
// displacement warp reductions, not HBM bandwidth (~27 MB in all, ~8 us at
// 3.35 TB/s).
//
// Design (simple and correct first): one warp per output (n, y, x, dyi).
// The 32 lanes stride over C, so each load of a pixel's channels is one
// coalesced 128-byte transaction; the warp loops over the D dx
// displacements, reduces each dot product with a butterfly of shuffles, and
// lane (dxi mod 32) keeps the result, so each group of up to 32 results is
// stored with one coalesced write. A warp whose dy row leaves the frame
// writes zeros without reading. Offsets are 64-bit. Holding the row of a in
// shared memory and a tensor-core (GEMM + band) form are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
correlation_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       float* __restrict__ out, int n, int h, int w, int c,
                       int r, int s2) {
  const int d = 2 * r + 1;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t total = (int64_t)n * h * w * d;
  if (warp >= total) return;  // whole warp exits together

  const int dyi = (int)(warp % d);
  const int64_t pix = warp / d;  // (n, y, x) flattened
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int64_t ni = pix / ((int64_t)w * h);

  const float inv_norm = 1.0f / (float)c;
  const int64_t row_stride = (int64_t)w * c;
  const T* a_pix = a + pix * c;
  float* out_row = out + pix * ((int64_t)d * d) + (int64_t)dyi * d;

  const int by = y + (dyi - r) * s2;
  const bool row_inside = by >= 0 && by < h;
  const T* b_row = b + (ni * h + (row_inside ? by : 0)) * row_stride;

  float keep = 0.0f;
  for (int dxi = 0; dxi < d; ++dxi) {
    const int bx = x + (dxi - r) * s2;
    float acc = 0.0f;
    if (row_inside && bx >= 0 && bx < w) {  // uniform across the warp
      const T* b_pix = b_row + (int64_t)bx * c;
      for (int ch = lane; ch < c; ch += 32) {
        acc = fmaf(to_f32(a_pix[ch]), to_f32(b_pix[ch]), acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
    }
    const int slot = dxi & 31;
    if (lane == slot) keep = acc * inv_norm;
    if (slot == 31 || dxi == d - 1) {
      const int base = dxi - slot;
      if (lane <= slot) out_row[base + lane] = keep;
    }
  }
}

}  // namespace

// Launch on `stream`. a, b: NHWC (n, h, w, c), f32 (is_bf16 == 0) or bf16;
// out: f32 (n, h, w, D*D). Returns cudaGetLastError() after the launch.
extern "C" int flownet2_correlation_fwd(const void* a, const void* b,
                                        void* out, int n, int h, int w,
                                        int c, int max_displacement,
                                        int stride_2, int is_bf16,
                                        void* stream) {
  if (stride_2 <= 0 || max_displacement < 0 || c <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int r = max_displacement / stride_2;
  const int d = 2 * r + 1;
  const int64_t warps = (int64_t)n * h * w * d;
  if (warps == 0) return (int)cudaSuccess;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    correlation_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out), n, h,
        w, c, r, stride_2);
  } else {
    correlation_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, h, w, c, r, stride_2);
  }
  return (int)cudaGetLastError();
}
