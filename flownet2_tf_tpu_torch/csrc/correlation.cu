// FlowNetC correlation (cost volume), forward and backward, for Hopper
// (sm_90a).
//
// ---- Forward ----
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
//
// ---- Backward ----
//
// Replaces the TPU backward flownet2_tf_tpu/ops/pallas/correlation_kernel.py
// _bwd (lines 147-160), which differentiates the jnp oracle. With g the f32
// gradient of the (N, H, W, D*D) cost volume and only in-frame terms:
//
//   da[n,y,x,c] = (1/C) sum_{i,j<D} g[n,y,x,iD+j] * b[n, y+(i-r)s2, x+(j-r)s2, c]
//   db[n,y,x,c] = (1/C) sum_{i,j<D} g[n, y-(i-r)s2, x-(j-r)s2, iD+j]
//                                   * a[n, y-(i-r)s2, x-(j-r)s2, c]
//
// Both are written as gathers: each output element is summed and written
// by one thread in a fixed order, with no atomics, so two runs give
// bitwise-equal gradients. da and db come out in the input dtype, like
// _bwd's cast; accumulation is f32.
//
// What bounds it: like the forward, every output pixel reads D*D pixels of
// the other operand across all C channels (FlowNetC's conv3 at the
// 320x448 chairs crop, (8, 40, 56, 256), D=21: 441 x 1 KB per pixel, ~8 GB
// of L1/L2 reads per gradient, against ~70 MB of HBM traffic for g, the
// other operand and the output), so it is bound by L1/L2 re-reads and their
// latency, not by HBM bandwidth or FMAs.
//
// Design (simple and correct first): one warp per output pixel (n, y, x).
// The warp first stages the D*D gradient values that pixel needs in shared
// memory, the lanes loading in parallel: for da they are the pixel's own
// contiguous g row; for db they are gathered from D*D neighbouring pixels,
// one value each. It then loops over the displacements; for each in-frame
// source pixel the lanes stride over C with coalesced 128-byte loads and
// keep kChanPerLane f32 accumulators each in registers, so one pass covers
// 256 channels and the staged g value is a shared-memory broadcast. Wider C
// takes more passes; D*D above kStage is staged in chunks. Offsets are
// 64-bit. Keeping a tile of the other operand in shared memory, so that
// neighbouring pixels share its re-reads, is later work.

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

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kChanPerLane = 8;  // 32 lanes x 8 = 256 channels per pass
constexpr int kStage = 448;      // staged g values per warp (>= 441 = 21^2)

// One warp computes out[pix, :] = da (kDb false: src = b, g of pix itself)
// or db (kDb true: src = a, g gathered from the displaced pixels).
template <typename T, bool kDb>
__device__ __forceinline__ void correlation_bwd_pixel(
    const float* __restrict__ g, const T* __restrict__ src,
    T* __restrict__ out, float* g_s, int64_t pix, int h, int w, int c,
    int r, int s2) {
  const int d = 2 * r + 1;
  const int dd = d * d;
  const int lane = threadIdx.x & 31;
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int64_t img = pix - (int64_t)y * w - x;  // n * h * w
  const int sgn = kDb ? -1 : 1;
  const float inv_norm = 1.0f / (float)c;

  for (int c0 = 0; c0 < c; c0 += 32 * kChanPerLane) {
    float acc[kChanPerLane];
#pragma unroll
    for (int m = 0; m < kChanPerLane; ++m) acc[m] = 0.0f;

    for (int k0 = 0; k0 < dd; k0 += kStage) {
      const int kn = min(kStage, dd - k0);
      __syncwarp();  // the previous chunk's readers are done
      for (int t = lane; t < kn; t += 32) {
        const int k = k0 + t;
        float v;
        if (kDb) {
          const int qy = y - (k / d - r) * s2;
          const int qx = x - (k % d - r) * s2;
          v = (qy >= 0 && qy < h && qx >= 0 && qx < w)
                  ? g[(img + (int64_t)qy * w + qx) * dd + k]
                  : 0.0f;
        } else {
          v = g[pix * dd + k];
        }
        g_s[t] = v;
      }
      __syncwarp();

      int i = k0 / d, j = k0 % d;  // displacement (dy, dx) indices of k0
      for (int t = 0; t < kn; ++t) {
        const int sy = y + sgn * (i - r) * s2;
        const int sx = x + sgn * (j - r) * s2;
        if (++j == d) {
          j = 0;
          ++i;
        }
        // uniform across the warp: out-of-frame terms are zero padding
        if (sy < 0 || sy >= h || sx < 0 || sx >= w) continue;
        const float gv = g_s[t];
        const T* sp = src + (img + (int64_t)sy * w + sx) * c;
#pragma unroll
        for (int m = 0; m < kChanPerLane; ++m) {
          const int ch = c0 + lane + 32 * m;
          if (ch < c) acc[m] = fmaf(gv, to_f32(sp[ch]), acc[m]);
        }
      }
    }

    T* op = out + pix * c;
#pragma unroll
    for (int m = 0; m < kChanPerLane; ++m) {
      const int ch = c0 + lane + 32 * m;
      if (ch < c) store_as(op + ch, acc[m] * inv_norm);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
correlation_bwd_da_kernel(const float* __restrict__ g,
                          const T* __restrict__ b, T* __restrict__ da, int n,
                          int h, int w, int c, int r, int s2) {
  __shared__ float g_s[kWarpsPerBlock][kStage];
  const int wid = threadIdx.x >> 5;
  const int64_t pix = (int64_t)blockIdx.x * kWarpsPerBlock + wid;
  if (pix >= (int64_t)n * h * w) return;  // whole warp exits together
  correlation_bwd_pixel<T, false>(g, b, da, g_s[wid], pix, h, w, c, r, s2);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
correlation_bwd_db_kernel(const float* __restrict__ g,
                          const T* __restrict__ a, T* __restrict__ db, int n,
                          int h, int w, int c, int r, int s2) {
  __shared__ float g_s[kWarpsPerBlock][kStage];
  const int wid = threadIdx.x >> 5;
  const int64_t pix = (int64_t)blockIdx.x * kWarpsPerBlock + wid;
  if (pix >= (int64_t)n * h * w) return;
  correlation_bwd_pixel<T, true>(g, a, db, g_s[wid], pix, h, w, c, r, s2);
}

template <typename T>
int launch_bwd(const float* g, const T* a, const T* b, T* da, T* db, int n,
               int h, int w, int c, int r, int s2, cudaStream_t s) {
  const int64_t warps = (int64_t)n * h * w;
  if (warps == 0) return (int)cudaSuccess;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  const dim3 block(kWarpsPerBlock * 32);
  correlation_bwd_da_kernel<T><<<grid, block, 0, s>>>(g, b, da, n, h, w, c,
                                                      r, s2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  correlation_bwd_db_kernel<T><<<grid, block, 0, s>>>(g, a, db, n, h, w, c,
                                                      r, s2);
  return (int)cudaGetLastError();
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

// Backward on `stream`. grad: f32 NHWC (n, h, w, D*D), contiguous; a, b:
// the forward's inputs; da, db: outputs of a's shape and dtype (f32 when
// is_bf16 == 0, else bf16). Launches the da kernel, then the db kernel.
// Returns the first non-zero cudaGetLastError(), else 0.
extern "C" int flownet2_correlation_bwd(const void* grad, const void* a,
                                        const void* b, void* da, void* db,
                                        int n, int h, int w, int c,
                                        int max_displacement, int stride_2,
                                        int is_bf16, void* stream) {
  if (stride_2 <= 0 || max_displacement < 0 || c <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int r = max_displacement / stride_2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grad);
  if (is_bf16) {
    return launch_bwd<__nv_bfloat16>(
        g, static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(da), static_cast<__nv_bfloat16*>(db), n,
        h, w, c, r, stride_2, s);
  }
  return launch_bwd<float>(g, static_cast<const float*>(a),
                           static_cast<const float*>(b),
                           static_cast<float*>(da), static_cast<float*>(db),
                           n, h, w, c, r, stride_2, s);
}
