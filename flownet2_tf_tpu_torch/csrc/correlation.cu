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
// the frame. Inputs are NHWC-contiguous f32 or bf16; accumulation and
// output are f32; the output is NHWC (N, H, W, D*D), dy-major, like the
// JAX package.
//
// What bounds it on this card: at the FlowNet2 448x1024 shape,
// (1, 56, 128, 256) with d=20, s2=2, D=21, the in-frame products are
// 0.60 GMAC (of 0.81 G over all 441 displacements), 18 us of f32 FMA at
// 67 TFLOP/s; the bytes are 7.3 MB of each input and 12.6 MB of output
// (f32), 6 us at 3.35 TB/s. So f32 is bound by FMAs and bf16, whose
// products go to the tensor cores, by bytes. What a kernel has to avoid
// is the re-reads: every a pixel meets 441 b pixels and every b pixel
// 441 a pixels, which one warp per (pixel, dy) row pays for as ~6.5 GB of
// L1/L2 traffic per f32 pair.
//
// Design: a block owns output pixels [x0, x0 + s2*32) of two rows y and
// y + s2, and a group of b rows by = y + (k - r)*s2; output row t reads b
// row k at dy = k - t, so the two rows share every b window the block
// stages. Each output element is summed over all C by one thread (f32)
// or one warp's fragment (bf16), in a fixed order, and written once: no
// atomics, and two launches are bitwise equal. Splitting x by its residue
// mod s2 (x = s2*i + p) makes the b columns of one class contiguous, j =
// i + dxi: per row, b row and class the work is the band 0 <= j - i < D of
// a dense (32 x C) x (C x (32 + 2r)) product, the form of the JAX
// package's _correlation_mxu taken per row, without its skew. The block
// walks C in chunks; each chunk of its a tiles and b windows is staged in
// shared memory with 16-byte cp.async, double buffered, so the next
// chunk's copies overlap this chunk's products. Outside the frame the
// copies zero-fill (src-size 0), so the inner loops have no bounds
// checks; b rows outside the frame are neither copied nor computed, their
// outputs written as zeros. A per-block row table maps every staged row
// to its source pixel once, so a copy costs a table read and a cp.async.
// Accumulators stay in registers across the chunks; the outputs then go
// through a shared-memory tile and out as one contiguous run per pixel.
// * f32 (exact, no TF32): a stage holds 4 channels of a row as one float4
//   (quad-major), with a pad row after every 8 rows of a class so the rows
//   8 apart that a warp reads at once fall on distinct bank groups; each
//   thread keeps an 8 pixel x 8 displacement tile of accumulators and per
//   channel quad loads 8 a and 15 b float4s for 256 FFMAs.
// * bf16: a stage is pixel-major (144-byte rows, so ldmatrix's 8 rows hit
//   8 distinct bank groups); each warp owns 16 pixels of one class at one
//   b row and runs mma.sync m16n8k16 (bf16 in, f32 accumulate) on the n8
//   tiles that meet the band, ceil((16 + 2r) / 8) of them (5 at D = 21),
//   with fragments from ldmatrix. bf16 products are exact in f32, so only
//   the order of the sums differs from the plain version.
// Rows that are not 16-byte aligned (C % 4 != 0 in f32, C % 8 != 0 in
// bf16) are staged by element copies instead of cp.async. Offsets into
// the tensors are 64-bit.
//
// ---- Backward ----
//
// Replaces the TPU backward flownet2_tf_tpu/ops/pallas/correlation_kernel.py
// _bwd (lines 147-160), which differentiates the jnp oracle. With g the f32
// gradient of the (N, H, W, D*D) cost volume, delta_k = ((k/D - r)*s2,
// (k%D - r)*s2) and only in-frame terms:
//
//   da[p, c] = (1/C) sum_k g[p, k] * b[p + delta_k, c]
//   db[q, c] = (1/C) sum_k g[q - delta_k, k] * a[q - delta_k, c]
//
// Since delta_{D*D-1-k} = -delta_k, db is da's computation on a mirror-
// shifted gradient g'[q, k] = g[q + delta_k, D*D-1-k] (zero where q +
// delta_k is outside the frame): db[q, c] = (1/C) sum_k g'[q, k] *
// a[q + delta_k, c]. So one kernel body computes
//
//   out[p, c] = (1/C) sum_k G[p, k] * S[p + delta_k, c]
//
// as correlation_bwd_da_kernel (G = g, S = b) and correlation_bwd_db_kernel
// (G = g', S = a). db's kernel stages g' straight from g: g'[q, k] for the
// dy index k/D of one S row reads D consecutive floats of the g row of the
// window pixel q + delta_k, as da's reads D of its own pixel's, so g' is
// never written out. da and db come out in the input dtype, like _bwd's
// cast; sums are f32.
//
// What bounds it: at FlowNetC's chairs-crop conv3, (8, 40, 56, 256) with
// d=20, s2=2, each gradient takes 1.21 G in-frame multiply-adds, 36 us of
// f32 FMA at 67 TFLOP/s; g, a and b read once and da, db written once are
// 68 MB in f32 and 50 MB in bf16, 20 and 15 us at 3.35 TB/s. So f32 is
// bound by FMAs and bf16 by bytes. As in the forward, what a kernel has to
// avoid is the re-reads: every output pixel meets 441 pixels of S.
//
// Design: the forward's geometry with the roles of C and the band swapped.
// A block owns pixels x = x0 + cls + s2*i (i < 32) of one residue class
// cls mod s2, in up to four output rows y0 + s2*t, and 64 (f32) or 128
// (bf16) channels. It walks the S rows sy = y0 + (k - r)*s2 in frame;
// output row t reads S row k at dy index k - t, so the block's rows share
// every S window it stages. Per S row it stages, with cp.async, double
// buffered, zero-filled outside the frame, the S window (the class's
// pixels j = i + dx, 16-byte copies) and each output row's D-wide slice of
// G (4-byte copies: a pixel's g row is 1764 bytes, so the slices are not
// 16-byte aligned; one walk of the slice's addresses serves all the
// block's rows). The G slab is skewed (pixel group i/8, column i%8 + dx,
// entry i%8), so that for one window pixel j the G values of 8
// consecutive pixels are contiguous; its positions outside the band are
// zeroed once. Per row and S row the work is then a banded product,
// out(i, c) += sum_j G(i, j - i) S(j, c) over 0 <= j - i < D: M = pixels,
// N = channels, K = band columns. The sums stay in registers across all S
// rows; each output element is summed in a fixed order and written once:
// no atomics, and two launches are bitwise equal.
// * f32 (exact, no TF32): a thread owns 8 pixels x 8 channels; per window
//   pixel it loads the S row's 8 channels (2 float4) and the 8 pixels' G (2
//   float4, a broadcast) for 64 FFMAs, D + 7 steps per S row (D of them in
//   each pixel's band: 75% at D = 21).
// * bf16: a warp owns 16 pixels x 128 channels and runs mma.sync m16n8k16
//   (bf16 in, f32 accumulate) on the ceil((16 + D - 1) / 16) k16 chunks of
//   window pixels that meet the band (3 at D = 21). B is the S window
//   through ldmatrix.trans; A, the band of G, is built in registers from
//   the f32 slab as two bf16 fragments, hi = bf16(g) and lo = bf16(g - hi),
//   both multiplied into one f32 accumulator. Every product is exact in
//   f32 and hi + lo keeps 16 bits of g; one bf16 rounding of g misses the
//   plain version's bf16 gradients (tests/test_torch_corr_bwd.py). Building
//   A costs as many instructions as the products it feeds, so a warp
//   spreads each A over 16 n8 tiles (128 channels; 64 measured slower).
// Rows that are not 16-byte aligned are staged by element copies, as in
// the forward. What bounds it now (PERF.md): instruction issue, the 4-byte
// G copies and the A fragments, not FMAs, tensor cores or bytes.
// Offsets into the tensors are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ---- forward ----

constexpr int kXi = 32;       // pixels of one residue class in an x tile
constexpr int kSkipRow = -2;  // staged row of a dy row outside the frame

// Geometry of one forward launch, computed on the host (launch_fwd).
struct FwdParams {
  const void* a;
  const void* b;
  float* out;
  int n, h, w, c;
  int r, s2, dd;    // dd = D = 2r + 1
  int yt;           // output rows per block: y0 + s2*t, t < yt
  int ytiles;       // row tiles per image
  int kgr;          // b rows per block: k0 + kl, kl < kgr
  int ngroups;      // b row groups: k in [0, D + yt - 1)
  int xtiles;       // x tiles per image row
  int jb;           // b window rows staged per residue class
  int kg;           // f32: groups of 8 dx; bf16: chunks of 8 n8 tiles
  int nt;           // bf16: n8 tiles per 16 pixels, ceil((16 + 2r) / 8)
  int tasks;        // thread (f32) or warp (bf16) tasks per block
  int rows;         // staged rows per chunk: yt*s2*kXi of a, kgr*s2*jb of b
  int pad8;         // f32: a pad row after every 8 staged rows of a class
  int a_cls;        // stage rows between the classes of a (yt*s2 of them)
  int b_base;       // stage row of the first b row
  int b_cls;        // stage rows between the (b row, class) windows
  int str;          // f32: 16-byte rows between the channel quads of a stage
  int stage_bytes;  // one stage
  int tile_off;     // bytes: the output tile (aliases the stages if one pass)
  int tab_off;      // bytes: the row table
  int aligned16;    // rows and bases 16-byte aligned: cp.async 16
  float inv_c;
};

// A block owns output rows y0 + s2*t (t < yt) of image n, pixels [x0, x0 +
// s2*kXi) and b rows by = y0 + (k - r)*s2 for k in [k0, k0 + kgr): output
// row t at dy = k - t reads b row k, so the rows of a block share every b
// window they stage.
struct BlockPos {
  int y0, x0, k0;
  int64_t img;  // first pixel of image n
};

__device__ __forceinline__ BlockPos block_pos(const FwdParams& p) {
  int blk = blockIdx.x;
  const int xt = blk % p.xtiles;
  blk /= p.xtiles;
  const int grp = blk % p.ngroups;
  blk /= p.ngroups;
  const int ytl = blk % p.ytiles;  // residue ytl % s2, tile ytl / s2
  BlockPos bp;
  bp.img = (int64_t)(blk / p.ytiles) * p.h * p.w;
  bp.y0 = ytl % p.s2 + (ytl / p.s2) * p.yt * p.s2;
  bp.x0 = xt * p.s2 * kXi;
  bp.k0 = grp * p.kgr;
  return bp;
}

// Output row t at b row kl of the block reads an in-frame b row and has
// outputs (dy = k0 + kl - t in [0, D), row inside the image).
__device__ __forceinline__ bool has_outputs(const FwdParams& p,
                                            const BlockPos& bp, int t,
                                            int kl) {
  const int dy = bp.k0 + kl - t;
  return kl < p.kgr && dy >= 0 && dy < p.dd && bp.y0 + p.s2 * t < p.h;
}

__device__ __forceinline__ bool b_row_in_frame(const FwdParams& p,
                                               const BlockPos& bp, int kl) {
  const int by = bp.y0 + (bp.k0 + kl - p.r) * p.s2;
  return by >= 0 && by < p.h;
}

// Stage row of row i of a class.
__device__ __forceinline__ int class_row(const FwdParams& p, int i) {
  return p.pad8 ? i + (i >> 3) : i;
}

// The block's row table: for staged row q, the source pixel within the
// image (by*w + bx; -1 outside the frame, staged as zeros; kSkipRow: not
// staged, a row no task reads) and the row's place in a stage. Rows
// [0, yt*s2*kXi) are the a tiles, row t's pixel x = x0 + q % (s2*kXi);
// then, per b row kl, the window bx = x0 - d + jpix, jpix in [0, s2*jb).
// Pixel q or jpix goes to class q % s2, row q / s2.
__device__ void build_rows(const FwdParams& p, int2* tab, const BlockPos& bp) {
  const int xt_px = p.s2 * kXi;
  const int win = p.s2 * p.jb;
  const int d = p.r * p.s2;
  for (int q = threadIdx.x; q < p.rows; q += blockDim.x) {
    int2 e;
    if (q < p.yt * xt_px) {
      const int t = q / xt_px;
      const int xq = q % xt_px;
      const int y = bp.y0 + p.s2 * t;
      const int x = bp.x0 + xq;
      e.x = y >= p.h ? kSkipRow : x < p.w ? y * p.w + x : -1;
      e.y = (t * p.s2 + xq % p.s2) * p.a_cls + class_row(p, xq / p.s2);
    } else {
      const int u = q - p.yt * xt_px;
      const int kl = u / win;
      const int jpix = u % win;
      const int by = bp.y0 + (bp.k0 + kl - p.r) * p.s2;
      const int bx = bp.x0 - d + jpix;
      if (!b_row_in_frame(p, bp, kl)) {
        e.x = kSkipRow;
        e.y = 0;
      } else {
        e.x = (bx >= 0 && bx < p.w) ? by * p.w + bx : -1;
        e.y = p.b_base + (kl * p.s2 + jpix % p.s2) * p.b_cls +
              class_row(p, jpix / p.s2);
      }
    }
    tab[q] = e;
  }
}

// Whether any task of the block reads staged data.
__device__ __forceinline__ bool any_work(const FwdParams& p,
                                         const BlockPos& bp) {
  bool any = false;
  for (int t = 0; t < p.yt; ++t)
    for (int kl = 0; kl < p.kgr; ++kl)
      any |= has_outputs(p, bp, t, kl) && b_row_in_frame(p, bp, kl);
  return any;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (<= 16) from global to shared memory; the rest of
// the 16 bytes is zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage one chunk of channels: kGran 16-byte granules per staged row,
// granule g of row q at byte 16 * (g * gstr + e.y * rstr) of the stage.
// Granules past C and rows outside the frame are zero-filled; when rows
// are not 16-byte aligned a granule is copied element by element.
template <typename T, int kGran>
__device__ __forceinline__ void stage_chunk(const FwdParams& p,
                                            const int2* tab, int64_t img,
                                            int c0, unsigned char* stage,
                                            int gstr, int rstr) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per granule
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const int g = threadIdx.x % kGran;
  const int ch = c0 + kPer * g;
  const int nv = min(max(p.c - ch, 0), kPer);  // elements inside C
  const int a_rows = p.yt * p.s2 * kXi;
  for (int q = threadIdx.x / kGran; q < p.rows; q += blockDim.x / kGran) {
    const int2 e = tab[q];
    if (e.x == kSkipRow) continue;
    const int n_ok = e.x >= 0 ? nv : 0;
    const T* src = n_ok ? (q < a_rows ? a : b) + (img + e.x) * p.c + ch : a;
    unsigned char* dst = stage + 16 * (g * gstr + e.y * rstr);
    if (p.aligned16) {
      cp_async_16(dst, src, n_ok * (int)sizeof(T));
    } else {
      T v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = k < n_ok ? src[k] : T(0.0f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// The chunk loop, double buffered: chunk s + 1 is staged into one buffer
// while chunk s, in the other, is computed, so its copies overlap those
// products. compute(s, stage) runs once every thread's copies of the stage
// have landed. ns must be the same in every thread of the block.
template <typename Stage, typename Compute>
__device__ __forceinline__ void chunk_pipeline(unsigned char* smem,
                                               int stage_bytes, int ns,
                                               Stage stage, Compute compute) {
  if (ns <= 0) return;
  stage(0, smem);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) stage(s + 1, smem + ((s + 1) & 1) * stage_bytes);
    cp_async_commit();  // empty after the last chunk: one group per chunk
    cp_async_wait<1>();
    __syncthreads();
    compute(s, smem + (s & 1) * stage_bytes);
    __syncthreads();  // the next copies overwrite this buffer
  }
}

// Output tile: pixel xl of row t at b row kl, dxi at tile[tile_at(...) +
// dxi]. Its zeros for b rows outside the frame are written there too.
__device__ __forceinline__ int tile_at(const FwdParams& p, int xl, int t,
                                       int kl) {
  return ((xl * p.yt + t) * p.kgr + kl) * p.dd;
}

// Copy the output tile out: the block's dy rows of one output pixel are
// one contiguous run of the output, written by one warp, lane by lane.
__device__ __forceinline__ void store_tile(const FwdParams& p,
                                           const BlockPos& bp,
                                           const float* tile) {
  const int lane = threadIdx.x & 31;
  const int xt_px = p.s2 * kXi;
  for (int u = threadIdx.x >> 5; u < xt_px * p.yt; u += blockDim.x >> 5) {
    const int xl = u / p.yt, t = u % p.yt;
    const int x = bp.x0 + xl;
    const int y = bp.y0 + p.s2 * t;
    if (x >= p.w || y >= p.h) continue;
    // b rows kl in [lo, hi) give dy = k0 + kl - t in [0, D)
    const int lo = max(0, t - bp.k0);
    const int hi = min(p.kgr, p.dd + t - bp.k0);
    if (lo >= hi) continue;
    const float* src = tile + tile_at(p, xl, t, lo);
    float* dst = p.out + (bp.img + (int64_t)y * p.w + x) * (p.dd * p.dd) +
                 (bp.k0 + lo - t) * p.dd;
    for (int k = lane; k < (hi - lo) * p.dd; k += 32) dst[k] = src[k];
  }
}

// ---- forward, f32: register-tiled FFMA ----

constexpr int kF32Ck = 16;        // channels per stage: four quads
constexpr int kF32Threads = 256;  // most threads per block

// Thread task: 8 pixels (class cls, rows 8*ig .. 8*ig+7) of output row t x
// 8 displacements (dxi = 8*kq .. 8*kq+7) at b row kl; acc[i][k] = sum_c
// a[i] * b[i + k].
// A stage holds, per channel quad, each staged row's 4 channels as one
// float4 (row q of quad cq at float4 [cq * str + q]), and a class has a
// pad row after every 8 rows, so the a rows 8 apart and the b rows 8
// apart that a warp reads at once fall on other bank groups.
__global__ void __launch_bounds__(kF32Threads, 2)
correlation_fwd_f32_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem + p.tile_off);
  int2* tab = reinterpret_cast<int2*>(smem + p.tab_off);
  const BlockPos bp = block_pos(p);
  build_rows(p, tab, bp);
  const bool any = any_work(p, bp);
  const int ns = (p.c + kF32Ck - 1) / kF32Ck;
  __syncthreads();  // the row table

  for (int base = 0; base < p.tasks; base += blockDim.x) {
    int t = base + threadIdx.x;
    const int kq = t % p.kg;
    t /= p.kg;
    const int ig = t % (kXi / 8);
    t /= kXi / 8;
    const int cls = t % p.s2;
    t /= p.s2;
    const int kl = t % p.kgr;
    const int ty = t / p.kgr;  // output row
    const bool mine = ty < p.yt && has_outputs(p, bp, ty, kl);
    const bool work = mine && b_row_in_frame(p, bp, kl);
    // stage rows of a row 8*ig and b row 8*(ig + kq): 9 per 8 with the pads
    const int a_row = (ty * p.s2 + cls) * p.a_cls + 9 * ig;
    const int b_row = p.b_base + (kl * p.s2 + cls) * p.b_cls + 9 * (ig + kq);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.0f;

    if (any) {
      chunk_pipeline(
          smem, p.stage_bytes, ns,
          [&](int s, unsigned char* stage) {
            stage_chunk<float, kF32Ck / 4>(p, tab, bp.img, s * kF32Ck, stage,
                                           p.str, 1);
          },
          [&](int, const unsigned char* stage) {
            if (!work) return;
            const float4* st = reinterpret_cast<const float4*>(stage);
#pragma unroll
            for (int cq = 0; cq < kF32Ck / 4; ++cq) {
              const float4* sq = st + cq * p.str;
              float4 av[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) av[i] = sq[a_row + i];
#pragma unroll
              for (int j = 0; j < 15; ++j) {
                const float4 bv = sq[b_row + j + (j >> 3)];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  const int k = j - i;
                  if (k < 0 || k >= 8) continue;
                  float v = acc[i][k];
                  v = fmaf(av[i].x, bv.x, v);
                  v = fmaf(av[i].y, bv.y, v);
                  v = fmaf(av[i].z, bv.z, v);
                  acc[i][k] = fmaf(av[i].w, bv.w, v);
                }
              }
            }
          });
    }

    if (mine) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* o = tile + tile_at(p, cls + p.s2 * (8 * ig + i), ty, kl) + 8 * kq;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (8 * kq + k < p.dd) o[k] = acc[i][k] * p.inv_c;
      }
    }
  }
  __syncthreads();
  store_tile(p, bp, tile);
}

// ---- forward, bf16: mma.sync on tensor cores ----

constexpr int kBfCk = 64;                // channels per stage
constexpr int kBfRow = (kBfCk + 8) * 2;  // bytes per staged row (144)
constexpr int kBfWarps = 16;             // most warps per block

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// acc += A (16x16, row-major) * B (16x8, col-major)
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp task: 16 pixels (class cls, rows 16*ig .. 16*ig+15) of output row t
// against up to 8 n8 tiles of b window rows from j0 = 16*ig + 64*nc, at b
// row kl. A stage holds each staged row's kBfCk channels as one 80-byte
// row (pixel-major).
__global__ void __launch_bounds__(kBfWarps * 32)
correlation_fwd_bf16_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem + p.tile_off);
  int2* tab = reinterpret_cast<int2*>(smem + p.tab_off);
  const BlockPos bp = block_pos(p);
  build_rows(p, tab, bp);
  const bool any = any_work(p, bp);
  const int ns = (p.c + kBfCk - 1) / kBfCk;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the row table

  for (int base = 0; base < p.tasks; base += nwarps) {
    int t = base + (threadIdx.x >> 5);
    const int nc = t % p.kg;
    t /= p.kg;
    const int ig = t % (kXi / 16);
    t /= kXi / 16;
    const int cls = t % p.s2;
    t /= p.s2;
    const int kl = t % p.kgr;
    const int ty = t / p.kgr;  // output row
    const bool mine = ty < p.yt && has_outputs(p, bp, ty, kl);
    const bool work = mine && b_row_in_frame(p, bp, kl);
    const int ntc = min(8, p.nt - 8 * nc);
    const int j0 = 16 * ig + 64 * nc;
    // ldmatrix row addresses (bytes within a stage). A, x4: lanes 0-15
    // rows 0-15 at k 0-7, lanes 16-31 the same rows at k 8-15. B, x4:
    // (tile n, k 0-7), (n, k 8-15), (n+1, k 0-7), (n+1, k 8-15); x2 the
    // first two.
    const int a_addr = ((ty * p.s2 + cls) * p.a_cls + 16 * ig + (lane & 15)) *
                           kBfRow +
                       (lane >> 4) * 16;
    const int b_addr = (p.b_base + (kl * p.s2 + cls) * p.b_cls + j0 +
                        ((lane >> 4) << 3) + (lane & 7)) * kBfRow +
                       ((lane >> 3) & 1) * 16;

    float acc[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] = 0.0f;

    if (any) {
      chunk_pipeline(
          smem, p.stage_bytes, ns,
          [&](int s, unsigned char* stage) {
            stage_chunk<__nv_bfloat16, kBfCk / 8>(p, tab, bp.img, s * kBfCk,
                                                  stage, 1, kBfRow / 16);
          },
          [&](int, const unsigned char* st) {
            if (!work) return;  // warp-uniform
#pragma unroll
            for (int kk = 0; kk < kBfCk / 16; ++kk) {
              unsigned af[4], bf[4];
              ldmatrix_x4(af, st + a_addr + 32 * kk);
#pragma unroll
              for (int n = 0; n < 8; n += 2) {
                const unsigned char* bn = st + b_addr + n * 8 * kBfRow + 32 * kk;
                if (n + 1 < ntc) {
                  ldmatrix_x4(bf, bn);
                  mma_bf16(acc[n], af, bf[0], bf[1]);
                  mma_bf16(acc[n + 1], af, bf[2], bf[3]);
                } else if (n < ntc) {
                  ldmatrix_x2(bf, bn);
                  mma_bf16(acc[n], af, bf[0], bf[1]);
                }
              }
            }
          });
    }

    if (mine) {  // C fragment: acc[n][2h + e] is row g + 8h, col 2*tq + e
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * ig + g + 8 * h;
        float* o = tile + tile_at(p, cls + p.s2 * i, ty, kl);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n >= ntc) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int dxi = j0 + 8 * n + 2 * tq + e - i;
            if (dxi >= 0 && dxi < p.dd) o[dxi] = acc[n][2 * h + e] * p.inv_c;
          }
        }
      }
    }
  }
  __syncthreads();
  store_tile(p, bp, tile);
}

// Choose the tiles for (n, h, w, c, r, s2) and launch.
int launch_fwd(const void* a, const void* b, float* out, int n, int h, int w,
               int c, int r, int s2, bool bf16, cudaStream_t stream) {
  FwdParams p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w;
  p.c = c;
  p.r = r;
  p.s2 = s2;
  p.dd = 2 * r + 1;
  p.inv_c = 1.0f / (float)c;
  const int xt_px = s2 * kXi;
  p.xtiles = (w + xt_px - 1) / xt_px;
  int per_dy, most;
  if (bf16) {
    p.nt = (16 + 2 * r + 7) / 8;
    p.kg = (p.nt + 7) / 8;
    p.jb = kXi - 16 + 8 * p.nt;
    per_dy = s2 * (kXi / 16) * p.kg;  // warps
    most = kBfWarps;
  } else {
    p.nt = 0;
    p.kg = (p.dd + 7) / 8;
    p.jb = kXi + 8 * p.kg;
    per_dy = s2 * (kXi / 8) * p.kg;  // threads
    most = kF32Threads;
  }
  // two output rows per block where their tasks fit, sharing the b rows;
  // then as many b rows as fit, balanced over the groups
  p.yt = 2 * per_dy <= most && h > s2 ? 2 : 1;
  const int krows = p.dd + p.yt - 1;
  const int kgr = std::max(1, std::min(krows, most / (p.yt * per_dy)));
  p.ngroups = (krows + kgr - 1) / kgr;
  p.kgr = (krows + p.ngroups - 1) / p.ngroups;
  p.ytiles = s2 * ((h + s2 * p.yt - 1) / (s2 * p.yt));
  p.tasks = p.yt * p.kgr * per_dy;
  p.rows = p.yt * xt_px + p.kgr * s2 * p.jb;
  const uintptr_t align = (uintptr_t)a | (uintptr_t)b;
  int threads;
  if (bf16) {
    threads = 32 * std::min(p.tasks, most);
    p.pad8 = 0;
    p.a_cls = kXi;
    p.b_base = p.yt * s2 * kXi;
    p.b_cls = p.jb;
    p.str = 0;
    p.stage_bytes = p.rows * kBfRow;
    p.aligned16 = c % 8 == 0 && align % 16 == 0;
  } else {
    threads = (std::min(p.tasks, most) + 31) / 32 * 32;
    p.pad8 = 1;
    p.a_cls = kXi + kXi / 8;  // 36: class 1 starts 4 bank groups over
    p.b_base = p.yt * s2 * p.a_cls;
    p.b_cls = p.jb + p.jb / 8;
    p.str = p.b_base + p.kgr * s2 * p.b_cls;
    p.stage_bytes = 16 * (kF32Ck / 4) * p.str;
    p.aligned16 = c % 4 == 0 && align % 16 == 0;
  }
  const size_t stages = 2 * (size_t)p.stage_bytes;  // double buffered
  const size_t tile = 4 * (size_t)xt_px * p.yt * p.kgr * p.dd;
  // one pass over the tasks: the tile reuses the stages once they are read
  p.tile_off = p.tasks <= most ? 0 : (int)stages;
  const size_t tab = (std::max(stages, p.tile_off + tile) + 15) / 16 * 16;
  const size_t smem = tab + (size_t)p.rows * sizeof(int2);
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  p.tab_off = (int)tab;
  const int64_t blocks = (int64_t)n * p.ytiles * p.ngroups * p.xtiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const void* kern = bf16 ? (const void*)correlation_fwd_bf16_kernel
                          : (const void*)correlation_fwd_f32_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16) {
    correlation_fwd_bf16_kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  } else {
    correlation_fwd_f32_kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// ---- backward ----

constexpr int kBwdYt = 4;       // most output rows per block
constexpr int kBwdCbF32 = 64;   // channels per block, f32
constexpr int kBwdCbBf = 128;   // channels per block (and per warp), bf16
constexpr int kBwdRowBf = 2 * kBwdCbBf + 16;  // bytes per staged S row, bf16
constexpr int kGCol = 12;  // floats per skewed G column: 8 pixels and a pad

// Geometry of one da-form launch, computed on the host (launch_bwd).
struct BwdParams {
  const float* g;    // G: (n, h, w, D*D) f32
  const void* s;     // S: (n, h, w, c), f32 or bf16
  void* out;         // (n, h, w, c), S's dtype
  int h, w, c;
  int r, s2, dd;     // dd = D = 2r + 1
  int yt;            // output rows per block: y0 + s2*t, t < yt
  int ytiles;        // row tiles per image
  int xtiles;        // x tiles per image row
  int cb;            // channels per block
  int cchunks;       // channel chunks of cb
  int jb;            // staged window pixels of the block's class
  int pj;            // skewed G columns per pixel group: D + 7
  int pgs;           // floats between the pixel groups of a G slab
  int s_bytes;       // the S window's bytes in a stage; the G slab follows
  int stage_bytes;   // one stage
  int aligned16;     // S rows, bases and outputs 16-byte aligned
  float inv_c;
};

// A block owns pixels x = x0 + cls + s2*i (i < kXi) of output rows y0 +
// s2*t (t < rows <= yt, the rows in frame), channels [c0, c0 + cb),
// and walks the S rows k in [k_lo, k_hi): y0 + (k - r)*s2 in frame, read
// by a row in frame.
struct BwdPos {
  int y0, x0, cls, c0;
  int rows, k_lo, k_hi;
  int64_t img;  // first pixel of image n
};

__device__ __forceinline__ BwdPos bwd_pos(const BwdParams& p) {
  int blk = blockIdx.x;
  BwdPos bp;
  bp.c0 = (blk % p.cchunks) * p.cb;
  blk /= p.cchunks;
  bp.cls = blk % p.s2;
  blk /= p.s2;
  bp.x0 = (blk % p.xtiles) * p.s2 * kXi;
  blk /= p.xtiles;
  const int ytl = blk % p.ytiles;
  bp.img = (int64_t)(blk / p.ytiles) * p.h * p.w;
  const int res = ytl % p.s2;  // y0 = res + s2*q
  const int q = (ytl / p.s2) * p.yt;
  bp.y0 = res + p.s2 * q;
  // S row k is res + s2*(q + k - r); output row t reads k in [t, t + D)
  bp.rows = bp.y0 < p.h ? min(p.yt, (p.h - 1 - bp.y0) / p.s2 + 1) : 0;
  bp.k_lo = max(0, p.r - q);
  bp.k_hi = bp.rows ? min(bp.rows - 1 + p.dd,
                          p.r - q + (p.h - 1 - res) / p.s2 + 1)
                    : bp.k_lo;
  return bp;
}

// cp.async of 4 bytes, or of 4 zero bytes when bytes is 0.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// Stage S row k: the class's window pixels j (16-byte granules of the
// block's channels, rows kRow bytes apart), then, for each output row t
// whose dy index dyi = k - t is in [0, D), the slab of G(i, dx) at
// t*(kXi/8)*pgs + (i/8)*pgs + kGCol*(i%8 + dx) + i%8:
// * da (kMirror false): G = g[y, x_i, dyi*D + dx], walked by (i, dx);
// * db (kMirror true): G = g'[y, x_i, dyi*D + dx] = g[sy, bx_j, (D-1-dyi)*D
//   + u] with j = i + dx the window pixel and u = D-1-dx, walked by (j, u),
//   so that both read runs of D floats of one pixel's g row.
// The walk's address arithmetic is shared by the rows t: their sources
// are tstride floats apart.
template <typename T, int kCb, int kRow, bool kMirror>
__device__ __forceinline__ void bwd_stage(const BwdParams& p,
                                          const BwdPos& bp, int k,
                                          unsigned char* st) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per granule
  constexpr int kGran = kCb / kPer;          // granules per staged row
  const T* s = static_cast<const T*>(p.s);
  const int sy = bp.y0 + (k - p.r) * p.s2;
  const int gi = threadIdx.x % kGran;
  const int ch = bp.c0 + kPer * gi;
  const int nv = min(max(p.c - ch, 0), kPer);  // elements inside C
  const int bx0 = bp.x0 + bp.cls - p.r * p.s2;  // window pixel j: bx0 + s2*j
  for (int j = threadIdx.x / kGran; j < p.jb; j += blockDim.x / kGran) {
    const int bx = bx0 + p.s2 * j;
    const int n_ok = bx >= 0 && bx < p.w ? nv : 0;
    const T* src = n_ok ? s + (bp.img + (int64_t)sy * p.w + bx) * p.c + ch : s;
    unsigned char* dst = st + j * kRow + 16 * gi;
    if (p.aligned16) {
      cp_async_16(dst, src, n_ok * (int)sizeof(T));
    } else {
      T v[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[e] = e < n_ok ? src[e] : T(0.0f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }

  float* slab = reinterpret_cast<float*>(st + p.s_bytes);
  const int dd = p.dd;
  const int64_t dd2 = dd * dd;
  const int t_lo = max(0, k - dd + 1), t_hi = min(bp.rows, k + 1);
  const int tslab = (kXi / 8) * p.pgs;
  const int64_t tstride = kMirror ? dd : (int64_t)p.s2 * p.w * dd2 - dd;
  const int nrow = kMirror ? kXi + dd - 1 : kXi;
  // (row, col) walked flat, col fastest, blockDim.x at a time
  const int qs = blockDim.x / dd, rs = blockDim.x % dd;
  int row = threadIdx.x / dd, col = threadIdx.x % dd;
  for (; row < nrow; row += qs, col += rs) {
    if (col >= dd) {
      col -= dd;
      ++row;
      if (row >= nrow) break;
    }
    int i, dx, px;  // px: the source pixel's x; its row is y0 or sy
    if (kMirror) {
      i = row - (dd - 1) + col;
      dx = dd - 1 - col;
      px = bx0 + p.s2 * row;
      if (i < 0 || i >= kXi) continue;
    } else {
      i = row;
      dx = col;
      px = bp.x0 + bp.cls + p.s2 * i;
    }
    const bool ok = px >= 0 && px < p.w;
    const float* src =
        kMirror ? p.g + (bp.img + (int64_t)sy * p.w + px) * dd2 +
                      (dd - 1 - k) * dd + col
                : p.g + (bp.img + (int64_t)bp.y0 * p.w + px) * dd2 + k * dd +
                      col;
    float* dst = slab + (i >> 3) * p.pgs + kGCol * (dx + (i & 7)) + (i & 7);
    for (int t = t_lo; t < t_hi; ++t) {
      cp_async_4(dst + t * tslab, ok ? src + t * tstride : p.g, ok ? 4 : 0);
    }
  }
}

// Zero both stages' G slabs: the positions outside the band are never
// copied to and must read as zeros.
__device__ __forceinline__ void bwd_zero_slabs(const BwdParams& p,
                                               unsigned char* smem) {
  const int n = p.yt * (kXi / 8) * p.pgs;
  for (int st = 0; st < 2; ++st) {
    float* slab = reinterpret_cast<float*>(smem + st * p.stage_bytes +
                                           p.s_bytes);
    for (int e = threadIdx.x; e < n; e += blockDim.x) slab[e] = 0.0f;
  }
}

// f32 (kMirror: db's staging): thread task 8 pixels (row t, pixels 8*ig ..
// 8*ig+7 of the class) x 8 channels (4*cg .. 4*cg+3 and kBwdCbF32/2 + the
// same); acc[m][q] = sum over S rows and window pixels j of
// G(8*ig + m, j - 8*ig - m) * S(j, q).
template <bool kMirror>
__device__ __forceinline__ void bwd_f32(const BwdParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdPos bp = bwd_pos(p);
  bwd_zero_slabs(p, smem);
  const int cg = threadIdx.x % 8;
  const int pg = threadIdx.x / 8;  // the pixel group of the slab
  const int t = pg / (kXi / 8), ig = pg % (kXi / 8);
  const int y = bp.y0 + p.s2 * t;
  const bool mine = y < p.h && bp.x0 + bp.cls + p.s2 * 8 * ig < p.w;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.0f;
  __syncthreads();  // the zeroed slabs

  chunk_pipeline(
      smem, p.stage_bytes, bp.k_hi - bp.k_lo,
      [&](int s, unsigned char* st) {
        bwd_stage<float, kBwdCbF32, 4 * kBwdCbF32, kMirror>(p, bp,
                                                             bp.k_lo + s, st);
      },
      [&](int s, const unsigned char* st) {
        const int dyi = bp.k_lo + s - t;
        if (!mine || dyi < 0 || dyi >= p.dd) return;
        const float* sp =
            reinterpret_cast<const float*>(st) + 8 * ig * kBwdCbF32 + 4 * cg;
        const float* gp =
            reinterpret_cast<const float*>(st + p.s_bytes) + pg * p.pgs;
#pragma unroll 2
        for (int jj = 0; jj < p.pj; ++jj) {
          const float* sj = sp + jj * kBwdCbF32;
          const float4 s0 = *reinterpret_cast<const float4*>(sj);
          const float4 s1 =
              *reinterpret_cast<const float4*>(sj + kBwdCbF32 / 2);
          const float4 g0 = *reinterpret_cast<const float4*>(gp + jj * kGCol);
          const float4 g1 =
              *reinterpret_cast<const float4*>(gp + jj * kGCol + 4);
          const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[m][q] = fmaf(gv[m], sv[q], acc[m][q]);
        }
      });

  if (!mine) return;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int x = bp.x0 + bp.cls + p.s2 * (8 * ig + m);
    if (x >= p.w) continue;
    float* o = out + (bp.img + (int64_t)y * p.w + x) * p.c;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = bp.c0 + hh * (kBwdCbF32 / 2) + 4 * cg;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[m][4 * hh + e] * p.inv_c;
      if (p.aligned16 && c + 4 <= p.c) {
        *reinterpret_cast<float4*>(o + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < p.c) o[c + e] = v[e];
      }
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// (v0, v1) as two packed bf16 pairs, hi = bf16(v) and lo = bf16(v - hi);
// v0 in the low halves.
__device__ __forceinline__ void split_bf16(float v0, float v1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// bf16 (kMirror: db's staging): warp task 16 pixels (row t, pixels 16*ig ..
// 16*ig+15 of the class, slab pixel groups pg0 and pg0 + 1) x kBwdCbBf
// channels (kNt n8 tiles). A stage holds the S window pixel-major,
// kBwdRowBf bytes a row.
template <bool kMirror>
__device__ __forceinline__ void bwd_bf16(const BwdParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdPos bp = bwd_pos(p);
  bwd_zero_slabs(p, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = warp / (kXi / 16), ig = warp % (kXi / 16);
  const int y = bp.y0 + p.s2 * t;
  const bool mine = y < p.h && bp.x0 + bp.cls + p.s2 * 16 * ig < p.w;
  const int nkc = (p.dd + 30) / 16;  // k16 chunks: ceil((16 + D - 1) / 16)
  const int g8 = lane >> 2, tq = lane & 3;
  const int pg0 = t * (kXi / 8) + 2 * ig;
  // ldmatrix.trans row addresses: lanes 0-7 window pixels 0-7 of n tile n,
  // lanes 8-15 pixels 8-15, lanes 16-31 the same for tile n + 1
  const int b_addr =
      (16 * ig + (lane & 7) + (lane & 8)) * kBwdRowBf + 16 * (lane >> 4);
  constexpr int kNt = kBwdCbBf / 8;
  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  __syncthreads();  // the zeroed slabs

  chunk_pipeline(
      smem, p.stage_bytes, bp.k_hi - bp.k_lo,
      [&](int s, unsigned char* st) {
        bwd_stage<__nv_bfloat16, kBwdCbBf, kBwdRowBf, kMirror>(
            p, bp, bp.k_lo + s, st);
      },
      [&](int s, const unsigned char* st) {
        const int dyi = bp.k_lo + s - t;
        if (!mine || dyi < 0 || dyi >= p.dd) return;  // warp-uniform
        const float* slab =
            reinterpret_cast<const float*>(st + p.s_bytes) + pg0 * p.pgs + g8;
        for (int kc = 0; kc < nkc; ++kc) {
          // A fragment: register ri holds row g8 + 8*(ri & 1), columns
          // 2*tq + 8*(ri >> 1) and the next of window chunk kc; rows 8-15
          // are the next pixel group, whose slab columns start 8 later
          unsigned ahi[4], alo[4];
#pragma unroll
          for (int ri = 0; ri < 4; ++ri) {
            const int hrow = ri & 1;
            const int col = 16 * kc + 2 * tq + 8 * (ri >> 1) - 8 * hrow;
            const float* gp = slab + hrow * p.pgs;
            const float v0 = col >= 0 && col < p.pj ? gp[kGCol * col] : 0.0f;
            const float v1 =
                col + 1 >= 0 && col + 1 < p.pj ? gp[kGCol * (col + 1)] : 0.0f;
            split_bf16(v0, v1, ahi[ri], alo[ri]);
          }
          const unsigned char* bk = st + b_addr + 16 * kc * kBwdRowBf;
#pragma unroll
          for (int n = 0; n < kNt; n += 2) {
            unsigned bf[4];
            ldmatrix_x4_trans(bf, bk + 16 * n);
            mma_bf16(acc[n], ahi, bf[0], bf[1]);
            mma_bf16(acc[n], alo, bf[0], bf[1]);
            mma_bf16(acc[n + 1], ahi, bf[2], bf[3]);
            mma_bf16(acc[n + 1], alo, bf[2], bf[3]);
          }
        }
      });

  if (!mine) return;
  // C fragment: acc[n][2h + e] is pixel 16*ig + g8 + 8h, channel 8n + 2tq + e
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int x = bp.x0 + bp.cls + p.s2 * (16 * ig + g8 + 8 * hh);
    if (x >= p.w) continue;
    __nv_bfloat16* o = out + (bp.img + (int64_t)y * p.w + x) * p.c;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const int c = bp.c0 + 8 * n + 2 * tq;
      const float v0 = acc[n][2 * hh] * p.inv_c;
      const float v1 = acc[n][2 * hh + 1] * p.inv_c;
      if (c + 1 < p.c && p.c % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < p.c) o[c] = __float2bfloat16(v0);
        if (c + 1 < p.c) o[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// da = (1/C) sum_k g[p, k] * b[p + delta_k]: G = g, S = b.
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 4 ? kBwdYt * 32 : kBwdYt * 64)
correlation_bwd_da_kernel(const BwdParams p) {
  if constexpr (sizeof(T) == 4) {
    bwd_f32<false>(p);
  } else {
    bwd_bf16<false>(p);
  }
}

// db = (1/C) sum_k g'[q, k] * a[q + delta_k]: G = g', staged from g, S = a.
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 4 ? kBwdYt * 32 : kBwdYt * 64)
correlation_bwd_db_kernel(const BwdParams p) {
  if constexpr (sizeof(T) == 4) {
    bwd_f32<true>(p);
  } else {
    bwd_bf16<true>(p);
  }
}

int set_smem(const void* kern, size_t smem) {
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Choose the tiles for (n, h, w, c, r, s2); launch da, then db.
template <typename T>
int launch_bwd(const float* g, const T* a, const T* b, T* da, T* db, int n,
               int h, int w, int c, int r, int s2, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  BwdParams p;
  p.h = h;
  p.w = w;
  p.c = c;
  p.r = r;
  p.s2 = s2;
  p.dd = 2 * r + 1;
  p.inv_c = 1.0f / (float)c;
  p.yt = std::min(kBwdYt, (h + s2 - 1) / s2);
  p.ytiles = s2 * ((h + s2 * p.yt - 1) / (s2 * p.yt));
  p.xtiles = (w + s2 * kXi - 1) / (s2 * kXi);
  p.cb = kBf16 ? kBwdCbBf : kBwdCbF32;
  p.cchunks = (c + p.cb - 1) / p.cb;
  p.pj = p.dd + 7;
  p.pgs = p.pj * kGCol + 4;  // pixel groups 16-byte aligned, on other banks
  p.jb = kBf16 ? 16 + 16 * ((p.dd + 30) / 16) : kXi + p.dd - 1;
  p.s_bytes = p.jb * (kBf16 ? kBwdRowBf : 4 * kBwdCbF32);
  p.stage_bytes = p.s_bytes + 4 * p.yt * (kXi / 8) * p.pgs;
  const uintptr_t align =
      (uintptr_t)a | (uintptr_t)b | (uintptr_t)da | (uintptr_t)db;
  p.aligned16 = c % (kBf16 ? 8 : 4) == 0 && align % 16 == 0;
  const size_t smem = 2 * (size_t)p.stage_bytes;  // double buffered
  const int64_t blocks = (int64_t)n * p.ytiles * p.xtiles * s2 * p.cchunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int threads = p.yt * (kBf16 ? 64 : 32);
  int err = set_smem((const void*)correlation_bwd_da_kernel<T>, smem);
  if (err == 0) err = set_smem((const void*)correlation_bwd_db_kernel<T>, smem);
  if (err != 0) return err;
  p.g = g;
  p.s = b;
  p.out = da;
  correlation_bwd_da_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  p.s = a;
  p.out = db;
  correlation_bwd_db_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(p);
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
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  if ((int64_t)h * w > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch_fwd(a, b, static_cast<float*>(out), n, h, w, c,
                    max_displacement / stride_2, stride_2, is_bf16 != 0,
                    static_cast<cudaStream_t>(stream));
}

// Backward on `stream`. grad: f32 NHWC (n, h, w, D*D), contiguous; a, b:
// the forward's inputs; da, db: outputs of a's shape and dtype (f32 when
// is_bf16 == 0, else bf16). Launches the da kernel, then the db kernel.
// Returns the first non-zero CUDA error, else 0.
extern "C" int flownet2_correlation_bwd(const void* grad, const void* a,
                                        const void* b, void* da, void* db,
                                        int n, int h, int w, int c,
                                        int max_displacement, int stride_2,
                                        int is_bf16, void* stream) {
  if (stride_2 <= 0 || max_displacement < 0 || c <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  if ((int64_t)h * w > 0x7fffffff) return (int)cudaErrorInvalidValue;
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
