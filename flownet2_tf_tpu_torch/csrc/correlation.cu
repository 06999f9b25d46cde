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

#include <algorithm>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kWarpsPerBlock = 8;  // backward

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
// products. compute(stage) runs once every thread's copies of the stage
// have landed.
template <typename Stage, typename Compute>
__device__ __forceinline__ void chunk_pipeline(const FwdParams& p,
                                               unsigned char* smem, int ns,
                                               Stage stage, Compute compute) {
  stage(0, smem);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) stage(s + 1, smem + ((s + 1) & 1) * p.stage_bytes);
    cp_async_commit();  // empty after the last chunk: one group per chunk
    cp_async_wait<1>();
    __syncthreads();
    compute(smem + (s & 1) * p.stage_bytes);
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
          p, smem, ns,
          [&](int s, unsigned char* stage) {
            stage_chunk<float, kF32Ck / 4>(p, tab, bp.img, s * kF32Ck, stage,
                                           p.str, 1);
          },
          [&](const unsigned char* stage) {
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
          p, smem, ns,
          [&](int s, unsigned char* stage) {
            stage_chunk<__nv_bfloat16, kBfCk / 8>(p, tab, bp.img, s * kBfCk,
                                                  stage, 1, kBfRow / 16);
          },
          [&](const unsigned char* st) {
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
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  if ((int64_t)h * w > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch_fwd(a, b, static_cast<float*>(out), n, h, w, c,
                    max_displacement / stride_2, stride_2, is_bf16 != 0,
                    static_cast<cudaStream_t>(stream));
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
