// Fused bottleneck tail for Hopper (sm_90a): 1x1 conv + batch norm +
// residual add + relu, forward and backward, as four entry points.
//
// Replaces the four Pallas TPU kernels of
// deeplearning4j_tpu/ops/fused_block.py (launched by _fwd_impl and
// _bwd_impl) and computes their functions. With x [M, K] the NHWC input
// flattened, W [K, N], cd the compute dtype (f32 or bf16) and
// z = round_cd(x @ W) (the f32 product rounded through cd, _round_trip):
//
//   K4 stats       s1 = sum_m (z - shift), s2 = sum_m (z - shift)^2, [N] f32
//   K5 apply       y = relu(z * scale + sh + shortcut) in f32, stored in cd
//   K6 bwd_stats   a = sum_m g, b = sum_m g * xhat, with g = dy * [y > 0]
//                  and xhat = (z - mean) * inv
//   K7 bwd_apply   dz = round_cd(scale * (g - ca - xhat * cb));
//                  dx = dz @ W^T (f32 sums, stored in cd);
//                  dW = x^T @ dz (f32); dshortcut = g (cd)
//
// z is recomputed by every pass and never stored, as on the TPU. Every
// pass rounds z through cd before any use and runs its epilogue in f32.
// The four passes see the same z because they form it with the same loop:
// on the sm90 path (bf16 where TMA can read every operand, below) all four
// form z = x W on the one Hopper mainloop with the same operands, maps and
// order of sums, so their f32 sums, and z, agree bit for bit; on the
// first paths (f32, or bf16 at shapes TMA cannot read) all four use the
// same first mainloop of their dtype. The bf16 loops (wgmma, mma.sync)
// both add their k16 products into f32 with k ascending; whether the two
// round z alike is the tensor cores' to say, and chip_smoke.py's [times]
// counts the elements on which they differ (z_bits).
//
// What bounds it: at ResNet-50's stage shapes (b = 256, 224 x 224, bf16)
// each product is 26.3 GFLOP; K4 is bound by its operations (0.027 ms at
// the bf16 tensor-core rate), K5, K6 and K7 by their bytes (K5 and K6 move
// 462 MB at stage 1, 0.14 ms; K7 719 MB, 0.21 ms).
//
// What the design does about it. Every pass is one tiled GEMM with its
// epilogue. In bf16, when every row is a multiple of 16 bytes and every
// base 16-byte aligned (every ResNet-50 tail), all four passes run on the
// Hopper mainloop of sm90_gemm.cuh: TMA loads into a ring of stages, one
// producer warp, two consumer warpgroups on wgmma m64n128k16, persistent
// blocks, the sums in registers. z = x W reads A K-major and B MN-major;
// K7's dx = dz W^T both K-major, dW = x^T dz both MN-major. With the
// products at the tensor cores' rate K5-K7 are bound by their bytes, so
// their epilogues move whole sectors; K4 is bound by its operations, but
// at stage 1 each of its tiles takes only two 64-deep steps against an
// epilogue of 56 shuffles and a barrier:
//
// - K5 (ApplyEpi) and K7's dz pass (DzEpi) have TMA bring their [M, N]
//   inputs into shared memory and take their outputs out, double-buffered
//   across tiles (K5: the shortcut in, y over it; K7: dy and y in, dz and
//   dsc out); K7's dx and dW epilogues store from their registers, four
//   consecutive columns a lane.
// - K4 (FwdStatsEpi) and K6 (BwdStatsEpi, dy and y staged like K7's) store
//   nothing but one row of per-column partial sums a 128-row tile, through
//   one reduction (tile_col_sums): the thread's two rows, then the eight
//   lanes that share its columns by a butterfly of shuffles that leaves
//   each lane a distinct eighth of the sums (56 shuffles a thread, not
//   192), then the eight warps in order through the mainloop's scratch. A
//   second launch sums the tiles' partials per column in a fixed two-level
//   order (32 interleaved slices of rows, then the slices in turn; a
//   one-level sum, one thread a column walking all 1,568 rows in turn, took
//   0.087 ms at stage 1 against 0.006). A partial row belongs to its
//   m-tile, not to the block that took the tile, so the sums do not depend
//   on the grid or the card.
//
// The first paths, for f32 and for shapes TMA cannot read: a block of 256
// threads owns a 128 x 128 output tile and walks the reduction through
// single-buffered shared memory, two barriers a step, no asynchronous
// copies. For bf16 the products run on mma.sync m16n8k16 (mainloop_mma: 8
// warps of 64 x 32 fragments, 32 k a step, 16-byte loads where rows are
// aligned), then the fragments go through a 67.6 KB f32 shared tile into
// the thread tile the epilogues read (each thread owns an 8 x 8 block).
// For f32 the same tile runs plain f32 FMA (mainloop_fma; the tensor
// cores' f32 path, TF32, would round the inputs). These loops run at 30-70
// TFLOP/s, so they, and not the bytes, bound those passes.
//
// Determinism: no float atomics. K4 and K6 on the first mainloops reduce
// over M in a fixed order: each block walks a fixed set of m-tiles and
// adds each thread's per-column partials to its own slots in shared
// memory, the 16 row groups of a block are summed in order, and a second
// launch (sum_partials, the one the sm90 paths use) sums the blocks'
// partials in its fixed two-level order. The epilogues read their
// per-column vectors from shared memory, which keeps every pass within 128
// registers.
// K7 writes dz once (cd) and then runs two GEMMs over it: dx = dz @ W^T,
// and dW = x^T @ dz split over S fixed chunks of M whose f32 partials a
// last launch sums in order (the [K, N] f32 accumulator of the TPU kernel
// does not fit a block). Two calls give the same bits. The sm90 path keeps
// that scheme (its chunks of M are multiples of its 64-row step); no TMA
// reduce-add.
//
// Any M, K and N: ragged tiles load zeros and store nothing out of range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "sm90_gemm.cuh"

namespace {

constexpr int BM = 128;          // tile rows
constexpr int BN = 128;          // tile columns
constexpr int BK = 16;           // reduction step
constexpr int kThreads = 256;    // 16 x 16, each thread 8 x 8 outputs
constexpr int kPad = 4;          // keeps float4 alignment, spreads banks
constexpr int BKH = 32;          // bf16 reduction step (two k16 mma steps)
constexpr int kPadH = 8;         // bf16 row pad: 80-byte rows put a warp's
                                 // 8 fragment rows on distinct banks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// _round_trip: the f32 value rounded through the compute dtype
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  return to_f(from_f<T>(v));
}

// The thread (ty, tx) owns rows {h * 64 + ty * 4 + i} and columns
// {h * 64 + tx * 4 + j} of the tile, h in {0, 1}, i and j in 0..3; the
// register index is h * 4 + i (rows) and h * 4 + j (columns).
__device__ __forceinline__ int row_of(int ib, int ty) {
  return (ib >> 2) * 64 + ty * 4 + (ib & 3);
}
__device__ __forceinline__ int col_of(int jb, int tx) {
  return (jb >> 2) * 64 + tx * 4 + (jb & 3);
}

// Whether rows of ``width`` values of p may be moved 4 values (16 bytes
// f32, 8 bytes bf16) at a time: every 4-aligned column of a row is then
// aligned. Uniform over the grid, so a kernel decides it once.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int width) {
  return width % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// 4 consecutive values as f32, vectorised when all 4 are in range and the
// row is aligned (vec), else element by element; out of range reads 0.
__device__ __forceinline__ void ld4(const float* p, int nv, bool vec,
                                    float (&v)[4]) {
  if (vec && nv == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < nv ? p[j] : 0.f;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, int nv, bool vec,
                                    float (&v)[4]) {
  if (vec && nv == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < nv ? __bfloat162float(p[j]) : 0.f;
}

__device__ __forceinline__ void st4(float* p, int nv, bool vec,
                                    const float (&v)[4]) {
  if (vec && nv == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nv) p[j] = v[j];
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, int nv, bool vec,
                                    const float (&v)[4]) {
  if (vec && nv == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nv) p[j] = __float2bfloat16_rn(v[j]);
}

// The tiles in shared memory (dynamic; see smem_bytes): the f32 path's
// reduction-major f32 tiles, or the bf16 path's row-major bf16 tiles
// ([row][k], so an mma fragment's two k are one 32-bit word), or the f32
// staging tile through which the bf16 path hands its mma fragments to the
// thread-tile layout the epilogues read.
union Smem {
  struct {
    float a[BK][BM + kPad];
    float b[BK][BN + kPad];
  } f;
  struct {
    __nv_bfloat16 a[BM][BKH + kPadH];
    __nv_bfloat16 b[BN][BKH + kPadH];
  } h;
  float stage[BM][BN + kPad];
};

template <typename T>
constexpr size_t smem_bytes() {
  return std::is_same<T, float>::value ? sizeof(Smem::f) : sizeof(Smem);
}

// acc = A[i0:i0+BM, r_begin:r_end] @ B[r_begin:r_end, j0:j0+BN] in f32.
// A(i, r) is A[i * lda + r] when A_ROW, else A[r * lda + i]; B(r, j) is
// B[r * ldb + j] when B_ROW, else B[j * ldb + r]. Threads load along the
// contiguous dimension of each operand. Rows >= rows, columns >= cols and
// reduction indices >= r_end read as 0.
template <bool A_ROW, bool B_ROW>
__device__ __forceinline__ void mainloop_fma(
    const float* __restrict__ A, size_t lda, const float* __restrict__ B,
    size_t ldb, int rows, int cols, int r_begin, int r_end, int i0, int j0,
    float (&acc)[8][8], Smem& s) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int e = 0; e < (BM * BK) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int ii = A_ROW ? idx / BK : idx % BM;
      const int rr = A_ROW ? idx % BK : idx / BM;
      const int gi = i0 + ii, gr = r0 + rr;
      float v = 0.f;
      if (gi < rows && gr < r_end)
        v = A_ROW ? A[static_cast<size_t>(gi) * lda + gr]
                  : A[static_cast<size_t>(gr) * lda + gi];
      s.f.a[rr][ii] = v;
    }
#pragma unroll
    for (int e = 0; e < (BN * BK) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int jj = B_ROW ? idx % BN : idx / BK;
      const int rr = B_ROW ? idx / BN : idx % BK;
      const int gj = j0 + jj, gr = r0 + rr;
      float v = 0.f;
      if (gj < cols && gr < r_end)
        v = B_ROW ? B[static_cast<size_t>(gr) * ldb + gj]
                  : B[static_cast<size_t>(gj) * ldb + gr];
      s.f.b[rr][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < BK; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.f.a[rr][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.f.a[rr][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.f.b[rr][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.f.b[rr][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One m16n8k16 tensor-core product, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies one operand tile of `outer` x BKH bf16 values into dst[outer][k]
// (row-major in k). Element (o, r) of the operand is src[o * ld + r] when
// K_CONTIG, else src[r * ld + o]. Threads move 8 values along the
// contiguous dimension at a time, 16 bytes at once where the row is
// aligned and in range; out-of-range values read as 0.
template <bool K_CONTIG>
__device__ __forceinline__ void load_tile_h(
    const __nv_bfloat16* __restrict__ src, size_t ld, int o_lim, int r0,
    int r_end, int o0, __nv_bfloat16 (*dst)[BKH + kPadH], bool vec) {
  constexpr int kUnits = BM * BKH / 8;  // 8-value units per tile
#pragma unroll
  for (int e = 0; e < kUnits / kThreads; ++e) {
    const int u = threadIdx.x + e * kThreads;
    // K_CONTIG: unit = (row o, k r..r+7); else (k r, rows o..o+7)
    const int o = K_CONTIG ? u / (BKH / 8) : (u % (BM / 8)) * 8;
    const int r = K_CONTIG ? (u % (BKH / 8)) * 8 : u / (BM / 8);
    const int go = o0 + o, gr = r0 + r;
    const bool full = K_CONTIG ? (go < o_lim && gr + 8 <= r_end)
                               : (gr < r_end && go + 8 <= o_lim);
    const __nv_bfloat16* p =
        K_CONTIG ? src + static_cast<size_t>(go) * ld + gr
                 : src + static_cast<size_t>(gr) * ld + go;
    uint32_t w[4];  // the 8 values, two to a word, low half first
    if (vec && full) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      w[0] = raw.x; w[1] = raw.y; w[2] = raw.z; w[3] = raw.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t lo = 0, hi = 0;
        const int j = 2 * q;
        if (K_CONTIG ? (go < o_lim && gr + j < r_end)
                     : (gr < r_end && go + j < o_lim))
          lo = __bfloat16_as_ushort(p[j]);
        if (K_CONTIG ? (go < o_lim && gr + j + 1 < r_end)
                     : (gr < r_end && go + j + 1 < o_lim))
          hi = __bfloat16_as_ushort(p[j + 1]);
        w[q] = lo | (hi << 16);
      }
    }
    if (K_CONTIG) {
      *reinterpret_cast<uint4*>(&dst[o][r]) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[o + j][r] = __ushort_as_bfloat16(
            static_cast<unsigned short>(w[j >> 1] >> (16 * (j & 1))));
    }
  }
}

// The bf16 path: acc = A[i0:i0+BM, r_begin:r_end] @ B[r_begin:r_end,
// j0:j0+BN] with mma.sync (bf16 products, f32 sums), A and B addressed as
// in mainloop_fma. 8 warps as 2 x 4, each a 64 x 32 block of m16n8
// fragments; the fragments then go through shared memory into the
// thread-tile layout (rows row_of(ib, ty), columns col_of(jb, tx)).
template <bool A_ROW, bool B_ROW>
__device__ __forceinline__ void mainloop_mma(
    const __nv_bfloat16* __restrict__ A, size_t lda,
    const __nv_bfloat16* __restrict__ B, size_t ldb, int rows, int cols,
    int r_begin, int r_end, int i0, int j0, float (&acc)[8][8], Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool vec_a = lda % 8 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool vec_b = ldb % 8 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  float c[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[mi][ni][q] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BKH) {
    load_tile_h<A_ROW>(A, lda, rows, r0, r_end, i0, s.h.a, vec_a);
    load_tile_h<!B_ROW>(B, ldb, cols, r0, r_end, j0, s.h.b, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKH; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16 + g;
        af[mi][0] = ld_pair(&s.h.a[m][kk + 2 * t]);
        af[mi][1] = ld_pair(&s.h.a[m + 8][kk + 2 * t]);
        af[mi][2] = ld_pair(&s.h.a[m][kk + 2 * t + 8]);
        af[mi][3] = ld_pair(&s.h.a[m + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bf[ni][0] = ld_pair(&s.h.b[n][kk + 2 * t]);
        bf[ni][1] = ld_pair(&s.h.b[n][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(c[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int m = wm * 64 + mi * 16 + g;
      const int n = wn * 32 + ni * 8 + 2 * t;
      s.stage[m][n] = c[mi][ni][0];
      s.stage[m][n + 1] = c[mi][ni][1];
      s.stage[m + 8][n] = c[mi][ni][2];
      s.stage[m + 8][n + 1] = c[mi][ni][3];
    }
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int ib = 0; ib < 8; ++ib)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
      acc[ib][jb] = s.stage[row_of(ib, ty)][col_of(jb, tx)];
  __syncthreads();
}

// acc = A-tile @ B-tile in f32: plain FMA for f32 operands, tensor-core
// mma.sync for bf16 ones (bf16 products are exact in f32 either way).
template <typename T, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void mainloop(const T* __restrict__ A, size_t lda,
                                         const T* __restrict__ B, size_t ldb,
                                         int rows, int cols, int r_begin,
                                         int r_end, int i0, int j0,
                                         float (&acc)[8][8], Smem& s) {
  if constexpr (std::is_same<T, float>::value)
    mainloop_fma<A_ROW, B_ROW>(A, lda, B, ldb, rows, cols, r_begin, r_end,
                               i0, j0, acc, s);
  else
    mainloop_mma<A_ROW, B_ROW>(A, lda, B, ldb, rows, cols, r_begin, r_end,
                               i0, j0, acc, s);
}

// Per-column vectors ([N] f32) of the block's columns, staged in shared
// memory so the epilogues do not hold them in registers: cv[k][c] =
// v_k[j0 + c], 0 past N. Visible after the mainloop's first barrier.
template <int NV>
__device__ __forceinline__ void stage_cols(const float* const (&v)[NV],
                                           float (*cv)[BN], int j0, int N) {
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    const int col = j0 + c;
#pragma unroll
    for (int k = 0; k < NV; ++k) cv[k][c] = col < N ? v[k][col] : 0.f;
  }
}

// Column sums for K4 and K6: red[k][ty][c] holds the partial of row group
// ty (16 of them) for column c; each thread owns its (ty, c) entries, so
// it adds to them without races. block_col_sums adds the 16 groups in
// order and writes the block's row of partials, part[k][r][j0 + c].
__device__ __forceinline__ void zero_red(float (*red)[16][BN]) {
  float* r = &red[0][0][0];
  for (int i = threadIdx.x; i < 2 * 16 * BN; i += kThreads) r[i] = 0.f;
}

__device__ __forceinline__ void block_col_sums(float (*red)[16][BN],
                                               float* part, size_t R,
                                               int j0, int N) {
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BN && j0 + c < N) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float t = 0.f;
      for (int g = 0; g < 16; ++g) t += red[k][g][c];
      part[(k * R + blockIdx.y) * static_cast<size_t>(N) + j0 + c] = t;
    }
  }
}

// ----------------------------------------------------------------- K4
// grid (n-tiles, R): block (n, r) walks m-tiles r, r + R, ... and writes
// its partial sums to part[0][r][*] (s1) and part[1][r][*] (s2).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ shift, float* __restrict__ part,
                 int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float cv[1][BN];
  __shared__ float red[2][16][BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * BN;
  const float* const vs[1] = {shift};
  stage_cols<1>(vs, cv, j0, N);
  zero_red(red);
  const int mt = (M + BM - 1) / BM;
  float acc[8][8];
  for (int t = blockIdx.y; t < mt; t += gridDim.y) {
    const int i0 = t * BM;
    mainloop<T, true, true>(x, K, w, N, M, N, 0, K, i0, j0, acc, s);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int c = col_of(jb, tx);
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int ib = 0; ib < 8; ++ib) {
        if (i0 + row_of(ib, ty) >= M) continue;
        const float zs = round_cd<T>(acc[ib][jb]) - cv[0][c];
        t1 += zs;
        t2 += zs * zs;
      }
      red[0][ty][c] += t1;
      red[1][ty][c] += t2;
    }
  }
  block_col_sums(red, part, gridDim.y, j0, N);
}

// out[k][n] = sum_{r < R} part[k][r][n] for k in {0, 1}, in a fixed
// two-level order: slice y of 32 sums rows y, y + 32, ... in turn, then the
// 32 slices are added in turn. A block is 32 columns x 32 slices. K4 and K6
// (either path) sum their partial rows with it.
__global__ void __launch_bounds__(1024)
    sum_partials(const float* __restrict__ part, float* __restrict__ out,
                 int R, int N) {
  __shared__ float red[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x, k = blockIdx.y;
  float acc = 0.f;
  if (n < N) {
    const float* p = part + static_cast<size_t>(k) * R * N + n;
#pragma unroll 8
    for (int r = threadIdx.y; r < R; r += 32)
      acc += p[static_cast<size_t>(r) * N];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float sum = 0.f;
#pragma unroll 8
    for (int y = 0; y < 32; ++y) sum += red[y][threadIdx.x];
    out[static_cast<size_t>(k) * N + n] = sum;
  }
}

cudaError_t launch_sum_partials(const float* part, float* out, int R, int N,
                                cudaStream_t st) {
  sum_partials<<<dim3((N + 31) / 32, 2), dim3(32, 32), 0, st>>>(part, out, R,
                                                               N);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- K5
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ sh, const T* __restrict__ sc,
                 T* __restrict__ y, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float cv[2][BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const bool vec = vec_ok(sc, N) && vec_ok(y, N);
  const float* const vs[2] = {scale, sh};
  stage_cols<2>(vs, cv, j0, N);
  float acc[8][8];
  mainloop<T, true, true>(x, K, w, N, M, N, 0, K, i0, j0, acc, s);
#pragma unroll
  for (int ib = 0; ib < 8; ++ib) {
    const int row = i0 + row_of(ib, ty);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = h * 64 + tx * 4;
      if (j0 + c0 >= N) continue;
      const int nv = min(4, N - j0 - c0);
      const size_t off = static_cast<size_t>(row) * N + j0 + c0;
      float v[4];
      ld4(sc + off, nv, vec, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float o = round_cd<T>(acc[ib][h * 4 + j]) * cv[0][c0 + j] +
                  cv[1][c0 + j] + v[j];
        if (RELU) o = fmaxf(o, 0.f);
        v[j] = o;
      }
      st4(y + off, nv, vec, v);
    }
  }
}

// ----------------------------------------------------------------- K6
// Same reduction scheme as K4: part[0][r][*] = a, part[1][r][*] = b.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const T* __restrict__ dy, const T* __restrict__ y,
                     float* __restrict__ part, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float cv[2][BN];
  __shared__ float red[2][16][BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * BN;
  const bool vec = vec_ok(dy, N) && vec_ok(y, N);
  const float* const vs[2] = {mean, inv};
  stage_cols<2>(vs, cv, j0, N);
  zero_red(red);
  const int mt = (M + BM - 1) / BM;
  float acc[8][8];
  for (int t = blockIdx.y; t < mt; t += gridDim.y) {
    const int i0 = t * BM;
    mainloop<T, true, true>(x, K, w, N, M, N, 0, K, i0, j0, acc, s);
#pragma unroll
    for (int ib = 0; ib < 8; ++ib) {
      const int row = i0 + row_of(ib, ty);
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = h * 64 + tx * 4;
        if (j0 + c0 >= N) continue;
        const int nv = min(4, N - j0 - c0);
        const size_t off = static_cast<size_t>(row) * N + j0 + c0;
        float g[4], yv[4];
        ld4(dy + off, nv, vec, g);
        ld4(y + off, nv, vec, yv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float xhat =
              (round_cd<T>(acc[ib][h * 4 + j]) - cv[0][c]) * cv[1][c];
          const float gj = (RELU && !(yv[j] > 0.f)) ? 0.f : g[j];
          red[0][ty][c] += gj;
          red[1][ty][c] += gj * xhat;
        }
      }
    }
  }
  block_col_sums(red, part, gridDim.y, j0, N);
}

// ----------------------------------------------------------------- K7
// Pass 1: dz = round_cd(scale * (g - ca - xhat * cb)) and dsc = g, both
// stored in cd.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
    dz_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ scale, const float* __restrict__ cav,
              const float* __restrict__ cbv, const T* __restrict__ dy,
              const T* __restrict__ y, T* __restrict__ dz,
              T* __restrict__ dsc, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float cv[5][BN];  // mean, inv, scale, ca, cb
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const bool vec = vec_ok(dy, N) && vec_ok(y, N) && vec_ok(dz, N) &&
                   vec_ok(dsc, N);
  const float* const vs[5] = {mean, inv, scale, cav, cbv};
  stage_cols<5>(vs, cv, j0, N);
  float acc[8][8];
  mainloop<T, true, true>(x, K, w, N, M, N, 0, K, i0, j0, acc, s);
#pragma unroll
  for (int ib = 0; ib < 8; ++ib) {
    const int row = i0 + row_of(ib, ty);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = h * 64 + tx * 4;
      if (j0 + c0 >= N) continue;
      const int nv = min(4, N - j0 - c0);
      const size_t off = static_cast<size_t>(row) * N + j0 + c0;
      float g[4], yv[4], d[4];
      ld4(dy + off, nv, vec, g);
      ld4(y + off, nv, vec, yv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        const float xhat =
            (round_cd<T>(acc[ib][h * 4 + j]) - cv[0][c]) * cv[1][c];
        if (RELU && !(yv[j] > 0.f)) g[j] = 0.f;
        d[j] = cv[2][c] * ((g[j] - cv[3][c]) - xhat * cv[4][c]);
      }
      st4(dz + off, nv, vec, d);
      st4(dsc + off, nv, vec, g);
    }
  }
}

// Passes 2 and 3: out[z][i][j] = sum_{r in chunk z} A(i, r) B(r, j), with
// chunk z = [z * chunk, min((z + 1) * chunk, R)); stored as OutT.
template <typename T, bool A_ROW, bool B_ROW, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B,
                int ldb, OutT* __restrict__ out, int rows, int cols, int R,
                int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(R, r_begin + chunk);
  float acc[8][8];
  mainloop<T, A_ROW, B_ROW>(A, lda, B, ldb, rows, cols, r_begin, r_end, i0,
                            j0, acc, s);
  OutT* o = out + static_cast<size_t>(blockIdx.z) * rows * cols;
  const bool vec = vec_ok(o, cols);
#pragma unroll
  for (int ib = 0; ib < 8; ++ib) {
    const int row = i0 + row_of(ib, ty);
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = j0 + h * 64 + tx * 4;
      if (c0 >= cols) continue;
      const int nv = min(4, cols - c0);
      const float v[4] = {acc[ib][h * 4], acc[ib][h * 4 + 1],
                          acc[ib][h * 4 + 2], acc[ib][h * 4 + 3]};
      st4(o + static_cast<size_t>(row) * cols + c0, nv, vec, v);
    }
  }
}

// out[e] = sum_{s < S} part[s][e], s in order.
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, int S, size_t n) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += part[static_cast<size_t>(s) * n + e];
  out[e] = t;
}

inline dim3 tiles(int rows, int cols, int z = 1) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM, z);
}

// Opts a kernel into the dynamic shared memory its tiles take (the bf16
// path's staging tile is over the 48 KB default).
template <typename T, typename Kern>
cudaError_t allow_smem(Kern kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<T>()));
}

template <typename T>
cudaError_t stats(const void* x, const void* w, const float* shift,
                  float* part, float* out, int M, int K, int N, int R,
                  cudaStream_t st) {
  auto kern = stats_kernel<T>;
  cudaError_t e = allow_smem<T>(kern);
  if (e != cudaSuccess) return e;
  kern<<<dim3((N + BN - 1) / BN, R), kThreads, smem_bytes<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), shift, part, M, K,
      N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum_partials(part, out, R, N, st);
}

template <typename T, bool RELU>
cudaError_t apply(const void* x, const void* w, const float* scale,
                  const float* sh, const void* sc, void* y, int M, int K,
                  int N, cudaStream_t st) {
  auto kern = apply_kernel<T, RELU>;
  cudaError_t e = allow_smem<T>(kern);
  if (e != cudaSuccess) return e;
  kern<<<tiles(M, N), kThreads, smem_bytes<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, sh,
      static_cast<const T*>(sc), static_cast<T*>(y), M, K, N);
  return cudaGetLastError();
}

template <typename T, bool RELU>
cudaError_t bwd_stats(const void* x, const void* w, const float* mean,
                      const float* inv, const void* dy, const void* y,
                      float* part, float* out, int M, int K, int N, int R,
                      cudaStream_t st) {
  auto kern = bwd_stats_kernel<T, RELU>;
  cudaError_t e = allow_smem<T>(kern);
  if (e != cudaSuccess) return e;
  kern<<<dim3((N + BN - 1) / BN, R), kThreads, smem_bytes<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mean, inv,
      static_cast<const T*>(dy), static_cast<const T*>(y), part, M, K, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum_partials(part, out, R, N, st);
}

template <typename T, bool RELU>
cudaError_t bwd_apply(const void* x, const void* w, const float* mean,
                      const float* inv, const float* scale, const float* ca,
                      const float* cb, const void* dy, const void* y,
                      void* dz, void* dsc, void* dx, float* dw_part,
                      float* dw, int M, int K, int N, int S, int chunk,
                      cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* dzt = static_cast<T*>(dz);
  auto kdz = dz_kernel<T, RELU>;
  auto kdx = gemm_kernel<T, true, false, T>;
  auto kdw = gemm_kernel<T, false, true, float>;
  cudaError_t e = allow_smem<T>(kdz);
  if (e == cudaSuccess) e = allow_smem<T>(kdx);
  if (e == cudaSuccess) e = allow_smem<T>(kdw);
  if (e != cudaSuccess) return e;
  kdz<<<tiles(M, N), kThreads, smem_bytes<T>(), st>>>(
      xt, wt, mean, inv, scale, ca, cb, static_cast<const T*>(dy),
      static_cast<const T*>(y), dzt, static_cast<T*>(dsc), M, K, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // dx [M, K] = dz [M, N] @ W^T, W^T(n, k) = W[k * N + n]
  kdx<<<tiles(M, K), kThreads, smem_bytes<T>(), st>>>(
      dzt, N, wt, N, static_cast<T*>(dx), M, K, N, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // dW [K, N] = x^T @ dz, x^T(k, m) = x[m * K + k], over S chunks of M
  float* target = S == 1 ? dw : dw_part;
  kdw<<<tiles(K, N, S), kThreads, smem_bytes<T>(), st>>>(
      xt, K, dzt, N, target, K, N, M, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  const size_t n = static_cast<size_t>(K) * N;
  sum_splits<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      dw_part, dw, S, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------- K7 on sm90
// The epilogues of K7's three GEMMs on the sm90 mainloop. Each works from
// the accumulator fragment, four consecutive columns a lane
// (sm90::Frag::quad), and moves them at once (8 bytes of bf16, 16 of f32):
// every row holds a multiple of 8 values and every base is 16-byte aligned
// (the path's condition), so four columns never straddle the edge or a
// misaligned word.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack_bf4(const uint2 raw, float (&v)[4]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ uint2 pack_bf4(const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  return raw;
}
__device__ __forceinline__ void st_bf4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = pack_bf4(v);
}

// Pass 1: z = x W (x K-major, W MN-major); dz = round_cd(scale * ((g - ca)
// - xhat * cb)) and dsc = g, the f32 operations of dz_kernel in its order.
// The tile's dy and y come in, and its dz and dsc go out, by TMA through
// 64 KB of shared memory (the mainloop's staged epilogue): dz over dy, dsc
// over y, each lane on its own four columns. TMA reads zeros outside the
// matrix and writes nothing there, so the epilogue needs no edge checks.
template <bool RELU>
struct DzEpi {
  static constexpr uint32_t kStagedBytes = 2 * 128 * 128 * 2;  // dy, y
  CUtensorMap mdy, my, mdz, mdsc;
  const float *mean, *inv, *scale, *ca, *cb;
  int N;

  __device__ __forceinline__ void load_staged(unsigned char* st,
                                              uint64_t* bar, int i0,
                                              int j0) const {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = i0 + 64 * (b >> 1), c = j0 + 64 * (b & 1);
      sm90::tma_load(st + b * sm90::kBoxBytes, &mdy, bar, c, r);
      sm90::tma_load(st + (4 + b) * sm90::kBoxBytes, &my, bar, c, r);
    }
  }

  __device__ __forceinline__ void store_staged(const unsigned char* st,
                                               int i0, int j0) const {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = i0 + 64 * (b >> 1), c = j0 + 64 * (b & 1);
      sm90::tma_store(&mdz, st + b * sm90::kBoxBytes, c, r);
      sm90::tma_store(&mdsc, st + (4 + b) * sm90::kBoxBytes, c, r);
    }
  }

  __device__ __forceinline__ void stage(float (*cv)[sm90::BN], int j0) const {
    const float* const v[5] = {mean, inv, scale, ca, cb};
    for (int c = threadIdx.x; c < sm90::BN; c += sm90::kConsumers) {
      const int col = j0 + c;
#pragma unroll
      for (int k = 0; k < 5; ++k) cv[k][c] = col < N ? v[k][col] : 0.f;
    }
  }

  __device__ __forceinline__ void store(const float (&acc)[64],
                                        const float (*cv)[sm90::BN],
                                        unsigned char* st, float*, int, int,
                                        int, int wg) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sm90::Frag::row(wg, h);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float zv[4];
        sm90::Frag::quad(acc, h, m, zv);
        const int c = sm90::Frag::col4(m);
        uint2* pg = reinterpret_cast<uint2*>(st + sm90::staged_off(r, c));
        uint2* py = reinterpret_cast<uint2*>(st + 4 * sm90::kBoxBytes +
                                             sm90::staged_off(r, c));
        float g[4], yv[4], d[4];
        unpack_bf4(*pg, g);
        unpack_bf4(*py, yv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xhat =
              (round_cd<bf16>(zv[e]) - cv[0][c + e]) * cv[1][c + e];
          if (RELU && !(yv[e] > 0.f)) g[e] = 0.f;
          d[e] = cv[2][c + e] * ((g[e] - cv[3][c + e]) - xhat * cv[4][c + e]);
        }
        *pg = pack_bf4(d);
        *py = pack_bf4(g);
      }
    }
  }
};

// Pass 2: dx = dz W^T (both K-major), stored in bf16.
struct DxEpi {
  bf16* dx;
  int M, K;
  static constexpr uint32_t kStagedBytes = 0;

  __device__ __forceinline__ void stage(float (*)[sm90::BN], int) const {}

  __device__ __forceinline__ void store(const float (&acc)[64],
                                        const float (*)[sm90::BN],
                                        unsigned char*, float*, int i0,
                                        int j0, int, int wg) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + sm90::Frag::row(wg, h);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float v[4];
        sm90::Frag::quad(acc, h, m, v);
        const int c = j0 + sm90::Frag::col4(m);
        if (row < M && c < K) st_bf4(dx + static_cast<size_t>(row) * K + c, v);
      }
    }
  }
};

// Pass 3: the f32 partial of split z of dW = x^T dz (both MN-major),
// out[z][k][n].
struct DwEpi {
  float* out;
  int K, N;
  static constexpr uint32_t kStagedBytes = 0;

  __device__ __forceinline__ void stage(float (*)[sm90::BN], int) const {}

  __device__ __forceinline__ void store(const float (&acc)[64],
                                        const float (*)[sm90::BN],
                                        unsigned char*, float*, int i0,
                                        int j0, int z, int wg) const {
    float* o = out + static_cast<size_t>(z) * K * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + sm90::Frag::row(wg, h);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float v[4];
        sm90::Frag::quad(acc, h, m, v);
        const int c = j0 + sm90::Frag::col4(m);
        if (row < K && c < N)
          *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * N + c) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
};

// ------------------------------------------------- K4 and K6 on sm90
// The column sums of one 128 x 128 tile, for K4's and K6's epilogues:
// term(h, j, p, q) gives the thread's two terms of each kind (p, q) in
// row Frag::row(wg, h), columns 8 j + 2 t and 8 j + 2 t + 1 (t = lane % 4,
// the columns of acc[4 j + 2 h] and acc[4 j + 2 h + 1]); the tile's sums
// of p and of q over its 128 rows go to part[0][i0 / 128][j0 + c] and
// part[1][...], in a fixed order: the thread's two rows, the eight lanes
// that share its columns by a butterfly of shuffles, then the eight warps
// in order through red, the mainloop's scratch (16 x 128 f32).
__device__ __forceinline__ int sum_col(int c, int t) {  // v[c]'s column
  return 8 * (c >> 1) + 2 * t + (c & 1);
}

template <typename Term>
__device__ __forceinline__ void tile_col_sums(const Term& term, float* red,
                                              float* part, int R, int N,
                                              int i0, int j0) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  // v[c] = the thread's sum of p over its two rows in column sum_col(c),
  // v[32 + c] that of q (j outer, so that each sum of acc dies as its
  // two terms are taken)
  float v[64];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2], q[2];
      term(h, j, p, q);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * j + e;
        if (h == 0) {
          v[c] = p[e];
          v[32 + c] = q[e];
        } else {
          v[c] += p[e];
          v[32 + c] += q[e];
        }
      }
    }
  }
  // The eight lanes with the same t (lane bits 2-4) hold the same
  // columns. Each round pairs lanes across one bit: a lane keeps the
  // half of its sums named by that bit, adds its partner's copy of that
  // half, and hands over the other. After three rounds lane
  // (b4, b3, b2, t) holds, in v[i] (i < 8), the warp's sum of index
  // 32 b4 + 16 b3 + 8 b2 + i.
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float send = b4 ? v[i] : v[32 + i];
    const float keep = b4 ? v[32 + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float send = b3 ? v[i] : v[16 + i];
    const float keep = b3 ? v[16 + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = b2 ? v[i] : v[8 + i];
    const float keep = b2 ? v[8 + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  // the eight warps in order: red[2 w + k][c]. The mainloop's barrier at
  // the start of the tile keeps the last tile's readers off red.
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    red[(2 * w + b4) * sm90::BN + sum_col(16 * b3 + 8 * b2 + i, t)] = v[i];
  sm90::consumer_sync();
  const int k = threadIdx.x >> 7, c = threadIdx.x & 127;
  if (j0 + c < N) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < sm90::kConsumers / 32; ++q)
      sum += red[(2 * q + k) * sm90::BN + c];
    part[(static_cast<size_t>(k) * R + i0 / sm90::BM) * N + j0 + c] = sum;
  }
}

// K4: z = x W (x K-major, W MN-major) as in K7's dz pass; for every
// element zs = round_cd(z) - shift, and the tile's sums of zs and zs * zs
// (stats_kernel's f32 operations) over its rows below M. Rows past M read
// x = 0 (TMA's zeros) but would add -shift, so they are left out.
struct FwdStatsEpi {
  static constexpr uint32_t kStagedBytes = 0;
  const float* shift;
  float* part;  // [2][R][N], R = ceil(M / 128)
  int M, N, R;

  __device__ __forceinline__ void stage(float (*cv)[sm90::BN], int j0) const {
    for (int c = threadIdx.x; c < sm90::BN; c += sm90::kConsumers)
      cv[0][c] = j0 + c < N ? shift[j0 + c] : 0.f;
  }

  __device__ __forceinline__ void store(const float (&acc)[64],
                                        const float (*cv)[sm90::BN],
                                        unsigned char*, float* red, int i0,
                                        int j0, int, int wg) const {
    const int t = threadIdx.x & 3;
    tile_col_sums(
        [&](int h, int j, float (&p)[2], float (&q)[2]) {
          const int r = sm90::Frag::row(wg, h);
          const bool in = i0 + r < M;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zs = round_cd<bf16>(acc[4 * j + 2 * h + e]) -
                             cv[0][8 * j + 2 * t + e];
            p[e] = in ? zs : 0.f;
            q[e] = in ? zs * zs : 0.f;
          }
        },
        red, part, R, N, i0, j0);
  }
};

// K6: z = x W as for K4; for every element g = RELU && !(y > 0) ? 0 : dy
// and xhat = (round_cd(z) - mean) * inv, in bwd_stats_kernel's f32 order,
// and the tile's sums of g and g * xhat. Rows past M read dy = 0 (TMA's
// zeros), so they add nothing. dy and y come in by TMA as in DzEpi;
// nothing goes out that way, so store_staged is empty.
template <bool RELU>
struct BwdStatsEpi {
  static constexpr uint32_t kStagedBytes = 2 * 128 * 128 * 2;  // dy, y
  CUtensorMap mdy, my;
  const float *mean, *inv;
  float* part;  // [2][R][N], R = ceil(M / 128)
  int N, R;

  __device__ __forceinline__ void load_staged(unsigned char* st,
                                              uint64_t* bar, int i0,
                                              int j0) const {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = i0 + 64 * (b >> 1), c = j0 + 64 * (b & 1);
      sm90::tma_load(st + b * sm90::kBoxBytes, &mdy, bar, c, r);
      sm90::tma_load(st + (4 + b) * sm90::kBoxBytes, &my, bar, c, r);
    }
  }

  __device__ __forceinline__ void store_staged(const unsigned char*, int,
                                               int) const {}

  __device__ __forceinline__ void stage(float (*cv)[sm90::BN], int j0) const {
    for (int c = threadIdx.x; c < sm90::BN; c += sm90::kConsumers) {
      const int col = j0 + c;
      cv[0][c] = col < N ? mean[col] : 0.f;
      cv[1][c] = col < N ? inv[col] : 0.f;
    }
  }

  __device__ __forceinline__ void store(const float (&acc)[64],
                                        const float (*cv)[sm90::BN],
                                        unsigned char* st, float* red, int i0,
                                        int j0, int, int wg) const {
    const int t = threadIdx.x & 3;
    tile_col_sums(
        [&](int h, int j, float (&p)[2], float (&q)[2]) {
          // dy and y two columns at a time
          const uint32_t off =
              sm90::staged_off(sm90::Frag::row(wg, h), 8 * j + 2 * t);
          const float2 dy2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(st + off));
          const float2 y2 = __bfloat1622float2(*reinterpret_cast<
              const __nv_bfloat162*>(st + 4 * sm90::kBoxBytes + off));
          const float dyv[2] = {dy2.x, dy2.y}, yv[2] = {y2.x, y2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            const float xhat =
                (round_cd<bf16>(acc[4 * j + 2 * h + e]) - cv[0][col]) *
                cv[1][col];
            const float gj = (RELU && !(yv[e] > 0.f)) ? 0.f : dyv[e];
            p[e] = gj;
            q[e] = gj * xhat;
          }
        },
        red, part, R, N, i0, j0);
  }
};

// ---------------------------------------------------------- K5 on sm90
// z = x W as for K4; y = relu?(round_cd(z) * scale + sh + shortcut), the
// f32 operations of apply_kernel in its order. The tile's shortcut comes
// in by TMA (four 64 x 64 boxes, 32 KB; the mainloop's staged epilogue),
// each lane turns its four columns of it into y in place, and TMA writes
// y out: zeros come in outside the matrix and nothing goes out there, so
// the epilogue needs no edge checks.
template <bool RELU>
struct ApplyEpi {
  static constexpr uint32_t kStagedBytes = 128 * 128 * 2;  // sc, then y
  CUtensorMap msc, my;
  const float *scale, *sh;
  int N;

  __device__ __forceinline__ void load_staged(unsigned char* st,
                                              uint64_t* bar, int i0,
                                              int j0) const {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      sm90::tma_load(st + b * sm90::kBoxBytes, &msc, bar, j0 + 64 * (b & 1),
                     i0 + 64 * (b >> 1));
  }

  __device__ __forceinline__ void store_staged(const unsigned char* st,
                                               int i0, int j0) const {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      sm90::tma_store(&my, st + b * sm90::kBoxBytes, j0 + 64 * (b & 1),
                      i0 + 64 * (b >> 1));
  }

  __device__ __forceinline__ void stage(float (*cv)[sm90::BN], int j0) const {
    for (int c = threadIdx.x; c < sm90::BN; c += sm90::kConsumers) {
      const int col = j0 + c;
      cv[0][c] = col < N ? scale[col] : 0.f;
      cv[1][c] = col < N ? sh[col] : 0.f;
    }
  }

  __device__ __forceinline__ void store(const float (&acc)[64],
                                        const float (*cv)[sm90::BN],
                                        unsigned char* st, float*, int, int,
                                        int, int wg) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sm90::Frag::row(wg, h);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float zv[4];
        sm90::Frag::quad(acc, h, m, zv);
        const int c = sm90::Frag::col4(m);
        uint2* ps = reinterpret_cast<uint2*>(st + sm90::staged_off(r, c));
        float v[4];
        unpack_bf4(*ps, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float o =
              round_cd<bf16>(zv[e]) * cv[0][c + e] + cv[1][c + e] + v[e];
          if (RELU) o = fmaxf(o, 0.f);
          v[e] = o;
        }
        *ps = pack_bf4(v);
      }
    }
  }
};

cudaError_t stats_sm90(const void* x, const void* w, const float* shift,
                       float* part, float* out, int M, int K, int N, int R,
                       cudaStream_t st) {
  CUtensorMap mx, mw;
  cudaError_t e = sm90::make_map(&mx, x, M, K);
  if (e == cudaSuccess) e = sm90::make_map(&mw, w, K, N);
  if (e != cudaSuccess) return e;
  // z [M, N] = x W: A(m, k) = x[m][k] K-major, B(k, n) = W[k][n] MN-major
  e = sm90::launch<true, false>(mx, mw, M, N, K, K, 1,
                                FwdStatsEpi{shift, part, M, N, R}, st);
  if (e != cudaSuccess) return e;
  return launch_sum_partials(part, out, R, N, st);
}

template <bool RELU>
cudaError_t apply_sm90(const void* x, const void* w, const float* scale,
                       const float* sh, const void* sc, void* y, int M, int K,
                       int N, cudaStream_t st) {
  CUtensorMap mx, mw;
  ApplyEpi<RELU> epi;
  cudaError_t e = sm90::make_map(&mx, x, M, K);
  if (e == cudaSuccess) e = sm90::make_map(&mw, w, K, N);
  if (e == cudaSuccess) e = sm90::make_map(&epi.msc, sc, M, N);
  if (e == cudaSuccess) e = sm90::make_map(&epi.my, y, M, N);
  if (e != cudaSuccess) return e;
  epi.scale = scale;
  epi.sh = sh;
  epi.N = N;
  return sm90::launch<true, false>(mx, mw, M, N, K, K, 1, epi, st);
}

template <bool RELU>
cudaError_t bwd_stats_sm90(const void* x, const void* w, const float* mean,
                           const float* inv, const void* dy, const void* y,
                           float* part, float* out, int M, int K, int N,
                           int R, cudaStream_t st) {
  CUtensorMap mx, mw;
  BwdStatsEpi<RELU> epi;
  cudaError_t e = sm90::make_map(&mx, x, M, K);
  if (e == cudaSuccess) e = sm90::make_map(&mw, w, K, N);
  if (e == cudaSuccess) e = sm90::make_map(&epi.mdy, dy, M, N);
  if (e == cudaSuccess) e = sm90::make_map(&epi.my, y, M, N);
  if (e != cudaSuccess) return e;
  epi.mean = mean;
  epi.inv = inv;
  epi.part = part;
  epi.N = N;
  epi.R = R;
  // z [M, N] = x W: A(m, k) = x[m][k] K-major, B(k, n) = W[k][n] MN-major
  e = sm90::launch<true, false>(mx, mw, M, N, K, K, 1, epi, st);
  if (e != cudaSuccess) return e;
  return launch_sum_partials(part, out, R, N, st);
}

template <bool RELU>
cudaError_t bwd_apply_sm90(const void* x, const void* w, const float* mean,
                           const float* inv, const float* scale,
                           const float* ca, const float* cb, const void* dy,
                           const void* y, void* dz, void* dsc, void* dx,
                           float* dw_part, float* dw, int M, int K, int N,
                           int S, int chunk, cudaStream_t st) {
  // one map a matrix, each read K-major or MN-major as the pass needs:
  // x [M][K], W [K][N], dz [M][N]
  CUtensorMap mx, mw, mdz;
  DzEpi<RELU> edz;
  cudaError_t e = sm90::make_map(&mx, x, M, K);
  if (e == cudaSuccess) e = sm90::make_map(&mw, w, K, N);
  if (e == cudaSuccess) e = sm90::make_map(&mdz, dz, M, N);
  // the dz pass's epilogue: dy and y in, dz and dsc out, [M][N] each
  if (e == cudaSuccess) e = sm90::make_map(&edz.mdy, dy, M, N);
  if (e == cudaSuccess) e = sm90::make_map(&edz.my, y, M, N);
  if (e == cudaSuccess) e = sm90::make_map(&edz.mdsc, dsc, M, N);
  if (e != cudaSuccess) return e;
  edz.mdz = mdz;
  edz.mean = mean;
  edz.inv = inv;
  edz.scale = scale;
  edz.ca = ca;
  edz.cb = cb;
  edz.N = N;
  // z [M, N] = x W: A(m, k) = x[m][k] K-major, B(k, n) = W[k][n] MN-major
  e = sm90::launch<true, false>(mx, mw, M, N, K, K, 1, edz, st);
  if (e != cudaSuccess) return e;
  // dx [M, K] = dz W^T: A(m, n) = dz[m][n], B(n, k) = W[k][n], both K-major
  e = sm90::launch<true, true>(mdz, mw, M, K, N, N, 1,
                               DxEpi{static_cast<bf16*>(dx), M, K}, st);
  if (e != cudaSuccess) return e;
  // dW [K, N] = x^T dz over S chunks of M: A(k, m) = x[m][k], B(m, n) =
  // dz[m][n], both MN-major
  float* target = S == 1 ? dw : dw_part;
  e = sm90::launch<false, false>(mx, mdz, K, N, M, chunk, S,
                                 DwEpi{target, K, N}, st);
  if (e != cudaSuccess || S == 1) return e;
  const size_t n = static_cast<size_t>(K) * N;
  sum_splits<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      dw_part, dw, S, n);
  return cudaGetLastError();
}

// The sm90 paths take only what TMA reads: K and N multiples of 8 (rows of
// 16 bytes) and every array 16-byte aligned.
bool tma_reads(int K, int N, std::initializer_list<const void*> ps) {
  bool ok = K % 8 == 0 && N % 8 == 0;
  for (const void* p : ps)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return ok;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, W, shortcut, dy, y, dz, dsc, dx);
// every [N] vector and the partial buffers are f32. All arrays are
// contiguous, row-major; a kernel moves rows 4 values at a time where
// their width and base pointer allow it (vec_ok). Each returns a
// cudaError_t (0 on success).

// K4: part is [2, R, N] scratch, out [2, N] = (s1, s2). Two launches,
// as for K6: the tiles' pass and the sum of their partials.
int dl4j_fused_stats(int dtype, const void* x, const void* w,
                     const float* shift, float* part, float* out, int M,
                     int K, int N, int R, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || R < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return stats<float>(x, w, shift, part, out, M, K, N, R, st);
  if (dtype == 1)
    return stats<__nv_bfloat16>(x, w, shift, part, out, M, K, N, R, st);
  return cudaErrorInvalidValue;
}

// K5: y [M, N] = relu?(z * scale + sh + sc).
int dl4j_fused_apply(int dtype, const void* x, const void* w,
                     const float* scale, const float* sh, const void* sc,
                     void* y, int M, int K, int N, int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return relu ? apply<float, true>(x, w, scale, sh, sc, y, M, K, N, st)
                : apply<float, false>(x, w, scale, sh, sc, y, M, K, N, st);
  if (dtype == 1)
    return relu ? apply<__nv_bfloat16, true>(x, w, scale, sh, sc, y, M, K, N,
                                             st)
                : apply<__nv_bfloat16, false>(x, w, scale, sh, sc, y, M, K,
                                              N, st);
  return cudaErrorInvalidValue;
}

// K4, bf16, on the sm90 mainloop: the arguments and outputs of
// dl4j_fused_stats, but part is [2, R, N] with R = ceil(M / 128), one row
// of partials a 128-row tile. Two launches.
int dl4j_fused_stats_sm90(const void* x, const void* w, const float* shift,
                          float* part, float* out, int M, int K, int N,
                          int R, void* stream) {
  if (M < 1 || K < 1 || N < 1 || !tma_reads(K, N, {x, w}) ||
      R != (M + sm90::BM - 1) / sm90::BM)
    return cudaErrorInvalidValue;
  return stats_sm90(x, w, shift, part, out, M, K, N, R,
                    static_cast<cudaStream_t>(stream));
}

// K5, bf16, on the sm90 mainloop: the arguments and outputs of
// dl4j_fused_apply. One launch.
int dl4j_fused_apply_sm90(const void* x, const void* w, const float* scale,
                          const float* sh, const void* sc, void* y, int M,
                          int K, int N, int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || !tma_reads(K, N, {x, w, sc, y}))
    return cudaErrorInvalidValue;
  return relu ? apply_sm90<true>(x, w, scale, sh, sc, y, M, K, N, st)
              : apply_sm90<false>(x, w, scale, sh, sc, y, M, K, N, st);
}

// K6: part is [2, R, N] scratch, out [2, N] = (a, b).
int dl4j_fused_bwd_stats(int dtype, const void* x, const void* w,
                         const float* mean, const float* inv, const void* dy,
                         const void* y, float* part, float* out, int M,
                         int K, int N, int R, int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || R < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return relu ? bwd_stats<float, true>(x, w, mean, inv, dy, y, part, out, M,
                                         K, N, R, st)
                : bwd_stats<float, false>(x, w, mean, inv, dy, y, part, out,
                                          M, K, N, R, st);
  if (dtype == 1)
    return relu ? bwd_stats<__nv_bfloat16, true>(x, w, mean, inv, dy, y,
                                                 part, out, M, K, N, R, st)
                : bwd_stats<__nv_bfloat16, false>(x, w, mean, inv, dy, y,
                                                  part, out, M, K, N, R, st);
  return cudaErrorInvalidValue;
}

// K6, bf16, on the sm90 mainloop: the arguments and outputs of
// dl4j_fused_bwd_stats, with part as for dl4j_fused_stats_sm90. Two
// launches.
int dl4j_fused_bwd_stats_sm90(const void* x, const void* w,
                              const float* mean, const float* inv,
                              const void* dy, const void* y, float* part,
                              float* out, int M, int K, int N, int R,
                              int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || !tma_reads(K, N, {x, w, dy, y}) ||
      R != (M + sm90::BM - 1) / sm90::BM)
    return cudaErrorInvalidValue;
  return relu ? bwd_stats_sm90<true>(x, w, mean, inv, dy, y, part, out, M, K,
                                     N, R, st)
              : bwd_stats_sm90<false>(x, w, mean, inv, dy, y, part, out, M,
                                      K, N, R, st);
}

// K7: dz [M, N] (cd) is scratch; dw_part [S, K, N] f32 scratch (unused when
// S == 1); writes dsc [M, N], dx [M, K] (cd) and dw [K, N] (f32). chunk is
// the rows of M per split, S * chunk >= M. Three launches, four when S > 1.
int dl4j_fused_bwd_apply(int dtype, const void* x, const void* w,
                         const float* mean, const float* inv,
                         const float* scale, const float* ca,
                         const float* cb, const void* dy, const void* y,
                         void* dz, void* dsc, void* dx, float* dw_part,
                         float* dw, int M, int K, int N, int S, int chunk,
                         int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || S < 1 || chunk < 1 ||
      static_cast<long long>(S) * chunk < M)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return relu ? bwd_apply<float, true>(x, w, mean, inv, scale, ca, cb, dy,
                                         y, dz, dsc, dx, dw_part, dw, M, K,
                                         N, S, chunk, st)
                : bwd_apply<float, false>(x, w, mean, inv, scale, ca, cb, dy,
                                          y, dz, dsc, dx, dw_part, dw, M, K,
                                          N, S, chunk, st);
  if (dtype == 1)
    return relu ? bwd_apply<__nv_bfloat16, true>(
                      x, w, mean, inv, scale, ca, cb, dy, y, dz, dsc, dx,
                      dw_part, dw, M, K, N, S, chunk, st)
                : bwd_apply<__nv_bfloat16, false>(
                      x, w, mean, inv, scale, ca, cb, dy, y, dz, dsc, dx,
                      dw_part, dw, M, K, N, S, chunk, st);
  return cudaErrorInvalidValue;
}

// K7, bf16, on the sm90 mainloop: the arguments and outputs of
// dl4j_fused_bwd_apply (the f32 dW and its partials 16-byte aligned too);
// chunk a multiple of the 64-row step when S > 1. Three launches, four
// when S > 1.
int dl4j_fused_bwd_apply_sm90(const void* x, const void* w,
                              const float* mean, const float* inv,
                              const float* scale, const float* ca,
                              const float* cb, const void* dy, const void* y,
                              void* dz, void* dsc, void* dx, float* dw_part,
                              float* dw, int M, int K, int N, int S,
                              int chunk, int relu, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || S < 1 || chunk < 1 ||
      !tma_reads(K, N, {x, w, dy, y, dz, dsc, dx, dw, dw_part}) ||
      (S > 1 && chunk % sm90::BK != 0) ||
      static_cast<long long>(S) * chunk < M)
    return cudaErrorInvalidValue;
  return relu ? bwd_apply_sm90<true>(x, w, mean, inv, scale, ca, cb, dy, y,
                                     dz, dsc, dx, dw_part, dw, M, K, N, S,
                                     chunk, st)
              : bwd_apply_sm90<false>(x, w, mean, inv, scale, ca, cb, dy, y,
                                      dz, dsc, dx, dw_part, dw, M, K, N, S,
                                      chunk, st);
}

// The sm90 mainloop's reduction step: dW's chunks of M are multiples of it.
int dl4j_fused_sm90_step() { return sm90::BK; }

// The tile shape, so the wrapper sizes its grids and scratch alike.
int dl4j_fused_tile_rows() { return BM; }
int dl4j_fused_tile_cols() { return BN; }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
