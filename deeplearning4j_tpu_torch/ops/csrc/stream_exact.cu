// The order-fixed kernels of the streaming (decode) path for Hopper
// (sm_90a): S1 stream_dense, S2 stream_mha and S3 stream_rownorm.
//
// They replace no Pallas kernel. The JAX package lowers the streaming path
// (deeplearning4j_tpu/nn/layers/attention.py::_dense_exact,
// deeplearning4j_tpu/ops/attention.py::_causal_mha_exact) to XLA fused
// multiply+reduce loops, whose accumulation order per output element
// depends only on the reduced length; that is what makes a token decoded
// one at a time bit-identical to the same token in a one-shot prefill, a
// chunked prefill or a row padded into a bucket. cuBLAS picks its kernel,
// and with it the accumulation order, by the product's M, so torch.matmul
// cannot keep that property. These kernels keep it by construction: each
// output element is summed by one thread in ascending order of the reduced
// index, with separately rounded products and sums (__fmul_rn, __fadd_rn:
// no contraction into FMA), which is also the order and the rounding of
// the plain versions in ops/stream_exact.py. Nothing depends on the number
// of rows, the query length, q_start, the bucket or the tile a row lands
// in. That rules out tensor cores (their products round and sum in the
// hardware's own order), split-K and any reduction tree whose shape
// follows the launch: S1's and S2's sums stay one dependent chain in one
// thread, and the design can only change how the operands reach that
// thread and how many chains run at once. S3 sums by one tree whose shape
// depends only on the row's width (below).
//
// S1 (dl4j_stream_dense): y[r, c] = (sum_i x[r, i] * W[i, c]) + bias[c],
// f32, i ascending.
//   What bounds it on this card. Bytes: W once, x once, y once (1.2 MB at
//   the decode step's [32, 256] x [256, 1024], 0.36 us at 3.35 TB/s).
//   Operations: the product and the sum are two f32 instructions each
//   (no FMA), 16.8 MFLOP there, 0.50 us at 33.5 T instructions/s (the 67
//   TFLOP/s FMA rate counts two a lane a cycle). The chain: each output is
//   f dependent adds of ~4 cycles each (chain_probe_kernel below measures
//   it), 1,024 x 4 cycles ~ 2.1 us for fc2's f = 1024 at 1.98 GHz,
//   whatever the parallelism. At a decode step the chain is the floor.
//   Design. A block of WB warps computes a tile of y, each warp TC
//   column threads by 32 / TC row threads: a thread owns RT rows x 2
//   adjacent columns, 2 RT independent chains that share their loads (a
//   16-byte x read covers four steps of a row, an 8-byte W read two
//   columns). x's rows and the W slab [64 f x 2 TC columns] are staged in
//   shared memory by 16-byte cp.async from every thread, in f-chunks of
//   64, ascending, four stages in flight: W is read from memory once per
//   row tile (the first version read it once per row) and every chain
//   step reads shared memory, eight steps' operands in one register
//   buffer while the other buffer's chains run. The wrapper's plan
//   (ops/stream_exact.py::dense_plan) takes the most rows a thread (4, 2,
//   1) that still leaves a warp for each of ~512 warp schedulers (more
//   chains a thread then only lengthen a warp's issue): 2 chains a thread
//   at a decode step, 8 at a 256-row prefill. Then 4 warps of 16 column
//   threads (32 columns a block) where that launches ~a block an SM, else
//   2 warps of 4 column threads (8 columns a block): 128 and 64 blocks at
//   the decode step's fc1 and fc2. A full wave of one-warp blocks (128 at
//   fc2) is slower: chip_smoke.py --stream-split sweeps every choice. What
//   holds S1 above the chain floor is the chain itself: a step whose
//   shared reads are not hidden costs ~3.5 adds (the same run's
//   [stream_floor]), and the compiler issues each read a few
//   instructions before its use.
//   Ragged rows, columns and f are cut at the tile edges; f % 4 != 0,
//   g % 4 != 0 or an unaligned base takes the same kernel with 4-byte
//   copies.
//
// S2 (dl4j_stream_mha): causal MHA of q [b, t, h, dh] against the
// fixed-extent cache k, v [b, C, h, dh] (f32), row i of batch row r at
// absolute position pos[r] + i, visible j <= last_i = min(pos[r] + i,
// C - 1):
//   s_j = (sum_d q[d] * k[j, d]) * scale  (d ascending);
//   m = max_j s_j (any order: max is exact);  p_j = expf(s_j - m);
//   l = sum_j p_j and o[d] = sum_j p_j * v[j, d]  (j ascending);
//   out[d] = o[d] / l  (normalised after the sum, as _causal_mha_exact).
// Masked positions add an exact zero in the plain version and are skipped
// here; which ones are skipped depends only on the row's own position.
//   What bounds it. Bytes: the visible rows of k and v (8.1 MB at the
//   decode step's 32 rows at random positions 5-255 and C = 256, 2.4 us).
//   The chains (64 adds a score, last_i + 1 adds an l and an o) are short
//   beside that. Operations (4 dh a visible position) are far below.
//   Design. One block of 128 threads per (batch row, head, group of qg
//   query rows): 128 blocks at the decode step (b = 32, h = 4, t = 1);
//   chunked and one-shot prefill split their query rows into groups
//   (ops/stream_exact.py::mha_plan) so that they also launch >= 2 blocks
//   an SM where t allows; groups of one (row, head) re-read k and v from
//   L2. The visible rows [0, L] of k and then of v stream through a
//   three-stage ring in shared memory (8192 / dh rows a stage, 128 at dh =
//   64), copied with coalesced 16-byte cp.async (a 256-byte row per 16
//   threads), two tiles in flight while the block computes: k's tiles,
//   then v's, so v arrives while the scores are summed; q's rows load
//   while the first tiles are in flight. Rows are padded to dh + 4 floats,
//   so the score threads (one per position j, each reading its row 16
//   bytes at a time) hit no bank twice in a quarter warp; q is broadcast
//   from shared memory. The scores go to a shared row of C floats per
//   query row; the row max is taken across the block; every thread turns
//   its positions into p. Then a thread per (query row, column d) sums l
//   and o[d] over j ascending, tile after tile, reading p broadcast and
//   v[j, d] from consecutive banks, four positions' operands in one
//   register buffer while the other buffer's chains run, and writes
//   o / l. dh % 4 != 0 or an unaligned base takes the same kernel with
//   4-byte copies into rows of dh + 1.
//
// S3 (dl4j_stream_rownorm): LayerNorm of each row of x [rows, w], f32:
// mu = (sum_i x_i) / w, d = x - mu, var = (sum_i d_i * d_i) / w,
// y = d * (1 / sqrt(var + eps)) * gamma + beta, the reciprocal square root
// as a rounded sqrt and a rounded division (the plain version's torch.sqrt
// and division round the same way). PyTorch's own mean is not
// decode-stable on the card: chip_smoke.py's [stream_invariance] read 5 of
// 8 rows moving by up to 2.4e-7 when the same rows came in a batch of 8
// instead of 2048 (NVIDIA H100 80GB HBM3, 700.00 W).
//   The order of both sums, fixed by w alone: lane l of a warp
//   sums columns l, l + 32, l + 64, ... ascending from +0.0 (a lane with
//   no column keeps +0.0); then five butterfly rounds p = p + p[l ^ m],
//   m = 16, 8, 4, 2, 1, by __shfl_xor_sync. IEEE addition commutes, so
//   every lane ends with the same bits. The plain version
//   (ops/stream_exact.py::stream_rownorm_torch) computes the same 32
//   partials and the same tree. The statistics are this order, not a
//   single ascending chain: only S3 sums by a tree, and its tree depends on
//   nothing but w, so a row's bits still depend on nothing but the row.
//   Design. One warp a row, kNormWarps rows a block, no __syncthreads.
//   Up to w = 32 K columns (K = 1, 2, 4, ..., kNormMaxCols) a lane holds
//   its columns of x, gamma and beta in registers, all loaded before the
//   sums start: x is read once (coalesced, a 128-byte line a step), the
//   two sums are K + 5 dependent adds each, y is written once.
//   A wider row loops over it in three passes (sum, sum of squares,
//   output), x read three times through L2. Bound: x read once and y
//   written once, 2 x 4 B a value: bytes; at the decode step's [32, 256]
//   the launch and the 2 x (8 + 5)-step chain set the floor.
//   The first version (one block of 128 threads a row, the row in shared
//   memory, thread 0 summing it twice in ascending order) stays as
//   dl4j_stream_rownorm_v1 for timing only.

// The first versions of S1, S2 and S3 stay as dl4j_stream_dense_v1,
// dl4j_stream_mha_v1 and dl4j_stream_rownorm_v1 (one thread an output
// with W read through L2 once a row; one warp a (row, query, head) with k
// read one row a lane, uncoalesced; a block a row, summed by one thread). Only chip_smoke.py's timing ([times], --stream-split)
// runs them, beside the new kernels; the registry never reaches them.
//
// The wrappers (ops/stream_exact.py) check shapes, dtypes, contiguity and
// the device, plan the launch, allocate the outputs and count the
// launches. Every entry point returns a cudaError_t (0 on success) and
// launches on the stream it is given.

#include <cuda_runtime.h>
#include <float.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;      // bytes a block can use (227 KB)

// S1
constexpr int kDenseFk = 64;          // f values a staged chunk
constexpr int kDenseStages = 4;
constexpr int kDenseXs = kDenseFk + 4;  // a staged x row, padded by 16 bytes
constexpr int kDenseGroup = 8;        // f steps a register buffer holds

// S2
constexpr int kMhaThreads = 128;
constexpr int kMhaStageFloats = 8192;   // a stage: 8192 / dh cache rows
constexpr int kMhaStages = 3;
constexpr int kMhaMaxItems = 8;         // (query row, column) outputs a thread

// first versions
constexpr int kDenseThreadsV1 = 128;
constexpr int kMhaWarpsV1 = 4;
constexpr int kNormThreadsV1 = 128;

// S3
constexpr int kNormWarps = 4;         // rows a block (one warp a row)
constexpr int kNormMaxCols = 32;      // columns a lane holds: w <= 1024

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared (the path for unaligned or odd widths)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float chain_step(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------ S1
// A warp is TC column threads (2 columns each) by 32 / TC row threads;
// blockDim.x = 32 WB. The block's tile is BR = (32 / TC) RT WB rows
// (blockIdx.x) by BC = 2 TC columns (blockIdx.y). Thread (warp, lane) owns
// rows r0 + tr RT + a (a < RT), tr = (32 / TC) warp + lane / TC, and
// columns c0 + 2 (lane % TC) + {0, 1}. Shared memory: the stages, each
// x's rows [BR x kDenseXs] and W's slab [kDenseFk x BC]. V4: f % 4 == 0,
// g % 4 == 0 and 16-byte aligned bases (16-byte copies); else 4-byte
// copies.
template <int RT, int TC, bool V4>
__global__ void __launch_bounds__(128)
    stream_dense_kernel(const float* __restrict__ x,
                        const float* __restrict__ W,
                        const float* __restrict__ bias,
                        float* __restrict__ y, int rows, int f, int g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TRW = 32 / TC;   // row threads a warp
  constexpr int BC = 2 * TC;
  const int nthreads = blockDim.x;
  const int BR = TRW * RT * (nthreads / 32);
  const int xs_floats = BR * kDenseXs;
  const int stage_floats = xs_floats + kDenseFk * BC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tc = lane % TC;
  const int tr = TRW * (tid >> 5) + lane / TC;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BR;
  const int c0 = blockIdx.y * BC;
  const int nchunks = (f + kDenseFk - 1) / kDenseFk;
  const int rows_in = static_cast<int>(
      min(static_cast<int64_t>(BR), static_cast<int64_t>(rows) - r0));
  const int cols_in = min(BC, g - c0);

  // chunk ch: x[r0 : r0 + rows_in, i0 : i0 + fk] and W[i0 : i0 + fk,
  // c0 : c0 + cols_in] into stage ch % kDenseStages; rows and columns past
  // the edge are not copied (their chains are never stored)
  auto issue = [&](int ch) {
    float* xs = smem + (ch % kDenseStages) * stage_floats;
    float* ws = xs + xs_floats;
    const int i0 = ch * kDenseFk;
    const int fk = min(kDenseFk, f - i0);
    if (V4) {
      const int xq = fk / 4, wq = cols_in / 4;   // 16-byte pieces a row
      for (int e = tid; e < rows_in * xq; e += nthreads) {
        const int rr = e / xq, qq = e - rr * xq;
        cp_async16(xs + rr * kDenseXs + 4 * qq,
                   x + (r0 + rr) * f + i0 + 4 * qq);
      }
      for (int e = tid; e < fk * wq; e += nthreads) {
        const int kk = e / wq, qq = e - kk * wq;
        cp_async16(ws + kk * BC + 4 * qq,
                   W + static_cast<int64_t>(i0 + kk) * g + c0 + 4 * qq);
      }
    } else {
      for (int e = tid; e < rows_in * fk; e += nthreads) {
        const int rr = e / fk, kk = e - rr * fk;
        cp_async4(xs + rr * kDenseXs + kk, x + (r0 + rr) * f + i0 + kk);
      }
      for (int e = tid; e < fk * cols_in; e += nthreads) {
        const int kk = e / cols_in, cc = e - kk * cols_in;
        cp_async4(ws + kk * BC + cc,
                  W + static_cast<int64_t>(i0 + kk) * g + c0 + cc);
      }
    }
  };

  float acc[RT][2];
#pragma unroll
  for (int a = 0; a < RT; ++a) acc[a][0] = acc[a][1] = 0.0f;
  // the bias read now, its latency hidden behind the chains
  float bv[2] = {0.0f, 0.0f};
  if (bias != nullptr) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
      if (c0 + 2 * tc + cc < g) bv[cc] = bias[c0 + 2 * tc + cc];
  }

#pragma unroll
  for (int s = 0; s < kDenseStages - 1; ++s) {
    if (s < nchunks) issue(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + kDenseStages - 1 < nchunks) issue(ch + kDenseStages - 1);
    cp_async_commit();
    cp_async_wait<kDenseStages - 1>();
    __syncthreads();
    const float* xr = smem + (ch % kDenseStages) * stage_floats +
                      tr * RT * kDenseXs;
    const float2* w2 = reinterpret_cast<const float2*>(
                           smem + (ch % kDenseStages) * stage_floats +
                           xs_floats) + tc;
    const int fk = min(kDenseFk, f - ch * kDenseFk);
    if (fk == kDenseFk) {
      // two register buffers of kDenseGroup steps' operands, A and B,
      // each loaded (in source order) while the other's chains run, with
      // no copies between them; each group's products come before its
      // sums
      float4 xa[RT][2], xb[RT][2];
      float2 wa[kDenseGroup], wb[kDenseGroup];
      auto load = [&](int k0, float4 (&xv)[RT][2],
                      float2 (&wv)[kDenseGroup]) {
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          xv[a][0] = *reinterpret_cast<const float4*>(xr + a * kDenseXs + k0);
          xv[a][1] =
              *reinterpret_cast<const float4*>(xr + a * kDenseXs + k0 + 4);
        }
#pragma unroll
        for (int u = 0; u < kDenseGroup; ++u)
          wv[u] = w2[(k0 + u) * (BC / 2)];
      };
      auto chains = [&](const float4 (&xv)[RT][2],
                        const float2 (&wv)[kDenseGroup]) {
#pragma unroll
        for (int u = 0; u < kDenseGroup; ++u) {
          float m[RT][2];
#pragma unroll
          for (int a = 0; a < RT; ++a) {
            const float xu = lane4(xv[a][u / 4], u % 4);
            m[a][0] = __fmul_rn(xu, wv[u].x);
            m[a][1] = __fmul_rn(xu, wv[u].y);
          }
#pragma unroll
          for (int a = 0; a < RT; ++a) {
            acc[a][0] = __fadd_rn(acc[a][0], m[a][0]);
            acc[a][1] = __fadd_rn(acc[a][1], m[a][1]);
          }
        }
      };
      load(0, xa, wa);
#pragma unroll
      for (int k0 = 0; k0 < kDenseFk; k0 += 2 * kDenseGroup) {
        load(k0 + kDenseGroup, xb, wb);
        chains(xa, wa);
        if (k0 + 2 * kDenseGroup < kDenseFk)
          load(k0 + 2 * kDenseGroup, xa, wa);
        chains(xb, wb);
      }
    } else {
      for (int kk = 0; kk < fk; ++kk) {
        const float2 wv = w2[kk * (BC / 2)];
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          const float xa = xr[a * kDenseXs + kk];
          acc[a][0] = chain_step(acc[a][0], xa, wv.x);
          acc[a][1] = chain_step(acc[a][1], xa, wv.y);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int64_t r = r0 + tr * RT + a;
    if (r >= rows) continue;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = c0 + 2 * tc + cc;
      if (c >= g) continue;
      y[r * g + c] = bias != nullptr ? __fadd_rn(acc[a][cc], bv[cc])
                                     : acc[a][cc];
    }
  }
}

// The shared memory of a launch of S1 with blocks of br rows by bc
// columns (mirrored by ops/stream_exact.py::dense_plan).
int dense_smem_bytes(int br, int bc) {
  return kDenseStages * (br * kDenseXs + kDenseFk * bc) * 4;
}

// ------------------------------------------------------------------ S2
// Grid: b * heads * groups blocks, block (r * heads + hd) * groups + grp
// owns query rows [grp qg, grp qg + qg) of (r, hd). Shared memory: the
// ring (kMhaStages x tj rows of ks floats), q (qg x dh), the scores and
// then p (qg x C), the row maxima (qg) and their per-warp parts (4 qg).
// V4: dh % 4 == 0 and 16-byte aligned bases: 16-byte copies into rows
// padded to ks = dh + 4 floats (a quarter warp reading 16 bytes of 8
// consecutive rows then hits 8 distinct bank quads); else 4-byte copies
// into rows of dh + 1.
template <bool V4>
__global__ void __launch_bounds__(kMhaThreads)
    stream_mha_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ pos, float* __restrict__ out,
                      int t, int heads, int dh, int C, int qg, int groups,
                      int tj, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ks = V4 ? dh + 4 : dh + 1;
  float* ring = smem;
  float* qs = ring + kMhaStages * tj * ks;
  float* ps = qs + qg * dh;
  float* ms = ps + static_cast<int64_t>(qg) * C;
  float* red = ms + qg;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = blockIdx.x % groups;
  const int hd = (blockIdx.x / groups) % heads;
  const int r = blockIdx.x / (groups * heads);
  const int i0 = grp * qg;
  const int nq = min(qg, t - i0);
  const int p0 = pos[r] + i0;                  // the group's first position
  const int L = min(p0 + nq - 1, C - 1);       // the group's last visible
  const int64_t kv_stride = static_cast<int64_t>(heads) * dh;
  const float* kb = k + static_cast<int64_t>(r) * C * kv_stride + hd * dh;
  const float* vb = v + static_cast<int64_t>(r) * C * kv_stride + hd * dh;
  const int nt = L >= 0 ? L / tj + 1 : 0;      // tiles of k, then of v

  // tile u < nt: k rows [u tj, ...); tile u >= nt: v rows [(u - nt) tj, ...)
  auto issue = [&](int u) {
    const bool is_v = u >= nt;
    const int j0 = (is_v ? u - nt : u) * tj;
    const int n = min(tj, L + 1 - j0);
    float* st = ring + (u % kMhaStages) * tj * ks;
    const float* src = (is_v ? vb : kb) + j0 * kv_stride;
    if (V4) {
      const int nch = dh / 4;             // 16-byte pieces a row
      for (int e = tid; e < n * nch; e += kMhaThreads) {
        const int jj = e / nch, c = e - jj * nch;
        cp_async16(st + jj * ks + 4 * c, src + jj * kv_stride + 4 * c);
      }
    } else {
      for (int e = tid; e < n * dh; e += kMhaThreads) {
        const int jj = e / dh, d = e - jj * dh;
        cp_async4(st + jj * ks + d, src + jj * kv_stride + d);
      }
    }
  };

  // this thread's (query row, column) outputs
  const int items = max(0, (nq * dh - tid + kMhaThreads - 1) / kMhaThreads);
  float o[kMhaMaxItems], l[kMhaMaxItems];
#pragma unroll
  for (int n = 0; n < kMhaMaxItems; ++n) o[n] = l[n] = 0.0f;

  const int total = 2 * nt;
#pragma unroll
  for (int s = 0; s < kMhaStages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  // q's rows while the first tiles are in flight (the loop's first barrier
  // publishes them)
  for (int e = tid; e < nq * dh; e += kMhaThreads) {
    const int ii = e / dh;
    qs[e] = q[((static_cast<int64_t>(r) * t + i0 + ii) * heads + hd) * dh +
              (e - ii * dh)];
  }
  for (int u = 0; u < total; ++u) {
    if (u + kMhaStages - 1 < total) issue(u + kMhaStages - 1);
    cp_async_commit();
    cp_async_wait<kMhaStages - 1>();
    __syncthreads();
    const float* st = ring + (u % kMhaStages) * tj * ks;
    if (u < nt) {
      // scores of this tile's positions: one thread a (query row, j)
      const int j0 = u * tj;
      const int n = min(tj, L + 1 - j0);
      for (int e = tid; e < nq * n; e += kMhaThreads) {
        const int ii = e / n, jj = e - ii * n;
        const int j = j0 + jj;
        if (j > min(p0 + ii, C - 1)) continue;
        float s = 0.0f;
        if (V4) {
          // eight d a buffer, two buffers, each loaded (in source order)
          // while the other's chain runs (reads past the row repeat its
          // last piece and go unused); four products before four sums
          const float4* kr = reinterpret_cast<const float4*>(st + jj * ks);
          const float4* qr = reinterpret_cast<const float4*>(qs + ii * dh);
          const int nch = dh / 4, cl = nch - 1;
          float4 kv[2][2], qv[2][2];
          auto load = [&](int c, int buf) {
#pragma unroll
            for (int z = 0; z < 2; ++z) {
              kv[buf][z] = kr[min(c + z, cl)];
              qv[buf][z] = qr[min(c + z, cl)];
            }
          };
          auto chain = [&](int c, int buf) {
#pragma unroll
            for (int z = 0; z < 2; ++z) {
              if (c + z >= nch) break;
              const float m0 = __fmul_rn(qv[buf][z].x, kv[buf][z].x);
              const float m1 = __fmul_rn(qv[buf][z].y, kv[buf][z].y);
              const float m2 = __fmul_rn(qv[buf][z].z, kv[buf][z].z);
              const float m3 = __fmul_rn(qv[buf][z].w, kv[buf][z].w);
              s = __fadd_rn(s, m0);
              s = __fadd_rn(s, m1);
              s = __fadd_rn(s, m2);
              s = __fadd_rn(s, m3);
            }
          };
          load(0, 0);
          for (int c = 0; c < nch; c += 4) {
            load(c + 2, 1);
            chain(c, 0);
            load(c + 4, 0);
            chain(c + 2, 1);
          }
        } else {
          for (int d = 0; d < dh; ++d)
            s = chain_step(s, qs[ii * dh + d], st[jj * ks + d]);
        }
        ps[static_cast<int64_t>(ii) * C + j] = __fmul_rn(s, scale);
      }
    } else {
      // l and o over this tile's positions, ascending
      const int j0 = (u - nt) * tj;
      const int n = min(tj, L + 1 - j0);
#pragma unroll
      for (int it = 0; it < kMhaMaxItems; ++it) {
        if (it >= items) break;
        const int w = tid + it * kMhaThreads;
        const int ii = w / dh, d = w - ii * dh;
        const int end = min(n, min(p0 + ii, C - 1) - j0 + 1);
        const float* pr = ps + static_cast<int64_t>(ii) * C + j0;
        const float* vc = st + d;
        float oo = o[it], ll = l[it];
        // four positions a buffer, two buffers, each loaded (in source
        // order) while the other's chains run, with no copies between
        // them (rotating one buffer through copies made the compiler wait
        // on each read); four products before the sums
        float pv[2][4], vv[2][4];
        auto load = [&](int j, int buf) {
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const int jz = min(j + z, end - 1);
            pv[buf][z] = pr[jz];
            vv[buf][z] = vc[jz * ks];
          }
        };
        auto chains = [&](int buf) {
          float m[4];
#pragma unroll
          for (int z = 0; z < 4; ++z)
            m[z] = __fmul_rn(pv[buf][z], vv[buf][z]);
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            ll = __fadd_rn(ll, pv[buf][z]);
            oo = __fadd_rn(oo, m[z]);
          }
        };
        int jj = 0;
        if (end >= 8) {
          load(0, 0);
          for (; jj + 8 <= end; jj += 8) {
            load(jj + 4, 1);
            chains(0);
            load(jj + 8, 0);
            chains(1);
          }
        }
        for (; jj < end; ++jj) {
          const float p = pr[jj];
          ll = __fadd_rn(ll, p);
          oo = chain_step(oo, p, vc[jj * ks]);
        }
        o[it] = oo;
        l[it] = ll;
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration
    if (u == nt - 1) {
      // the row maxima (exact in any order): every thread over its
      // positions, then across the warp and across the four warps; then
      // p = expf(s - m)
      for (int ii = 0; ii < nq; ++ii) {
        const int last = min(p0 + ii, C - 1);
        const float* sr = ps + static_cast<int64_t>(ii) * C;
        float m = -INFINITY;
        for (int j = tid; j <= last; j += kMhaThreads) m = fmaxf(m, sr[j]);
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) red[ii * (kMhaThreads / 32) + warp] = m;
      }
      __syncthreads();
      for (int ii = tid; ii < nq; ii += kMhaThreads) {
        float m = red[ii * (kMhaThreads / 32)];
        for (int w = 1; w < kMhaThreads / 32; ++w)
          m = fmaxf(m, red[ii * (kMhaThreads / 32) + w]);
        ms[ii] = m;
      }
      __syncthreads();
      for (int e = tid; e < nq * (L + 1); e += kMhaThreads) {
        const int ii = e / (L + 1), j = e - ii * (L + 1);
        if (j > min(p0 + ii, C - 1)) continue;
        float* pj = ps + static_cast<int64_t>(ii) * C + j;
        *pj = expf(__fsub_rn(*pj, ms[ii]));
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int it = 0; it < kMhaMaxItems; ++it) {
    if (it >= items) break;
    const int w = tid + it * kMhaThreads;
    const int ii = w / dh, d = w - ii * dh;
    out[((static_cast<int64_t>(r) * t + i0 + ii) * heads + hd) * dh + d] =
        __fdiv_rn(o[it], l[it]);
  }
}

// Cache rows a stage of the ring: 8192 / dh, at most the cache.
int mha_tile_rows(int dh, int C) {
  return std::max(1, std::min(kMhaStageFloats / dh, C));
}

// The shared memory of a launch of S2, or -1 if it does not fit (mirrored
// by ops/stream_exact.py::mha_plan).
int64_t mha_smem_bytes(int dh, int C, int qg, bool v4) {
  const int64_t ks = v4 ? dh + 4 : dh + 1;
  const int64_t tj = mha_tile_rows(dh, C);
  const int64_t floats = kMhaStages * tj * ks +
                         static_cast<int64_t>(qg) * (dh + C + 1 + 4);
  const int64_t bytes = floats * 4;
  return bytes > kSmemMax ? -1 : bytes;
}

// ------------------------------------------------------- first versions
__global__ void stream_dense_kernel_v1(const float* __restrict__ x,
                                       const float* __restrict__ W,
                                       const float* __restrict__ bias,
                                       float* __restrict__ y, int f, int g) {
  const int c = blockIdx.x * kDenseThreadsV1 + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= g) return;
  const float* xr = x + static_cast<int64_t>(r) * f;
  float acc = 0.0f;
  for (int i = 0; i < f; ++i)
    acc = __fadd_rn(acc, __fmul_rn(xr[i], W[static_cast<int64_t>(i) * g + c]));
  if (bias != nullptr) acc = __fadd_rn(acc, bias[c]);
  y[static_cast<int64_t>(r) * g + c] = acc;
}

// shared memory per warp: q's row (dh floats) and p (C floats)
__global__ void stream_mha_kernel_v1(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const int* __restrict__ pos,
                                     float* __restrict__ out, int b, int t,
                                     int heads, int dh, int C, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kMhaWarpsV1 + warp;
  const int64_t n_rows = static_cast<int64_t>(b) * t * heads;
  if (row >= n_rows) return;
  float* qs = smem + warp * (dh + C);
  float* ps = qs + dh;
  const int hd = static_cast<int>(row % heads);
  const int i = static_cast<int>((row / heads) % t);
  const int r = static_cast<int>(row / (static_cast<int64_t>(heads) * t));
  const float* qrow = q + row * dh;
  for (int d = lane; d < dh; d += 32) qs[d] = qrow[d];
  __syncwarp();
  const int qpos = pos[r] + i;
  const int last = qpos < C - 1 ? qpos : C - 1;   // visible: j <= last
  const int64_t kv_stride = static_cast<int64_t>(heads) * dh;
  const float* kb = k + static_cast<int64_t>(r) * C * kv_stride + hd * dh;
  const float* vb = v + static_cast<int64_t>(r) * C * kv_stride + hd * dh;
  float m = -INFINITY;
  for (int j = lane; j <= last; j += 32) {
    const float* kj = kb + j * kv_stride;
    float s = 0.0f;
    for (int d = 0; d < dh; ++d) s = __fadd_rn(s, __fmul_rn(qs[d], kj[d]));
    s = __fmul_rn(s, scale);
    ps[j] = s;
    m = fmaxf(m, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  for (int j = lane; j <= last; j += 32) ps[j] = expf(__fsub_rn(ps[j], m));
  __syncwarp();
  float l = 0.0f;
  for (int j = 0; j <= last; ++j) l = __fadd_rn(l, ps[j]);
  float* orow = out + row * dh;
  for (int d = lane; d < dh; d += 32) {
    float o = 0.0f;
    for (int j = 0; j <= last; ++j)
      o = __fadd_rn(o, __fmul_rn(ps[j], vb[j * kv_stride + d]));
    orow[d] = __fdiv_rn(o, l);
  }
}

// ------------------------------------------------------------ the floor
// One warp times n steps of a dependent add chain, s = s + a * b with
// separately rounded products and sums as S1 and S2 sum: cycles[0] with
// a and b in registers, cycles[1] with them read from shared memory just
// before each step (the cost a chain pays when nothing hides the read).
// chip_smoke.py --stream-split reads it as the chain floor.
__global__ void chain_probe_kernel(const float* __restrict__ in,
                                   float* __restrict__ out,
                                   long long* __restrict__ cycles, int n) {
  __shared__ float sm[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) sm[i] = in[i];
  __syncwarp();
  float a = in[threadIdx.x], b = in[threadIdx.x + 32];
  float s = 0.0f;
  long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) s = chain_step(s, a, b);
  long long t1 = clock64();
  float s2 = 0.0f;
  const long long t2 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i)
    s2 = chain_step(s2, sm[i & 1023], sm[(threadIdx.x + i) & 1023]);
  const long long t3 = clock64();
  out[threadIdx.x] = s + s2;
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t3 - t2;
  }
}

// ------------------------------------------------------------------ S3
// The fixed tree: five butterfly rounds over the warp's 32 partials.
__device__ __forceinline__ float warp_tree(float p) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, m));
  return p;
}

// One warp a row. K > 0: lane l holds columns l + 32 k (k < K) in
// registers (w <= 32 K); K == 0: any w, three passes over the row.
template <int K>
__global__ void __launch_bounds__(32 * kNormWarps)
    stream_rownorm_kernel(const float* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          float* __restrict__ y, int64_t rows, int w,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kNormWarps +
                    (threadIdx.x >> 5);
  if (r >= rows) return;             // the whole warp leaves together
  const float* xr = x + r * w;
  float* yr = y + r * w;
  const float n = static_cast<float>(w);
  if constexpr (K > 0) {
    // x, gamma and beta all loaded up front: the scale and shift arrive
    // while the sums run, not after them
    float v[K], gk[K], bk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < w ? xr[c] : 0.0f;
      gk[k] = c < w ? gamma[c] : 0.0f;
      bk[k] = c < w ? beta[c] : 0.0f;
    }
    float p = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < w) p = __fadd_rn(p, v[k]);
    const float mu = __fdiv_rn(warp_tree(p), n);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k < w) {
        v[k] = __fsub_rn(v[k], mu);
        q = __fadd_rn(q, __fmul_rn(v[k], v[k]));
      }
    }
    const float var = __fdiv_rn(warp_tree(q), n);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      if (c < w)
        yr[c] = __fadd_rn(__fmul_rn(__fmul_rn(v[k], inv), gk[k]), bk[k]);
    }
  } else {
    float p = 0.0f;
    for (int c = lane; c < w; c += 32) p = __fadd_rn(p, xr[c]);
    const float mu = __fdiv_rn(warp_tree(p), n);
    float q = 0.0f;
    for (int c = lane; c < w; c += 32) {
      const float d = __fsub_rn(xr[c], mu);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(warp_tree(q), n);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    for (int c = lane; c < w; c += 32)
      yr[c] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[c], mu), inv),
                                  gamma[c]),
                        beta[c]);
  }
}

// The first version of S3: one block of 128 threads a row, the row in
// dynamic shared memory (w floats and its two statistics), thread 0
// summing it in ascending order twice.
__global__ void stream_rownorm_kernel_v1(const float* __restrict__ x,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         float* __restrict__ y, int w,
                                         float eps) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* stats = smem + w;
  const int64_t r = blockIdx.x;
  const float* xr = x + r * w;
  for (int i = threadIdx.x; i < w; i += kNormThreadsV1) xs[i] = xr[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(w);
    float s = 0.0f;
    for (int i = 0; i < w; ++i) s = __fadd_rn(s, xs[i]);
    const float mu = __fdiv_rn(s, n);
    float ss = 0.0f;
    for (int i = 0; i < w; ++i) {
      const float d = __fsub_rn(xs[i], mu);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(ss, n);
    stats[0] = mu;
    stats[1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  __syncthreads();
  const float mu = stats[0];
  const float inv = stats[1];
  float* yr = y + r * w;
  for (int i = threadIdx.x; i < w; i += kNormThreadsV1) {
    const float d = __fsub_rn(xs[i], mu);
    yr[i] = __fadd_rn(__fmul_rn(__fmul_rn(d, inv), gamma[i]), beta[i]);
  }
}

template <int K>
void launch_rownorm(unsigned blocks, cudaStream_t s, const float* x,
                    const float* gamma, const float* beta, float* y,
                    int64_t rows, int w, float eps) {
  stream_rownorm_kernel<K><<<blocks, 32 * kNormWarps, 0, s>>>(
      x, gamma, beta, y, rows, w, eps);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int RT, int TC, bool V4>
cudaError_t launch_dense_as(dim3 grid, int threads, int smem,
                            cudaStream_t stream, const float* x,
                            const float* W, const float* bias, float* y,
                            int rows, int f, int g) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_dense_kernel<RT, TC, V4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  stream_dense_kernel<RT, TC, V4><<<grid, threads, smem, stream>>>(
      x, W, bias, y, rows, f, g);
  return cudaGetLastError();
}

template <int RT, int TC>
cudaError_t launch_dense(bool v4, dim3 grid, int threads, int smem,
                         cudaStream_t stream, const float* x, const float* W,
                         const float* bias, float* y, int rows, int f,
                         int g) {
  return v4 ? launch_dense_as<RT, TC, true>(grid, threads, smem, stream, x,
                                            W, bias, y, rows, f, g)
            : launch_dense_as<RT, TC, false>(grid, threads, smem, stream, x,
                                             W, bias, y, rows, f, g);
}

template <int TC>
cudaError_t launch_dense_rt(int rt, bool v4, dim3 grid, int threads,
                            int smem, cudaStream_t stream, const float* x,
                            const float* W, const float* bias, float* y,
                            int rows, int f, int g) {
  if (rt == 1)
    return launch_dense<1, TC>(v4, grid, threads, smem, stream, x, W, bias,
                               y, rows, f, g);
  if (rt == 2)
    return launch_dense<2, TC>(v4, grid, threads, smem, stream, x, W, bias,
                               y, rows, f, g);
  return launch_dense<4, TC>(v4, grid, threads, smem, stream, x, W, bias, y,
                             rows, f, g);
}

}  // namespace

extern "C" {

// S1. x [rows, f], W [f, g], bias [g] or null, y [rows, g]; all f32 and
// contiguous. rt (rows a thread: 1, 2 or 4), tc (column threads a warp:
// 4 or 16) and wb (warps a block: 1, 2 or 4) come from
// ops/stream_exact.py::dense_plan.
int dl4j_stream_dense(const void* x, const void* W, const void* bias,
                      void* y, int rows, int f, int g, int rt, int tc,
                      int wb, void* stream) {
  if (rows < 1 || f < 1 || g < 1 || (rt != 1 && rt != 2 && rt != 4) ||
      (tc != 4 && tc != 16) || (wb != 1 && wb != 2 && wb != 4))
    return cudaErrorInvalidValue;
  const int br = (32 / tc) * rt * wb, bc = 2 * tc;
  const int64_t row_tiles = (static_cast<int64_t>(rows) + br - 1) / br;
  const int col_tiles = (g + bc - 1) / bc;
  if (row_tiles > 2147483647LL || col_tiles > 65535)
    return cudaErrorInvalidValue;
  const bool v4 = f % 4 == 0 && g % 4 == 0 && aligned16(x) && aligned16(W);
  const int smem = dense_smem_bytes(br, bc);
  const dim3 grid(static_cast<unsigned>(row_tiles), col_tiles);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* Wf = static_cast<const float*>(W);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  const cudaError_t e =
      tc == 4 ? launch_dense_rt<4>(rt, v4, grid, 32 * wb, smem, s, xf, Wf,
                                   bf, yf, rows, f, g)
              : launch_dense_rt<16>(rt, v4, grid, 32 * wb, smem, s, xf, Wf,
                                    bf, yf, rows, f, g);
  return static_cast<int>(e);
}

// S2. q, out [b, t, h, dh]; k, v [b, C, h, dh]; pos [b] int32; all f32
// (pos int32) and contiguous. qg (query rows a block) and groups (blocks a
// (row, head)) come from ops/stream_exact.py::mha_plan; v4 takes 16-byte
// copies (dh % 4 == 0 and 16-byte aligned bases, checked here too).
int dl4j_stream_mha(const void* q, const void* k, const void* v,
                    const void* pos, void* out, int b, int t, int heads,
                    int dh, int cache_len, int qg, int groups, int v4,
                    float scale, void* stream) {
  if (b < 1 || t < 1 || heads < 1 || dh < 1 || cache_len < 1 || qg < 1 ||
      groups < 1 || static_cast<int64_t>(qg) * groups < t ||
      static_cast<int64_t>(qg) * dh > kMhaMaxItems * kMhaThreads)
    return cudaErrorInvalidValue;
  if (v4 && (dh % 4 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v)))
    return cudaErrorInvalidValue;
  const int64_t smem = mha_smem_bytes(dh, cache_len, qg, v4 != 0);
  const int64_t blocks = static_cast<int64_t>(b) * heads * groups;
  if (smem < 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  const int tj = mha_tile_rows(dh, cache_len);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pi = static_cast<const int*>(pos);
  auto* of = static_cast<float*>(out);
  if (v4) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          stream_mha_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    stream_mha_kernel<true><<<static_cast<unsigned>(blocks), kMhaThreads,
                              static_cast<size_t>(smem), s>>>(
        qf, kf, vf, pi, of, t, heads, dh, cache_len, qg, groups, tj, scale);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          stream_mha_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    stream_mha_kernel<false><<<static_cast<unsigned>(blocks), kMhaThreads,
                               static_cast<size_t>(smem), s>>>(
        qf, kf, vf, pi, of, t, heads, dh, cache_len, qg, groups, tj, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first version of S1 (timed by chip_smoke.py --stream-split only).
int dl4j_stream_dense_v1(const void* x, const void* W, const void* bias,
                         void* y, int rows, int f, int g, void* stream) {
  if (rows < 1 || f < 1 || g < 1 || rows > 65535) return cudaErrorInvalidValue;
  dim3 grid((g + kDenseThreadsV1 - 1) / kDenseThreadsV1, rows);
  stream_dense_kernel_v1<<<grid, kDenseThreadsV1, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const float*>(bias), static_cast<float*>(y), f, g);
  return static_cast<int>(cudaGetLastError());
}

// The first version of S2 (timed by chip_smoke.py --stream-split only).
int dl4j_stream_mha_v1(const void* q, const void* k, const void* v,
                       const void* pos, void* out, int b, int t, int heads,
                       int dh, int cache_len, float scale, void* stream) {
  if (b < 1 || t < 1 || heads < 1 || dh < 1 || cache_len < 1)
    return cudaErrorInvalidValue;
  const int smem =
      static_cast<int>(kMhaWarpsV1 * (dh + cache_len) * sizeof(float));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_mha_kernel_v1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t rows = static_cast<int64_t>(b) * t * heads;
  const int64_t blocks = (rows + kMhaWarpsV1 - 1) / kMhaWarpsV1;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  stream_mha_kernel_v1<<<static_cast<unsigned>(blocks), kMhaWarpsV1 * 32,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos),
      static_cast<float*>(out), b, t, heads, dh, cache_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// S3. x, y [rows, w]; gamma, beta [w]; all f32 and contiguous. cols: the
// columns a lane holds in registers (1, 2, 4, ..., kNormMaxCols, at least
// w / 32), or 0 for the looped kernel (any w); from
// ops/stream_exact.py::rownorm_plan.
int dl4j_stream_rownorm(const void* x, const void* gamma, const void* beta,
                        void* y, long long rows, int w, int cols, float eps,
                        void* stream) {
  if (rows < 1 || w < 1 || cols < 0 || cols > kNormMaxCols ||
      (cols & (cols - 1)) != 0 ||
      (cols > 0 && static_cast<int64_t>(cols) * 32 < w))
    return cudaErrorInvalidValue;
  const int64_t blocks = (rows + kNormWarps - 1) / kNormWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const auto b = static_cast<unsigned>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  auto* yf = static_cast<float*>(y);
  switch (cols) {
    case 0: launch_rownorm<0>(b, s, xf, gf, bf, yf, rows, w, eps); break;
    case 1: launch_rownorm<1>(b, s, xf, gf, bf, yf, rows, w, eps); break;
    case 2: launch_rownorm<2>(b, s, xf, gf, bf, yf, rows, w, eps); break;
    case 4: launch_rownorm<4>(b, s, xf, gf, bf, yf, rows, w, eps); break;
    case 8: launch_rownorm<8>(b, s, xf, gf, bf, yf, rows, w, eps); break;
    case 16: launch_rownorm<16>(b, s, xf, gf, bf, yf, rows, w, eps); break;
    default: launch_rownorm<32>(b, s, xf, gf, bf, yf, rows, w, eps); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The first version of S3 (timed by chip_smoke.py only): w + 2 floats of
// shared memory a block, so w <= 58,110.
int dl4j_stream_rownorm_v1(const void* x, const void* gamma,
                           const void* beta, void* y, int rows, int w,
                           float eps, void* stream) {
  if (rows < 1 || w < 1) return cudaErrorInvalidValue;
  const int64_t smem = (static_cast<int64_t>(w) + 2) * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_rownorm_kernel_v1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stream_rownorm_kernel_v1<<<rows, kNormThreadsV1, static_cast<int>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y), w, eps);
  return static_cast<int>(cudaGetLastError());
}

// The chain floor's probe: in >= 1024 floats, out 32 floats, cycles 2
// int64 (see chain_probe_kernel).
int dl4j_stream_chain_probe(const void* in, void* out, void* cycles, int n,
                            void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<long long*>(cycles), n);
  return static_cast<int>(cudaGetLastError());
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
