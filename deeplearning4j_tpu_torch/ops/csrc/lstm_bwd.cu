// Whole-sequence Graves LSTM backward for Hopper (sm_90a), on one of two
// routes (chosen in ops/lstm.py::takes_cluster by dtype and n only):
// - bf16 with n a multiple of 64 up to 512: the reverse chain on a
//   thread-block cluster (lstm_bwd_cluster_kernel), the sum of dp's
//   partials, then dWh on sm90_gemm.cuh's TMA + wgmma mainloop: three
//   launches;
// - f32, and any other n: the first design, a persistent cooperative grid
//   for the chain and an f32-FMA GEMM for dWh: two launches.
//
// Replaces deeplearning4j_tpu/ops/lstm.py::_bwd_kernel (the Pallas TPU
// kernel behind _bwd_call) and computes the same function with the same
// numerics, from the residuals the forward kernel (lstm_fwd.cu) writes:
// c = f*c_prev + i*g and tanh(c) are recomputed in f32 from the rounded
// residuals; the (dh, dc) carry is f32; dh = m*(dh_next + dy); dz is
// rounded to the compute dtype before both products that use it; masked
// steps pass dh and dc through with (1 - m); dWh and dp accumulate in f32
// and are rounded once at the end. The mask is used multiplicatively, as
// the TPU kernel does (the forward kernel tests m > 0; the two agree for
// 0/1 masks).
//
// What bounds it: like the forward, the T steps form a serial chain. Step t
// needs all of dh[t+1], and dh_prev = dz @ Wh^T sums over every gate
// column, so the card can never run more than one step at a time. The
// least work is 2 * 2*T*b*n*4n FLOPs (the chain's product and dWh; 8.6
// GFLOP at T = 64, b = 32, n = 512, a few microseconds at the card's bf16
// rate) and ~27 MB moved once, so the floor that counts is T times (one
// barrier + one step's dependent product, sums and exchange), not FLOPs or
// bytes.
//
// The cluster route (lstm_cluster.cuh: ownership and layouts). Block rank
// q of a cluster of n / 32 blocks, one cluster per 32 batch rows, owns
// units 32 q .. 32 q + 31, their four gate columns and Wh[:, those 128
// columns] in shared memory, the same slice as the forward. Each step t
// from T-1 down to 0:
// - phase A: dz of its 128 columns and dc are block-local, one thread per
//   (unit, four rows), the (dh, dc) carry and the dp sums in registers; G,
//   c_prev, dy and mask are loaded a step ahead; dz, rounded to bf16, goes
//   to dxz[t] and, K-major, to shared memory;
// - dh_prev needs dz of all 4n columns. Each block forms, on wgmma
//   m64n32k16 (M = n in m64 tiles over its two warpgroups, K = its 128
//   columns, N = R), its partial P_q[u][r] = sum over its columns j of
//   Wh[u][j] dz[r][j] for all n units, f32, in registers;
// - a reduce-scatter over DSMEM: block q stages the rows of P_q that each
//   owner (block u / 32) needs, 4 KB an owner, eight owners a round, and
//   pushes each into slot q of its owner's receive buffer (C x 32 x R f32,
//   64 KB at n = 512) with one bulk copy, counted on the owner's `ready`
//   barrier; the owner waits for all C x 4 KB and sums its slots in rank
//   order 0 .. C-1, adding (1 - m) dh_next, so two calls give the same
//   bits. It then signals `done` on every block, which a block waits for
//   before it pushes again (the wait is behind phase A and the product).
//   Broadcasting dz instead would need dz [R][4n] beside the slice: 128 +
//   128 KB, which does not fit.
// dp: each thread's sums, then the eight warps in order, per cluster into
// f32 partials that a second launch sums in chunk order. dWh = h_prev^T
// dxz (both MN-major, K = T b) after the chain on the sm90 mainloop with
// an epilogue that rounds to bf16, reducing in its fixed order.
// Shared memory of a cluster block at n = 512: slice 128 KB, recv 64 KB,
// stage 32 KB (dz and, at the end, dp's warp sums share it), barriers and
// 1 KB of alignment slack: 225 KB of the 227 KB (static_assert below).
//
// The grid route:
// - One persistent cooperative grid walks t = T-1 .. 0, one grid barrier
//   per step, no kernel launch per step.
// - Each block owns U hidden units and all four gate columns of them, so
//   dz of its columns, dc and the peephole sums dp are block-local; the
//   (dh, dc) carry of its units stays in the block (an f32 global scratch
//   that only this block touches).
// - dh_prev of its units needs dz of all 4n columns. dz is exchanged
//   through dxz's own slice t: each block writes its columns of dxz[t]
//   (the output the caller needs anyway), the grid barrier publishes them,
//   and every block reads the whole row back through L2. Slice t is never
//   written again, so no double buffer is needed.
// - The block's U rows of Wh (U x 4n) sit in shared memory for the whole
//   sequence. One warp per batch row splits the 4n-long dot products over
//   its lanes and reduces them with a fixed butterfly.
// - dWh = sum over (t, b) of h_prev^T dz does not depend on the chain, so
//   it runs after it, as a second launch: a tiled product from shared
//   memory with f32 FMA over k = t*b + r in ascending order.
//
// No atomics and no order that depends on scheduling: two identical calls
// give identical bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;                 // hidden units per chain block (U)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                 // dWh output tile, rows and columns
constexpr int kTileK = 16;                // dWh reduction slice
constexpr int kGemmThreads = 256;
static_assert(kThreads % kUnits == 0, "a thread keeps one unit in phase A");
static_assert(kUnits <= 32, "lane u holds unit u after the reduction");

// The block's rows of Wh: [kUnits][4n].
inline size_t smem_bytes(int n, size_t elem) {
  return static_cast<size_t>(kUnits) * 4 * static_cast<size_t>(n) * elem;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A load through L2, for values other blocks wrote before a grid barrier.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_chain_kernel(const T* __restrict__ G, const T* __restrict__ cprev,
                      const T* __restrict__ mask, const T* __restrict__ Wh,
                      const T* __restrict__ p, const T* __restrict__ dy,
                      const T* __restrict__ dhT, const T* __restrict__ dcT,
                      T* dxz, T* __restrict__ dh0, T* __restrict__ dc0,
                      T* __restrict__ dp, float* dhbuf, float* dcbuf,
                      int steps, int b, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W_s = reinterpret_cast<T*>(smem_raw);   // [kUnits][4n]
  __shared__ float dp_s[3][kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int u0 = blockIdx.x * kUnits;
  const size_t n4 = 4 * static_cast<size_t>(n);

  // This block's rows of Wh, loaded once for the whole sequence.
  for (size_t idx = tid; idx < kUnits * n4; idx += kThreads) {
    const int uu = u0 + static_cast<int>(idx / n4);
    W_s[idx] = uu < n ? Wh[static_cast<size_t>(uu) * n4 + idx % n4]
                      : from_f<T>(0.0f);
  }
  // Phase A item idx is (row idx / U, unit u0 + idx % U); the stride is a
  // multiple of U, so this thread's unit is the same for every item.
  const int unit = u0 + tid % kUnits;
  const bool unit_ok = unit < n;
  float p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  if (unit_ok) {
    p_i = to_f(p[unit]);
    p_f = to_f(p[n + unit]);
    p_o = to_f(p[2 * n + unit]);
  }
  // The f32 carry starts from the cotangents of hT and cT.
  if (unit_ok) {
    for (int idx = tid; idx < b * kUnits; idx += kThreads) {
      const size_t ri = static_cast<size_t>(idx / kUnits) * n + unit;
      dhbuf[ri] = to_f(dhT[ri]);
      dcbuf[ri] = to_f(dcT[ri]);
    }
  }
  float acc_pi = 0.0f, acc_pf = 0.0f, acc_po = 0.0f;
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const size_t tb = static_cast<size_t>(t) * b;
    // Phase A: dz of this block's four gate columns, and dc_prev.
    if (unit_ok) {
      for (int idx = tid; idx < b * kUnits; idx += kThreads) {
        const int r = idx / kUnits;
        const size_t tr = tb + r;
        const size_t gi = tr * n4 + unit;
        const size_t oi = tr * n + unit;
        const size_t ri = static_cast<size_t>(r) * n + unit;
        const float ig = to_f(G[gi]);
        const float fg = to_f(G[gi + n]);
        const float og = to_f(G[gi + 2 * static_cast<size_t>(n)]);
        const float gg = to_f(G[gi + 3 * static_cast<size_t>(n)]);
        const float cp = to_f(cprev[oi]);
        const float m = to_f(mask[tr]);
        const float dh_next = dhbuf[ri];
        const float dc_next = dcbuf[ri];

        const float c = fg * cp + ig * gg;
        const float tc = tanhf(c);
        const float dh = m * (dh_next + to_f(dy[oi]));
        const float dzo = dh * tc * og * (1.0f - og);
        const float dc_in = m * dc_next + dh * og * (1.0f - tc * tc) +
                            dzo * p_o;
        const float dzi = dc_in * gg * ig * (1.0f - ig);
        const float dzf = dc_in * cp * fg * (1.0f - fg);
        const float dzg = dc_in * ig * (1.0f - gg * gg);

        dxz[gi] = from_f<T>(dzi);
        dxz[gi + n] = from_f<T>(dzf);
        dxz[gi + 2 * static_cast<size_t>(n)] = from_f<T>(dzo);
        dxz[gi + 3 * static_cast<size_t>(n)] = from_f<T>(dzg);
        dcbuf[ri] = dc_in * fg + dzi * p_i + dzf * p_f + (1.0f - m) * dc_next;
        acc_pi += dzi * cp;
        acc_pf += dzf * cp;
        acc_po += dzo * c;
      }
    }
    grid.sync();  // dxz[t] complete everywhere before any block reads it

    // Phase B: dh_prev[r, u] = sum_j dz_cd[r, j] * Wh[u, j] + (1-m)*dh_next
    // for this block's units, one warp per row.
    for (int r = warp; r < b; r += kWarps) {
      const T* dzr = dxz + (tb + r) * n4;
      float acc[kUnits];
#pragma unroll
      for (int q = 0; q < kUnits; ++q) acc[q] = 0.0f;
#pragma unroll 4
      for (int j = lane; j < static_cast<int>(n4); j += 32) {
        const float d = load_cg(dzr + j);
#pragma unroll
        for (int q = 0; q < kUnits; ++q)
          acc[q] = fmaf(d, to_f(W_s[q * n4 + j]), acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kUnits; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
      }
      float s = acc[0];
#pragma unroll
      for (int q = 1; q < kUnits; ++q)
        if (lane == q) s = acc[q];
      const int uu = u0 + lane;
      if (lane < kUnits && uu < n) {
        const float m = to_f(mask[tb + r]);
        const size_t ri = static_cast<size_t>(r) * n + uu;
        dhbuf[ri] = s + (1.0f - m) * dhbuf[ri];
      }
    }
    __syncthreads();  // dh_prev of this block's units before phase A reads it
  }

  if (unit_ok) {
    for (int idx = tid; idx < b * kUnits; idx += kThreads) {
      const size_t ri = static_cast<size_t>(idx / kUnits) * n + unit;
      dh0[ri] = from_f<T>(dhbuf[ri]);
      dc0[ri] = from_f<T>(dcbuf[ri]);
    }
  }
  // dp: the partial sums of the threads that share a unit, in thread order.
  dp_s[0][tid] = acc_pi;
  dp_s[1][tid] = acc_pf;
  dp_s[2][tid] = acc_po;
  __syncthreads();
  if (tid < kUnits && u0 + tid < n) {
    for (int q = 0; q < 3; ++q) {
      float s = 0.0f;
      for (int k = tid; k < kThreads; k += kUnits) s += dp_s[q][k];
      dp[static_cast<size_t>(q) * n + u0 + tid] = from_f<T>(s);
    }
  }
}

// dWh[i, j] = sum_k A[k, i] * B[k, j] with A = h_prev viewed as [K, n] and
// B = dxz viewed as [K, 4n], K = T*b. Each thread owns a 4 x 4 set of
// outputs (rows ty + 16a, columns tx + 16c) and sums k in ascending order.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
lstm_bwd_dwh_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, int K, int n) {
  __shared__ float A_s[kTileK][kTile];
  __shared__ float B_s[kTileK][kTile];
  const int n4 = 4 * n;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int idx = tid; idx < kTileK * kTile; idx += kGemmThreads) {
      const int kk = idx / kTile;
      const int col = idx % kTile;
      const int k = k0 + kk;
      const int i = i0 + col;
      const int j = j0 + col;
      A_s[kk][col] = (k < K && i < n)
                         ? to_f(A[static_cast<size_t>(k) * n + i]) : 0.0f;
      B_s[kk][col] = (k < K && j < n4)
                         ? to_f(B[static_cast<size_t>(k) * n4 + j]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = A_s[kk][ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = B_s[kk][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < n && j < n4)
        C[static_cast<size_t>(i) * n4 + j] = from_f<T>(acc[a][c]);
    }
  }
}

template <typename T>
int launch(const void* G, const void* cprev, const void* hprev,
           const void* mask, const void* Wh, const void* p, const void* dy,
           const void* dhT, const void* dcT, void* dxz, void* dh0, void* dc0,
           void* dWh, void* dp, float* dhbuf, float* dcbuf, int steps, int b,
           int n, cudaStream_t stream) {
  auto chain = lstm_bwd_chain_kernel<T>;
  const size_t smem = smem_bytes(n, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n + kUnits - 1) / kUnits;
  // Every block must be resident at once for the grid barrier.
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;

  const T* a_G = static_cast<const T*>(G);
  const T* a_cprev = static_cast<const T*>(cprev);
  const T* a_mask = static_cast<const T*>(mask);
  const T* a_Wh = static_cast<const T*>(Wh);
  const T* a_p = static_cast<const T*>(p);
  const T* a_dy = static_cast<const T*>(dy);
  const T* a_dhT = static_cast<const T*>(dhT);
  const T* a_dcT = static_cast<const T*>(dcT);
  T* a_dxz = static_cast<T*>(dxz);
  T* a_dh0 = static_cast<T*>(dh0);
  T* a_dc0 = static_cast<T*>(dc0);
  T* a_dp = static_cast<T*>(dp);
  void* args[] = {&a_G, &a_cprev, &a_mask, &a_Wh, &a_p, &a_dy, &a_dhT,
                  &a_dcT, &a_dxz, &a_dh0, &a_dc0, &a_dp, &dhbuf, &dcbuf,
                  &steps, &b, &n};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chain), blocks,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const dim3 grid((4 * n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  lstm_bwd_dwh_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(hprev), a_dxz, static_cast<T*>(dWh), steps * b,
      n);
  return cudaGetLastError();
}

// ------------------------------------------------------- cluster route
namespace lc = lstm_cluster;
using lc::bf16;

// [Wh slice][recv: C slots x 32 units x R f32][stage: 8 slots x 32 units x
// R f32, dz's K-major [R][128] bf16 at its start][barriers ready, done],
// after up to 1 KB of alignment slack. recv holds, from every rank, its
// partial of this block's 32 units (C x 32 = n rows in all); stage holds
// the partials of eight owners' units on their way out, and dz (its first
// 8 KB) while the product reads it. Rows of 32 f32 are swizzled by 16
// bytes (slot_off), so the unpadded buffers read without bank conflicts.
constexpr int kSlotBytes = lc::kUnits * lc::kRows * sizeof(float);  // 4 KB
constexpr int kStageSlots = 8;  // owners a round of the push covers
constexpr size_t cluster_smem_bytes(int n) {
  return 1024 + lc::slice_bytes(n) +
         static_cast<size_t>(lc::cluster_size(n)) * kSlotBytes +
         kStageSlots * kSlotBytes + 2 * sizeof(uint64_t);
}
static_assert(cluster_smem_bytes(lc::kMaxN) <= sm90::kMaxSmem,
              "the Wh slice and the buffers of n = 512 must fit");
static_assert(lc::rows_bytes(lc::kCols) <= kStageSlots * kSlotBytes,
              "dz shares the staging buffer");

// Byte offset of (unit ul, row r) in a slot of 32 units x R f32: 128-byte
// rows, the 16-byte chunk r / 4 at chunk (r / 4) ^ (ul % 8).
__device__ __forceinline__ uint32_t slot_off(int ul, int r) {
  return ul * (lc::kRows * 4) + ((((r >> 2) ^ (ul & 7))) << 4) + ((r & 3) << 2);
}

__global__ void __launch_bounds__(lc::kThreads, 1)
lstm_bwd_cluster_kernel(const bf16* __restrict__ G,
                        const bf16* __restrict__ cprev,
                        const bf16* __restrict__ mask,
                        const bf16* __restrict__ Wh,
                        const bf16* __restrict__ p,
                        const bf16* __restrict__ dy,
                        const bf16* __restrict__ dhT,
                        const bf16* __restrict__ dcT, bf16* __restrict__ dxz,
                        bf16* __restrict__ dh0, bf16* __restrict__ dc0,
                        float* __restrict__ dp_part, int steps, int b,
                        int n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* W_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = lc::cluster_size(n);
  unsigned char* recv = W_s + lc::slice_bytes(n);
  unsigned char* stage = recv + static_cast<size_t>(C) * kSlotBytes;
  unsigned char* dz_s = stage;
  uint64_t* ready =
      reinterpret_cast<uint64_t*>(stage + kStageSlots * kSlotBytes);
  uint64_t* done = ready + 1;

  const int q = lc::block_rank();
  const int chunk = lc::cluster_id();
  const int row0 = chunk * lc::kRows;
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31, wg = w >> 2;
  const int ww = w & 3;
  const int unit = lc::kUnits * q + l;
  const size_t n4 = 4 * static_cast<size_t>(n);

  if (tid == 0) {
    sm90::mbar_init(ready, 1);
    sm90::mbar_init(done, C);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  lc::load_slice(W_s, Wh, n, q);
  // thread (w, l) keeps item i = (row 4 w + i, unit 32 q + l): its f32
  // (dh, dc) carry, its dp sums, and its inputs a step ahead
  float dh[lc::kItems], dc[lc::kItems];
  bool ok[lc::kItems];
#pragma unroll
  for (int i = 0; i < lc::kItems; ++i) {
    const int gr = row0 + 4 * w + i;
    ok[i] = gr < b;
    const size_t ri = static_cast<size_t>(gr) * n + unit;
    dh[i] = ok[i] ? __bfloat162float(dhT[ri]) : 0.f;
    dc[i] = ok[i] ? __bfloat162float(dcT[ri]) : 0.f;
  }
  const float p_i = __bfloat162float(p[unit]);
  const float p_f = __bfloat162float(p[n + unit]);
  const float p_o = __bfloat162float(p[2 * n + unit]);
  float acc_pi = 0.f, acc_pf = 0.f, acc_po = 0.f;
  // per item: the gates i, f, o, g, c_prev, dy, mask
  uint16_t nx[lc::kItems][7];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i) {
      const size_t tr = static_cast<size_t>(t) * b + row0 + 4 * w + i;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        nx[i][g] = ok[i] ? lc::raw(G + tr * n4 + static_cast<size_t>(g) * n +
                                   unit)
                         : uint16_t(0);
      nx[i][4] = ok[i] ? lc::raw(cprev + tr * n + unit) : uint16_t(0);
      nx[i][5] = ok[i] ? lc::raw(dy + tr * n + unit) : uint16_t(0);
      nx[i][6] = ok[i] ? lc::raw(mask + tr) : uint16_t(0);
    }
  };
  fetch(steps - 1);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  lc::cluster_sync();

  const int m_tiles = n / 64;
  const uint32_t recv_u32 = sm90::smem_u32(recv);
  const uint32_t ready_u32 = sm90::smem_u32(ready);
  for (int it = 0; it < steps; ++it) {
    const int t = steps - 1 - it;
    STEP_MARK(it, 0);
    // every rank's partial of this block's 32 units x R rows, f32
    if (tid == 0)
      sm90::mbar_expect_tx(ready, static_cast<uint32_t>(C) * kSlotBytes);
    uint16_t cx[lc::kItems][7];
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i)
#pragma unroll
      for (int k = 0; k < 7; ++k) cx[i][k] = nx[i][k];
    if (t > 0) fetch(t - 1);

    // Phase A: dz of the block's 128 columns and dc, item by item
    float keep_dh[lc::kItems];  // (1 - m) dh_next, added after the sum
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i) {
      const float ig = lc::bf(cx[i][0]), fg = lc::bf(cx[i][1]);
      const float og = lc::bf(cx[i][2]), gg = lc::bf(cx[i][3]);
      const float cp = lc::bf(cx[i][4]), m = lc::bf(cx[i][6]);
      const float dh_next = dh[i], dc_next = dc[i];
      const float c = fg * cp + ig * gg;
      const float tc = lc::tanh_f(c);
      const float dhv = m * (dh_next + lc::bf(cx[i][5]));
      const float dzo = dhv * tc * og * (1.0f - og);
      const float dc_in = m * dc_next + dhv * og * (1.0f - tc * tc) + dzo * p_o;
      const float dzi = dc_in * gg * ig * (1.0f - ig);
      const float dzf = dc_in * cp * fg * (1.0f - fg);
      const float dzg = dc_in * ig * (1.0f - gg * gg);
      const bf16 bz[4] = {__float2bfloat16(dzi), __float2bfloat16(dzf),
                          __float2bfloat16(dzo), __float2bfloat16(dzg)};
      const int r = 4 * w + i;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<bf16*>(dz_s + lc::kmajor_off(r, lc::kUnits * g + l)) =
            bz[g];
      if (ok[i]) {
        const size_t gi = (static_cast<size_t>(t) * b + row0 + r) * n4 + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dxz[gi + static_cast<size_t>(g) * n] = bz[g];
      }
      dc[i] = dc_in * fg + dzi * p_i + dzf * p_f + (1.0f - m) * dc_next;
      keep_dh[i] = (1.0f - m) * dh_next;
      acc_pi += dzi * cp;
      acc_pf += dzf * cp;
      acc_po += dzo * c;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // every block has read what this block pushed at the last step
    STEP_MARK(it, 1);  // phase A
    if (it > 0) lc::wait_cluster(done, (it - 1) & 1);
    STEP_MARK(it, 2);  // the wait for the last step's readers
    __syncwarp();  // wgmma is .aligned: the warp issues it together

    // P[u][r] = sum over the block's columns j of Wh[u][j] dz[r][j], for
    // all n units: A = the slice (K-major, k block = region), B = dz
    float acc[4][16];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[k][j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) sm90::fence_operands(acc[k]);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int mu = wg + 2 * k;
      if (mu >= m_tiles) break;
#pragma unroll
      for (int s = 0; s < lc::kCols / 16; ++s) {
        const uint64_t da = sm90::smem_desc(
            W_s + (s >> 2) * static_cast<size_t>(n) * 128 + mu * 8192 +
                32 * (s & 3),
            16, 1024);
        const uint64_t db = sm90::smem_desc(
            dz_s + (s >> 2) * (lc::kRows * 128) + 32 * (s & 3), 16, 1024);
        lc::wgmma_m64n32k16<0, 0>(acc[k], da, db);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 4; ++k) sm90::fence_operands(acc[k]);
    STEP_MARK(it, 3);  // the product
    __syncthreads();  // both warpgroups' products have read dz

    // The push, in two rounds of eight owners (256 units): the tiles of the
    // round go to stage, slot o % 8 for owner o = u / 32, then one bulk
    // copy a slot carries its 4 KB into slot q of the owner's recv,
    // counted on the owner's `ready` barrier.
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if (256 * round >= n) break;
      if (round > 0) {
        if (tid < kStageSlots) sm90::bulk_wait_read();
        __syncthreads();  // the last round's copies have read stage
      }
#pragma unroll
      for (int k = 2 * round; k < 2 * round + 2; ++k) {
        const int mu = wg + 2 * k;
        if (mu >= m_tiles) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 64 * mu + 16 * ww + (l >> 2) + 8 * h;
          unsigned char* slot =
              stage + ((u / lc::kUnits) % kStageSlots) * kSlotBytes;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 8 * j + 2 * (l & 3);
            *reinterpret_cast<float2*>(slot + slot_off(u % lc::kUnits, r)) =
                make_float2(acc[k][4 * j + 2 * h], acc[k][4 * j + 2 * h + 1]);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      const int owner = kStageSlots * round + tid;
      if (tid < kStageSlots && owner < C) {
        lc::bulk_to(lc::remote(recv_u32 + q * kSlotBytes, owner),
                sm90::smem_u32(stage + tid * kSlotBytes), kSlotBytes,
                lc::remote(ready_u32, owner));
        sm90::bulk_commit();
      }
    }
    STEP_MARK(it, 4);  // the partials staged, the copies issued
    lc::wait_cluster(ready, it & 1);
    STEP_MARK(it, 5);  // the wait for every rank's partial

    // the reduce-scatter's sum: this block's rows from ranks 0 .. C-1, in
    // rank order, columns 4 w .. 4 w + 3
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < C; ++d) {
      const float4 v = *reinterpret_cast<const float4*>(
          recv + d * kSlotBytes + slot_off(l, 4 * w));
      s4[0] += v.x;
      s4[1] += v.y;
      s4[2] += v.z;
      s4[3] += v.w;
    }
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i) dh[i] = s4[i] + keep_dh[i];
    // stage is free for the next step's dz once the copies have read it
    if (tid < kStageSlots) sm90::bulk_wait_read();
    __syncthreads();
    STEP_MARK(it, 6);  // the sum
    lc::signal_all(done, C);
  }

#pragma unroll
  for (int i = 0; i < lc::kItems; ++i) {
    if (!ok[i]) continue;
    const size_t ri = static_cast<size_t>(row0 + 4 * w + i) * n + unit;
    dh0[ri] = __float2bfloat16(dh[i]);
    dc0[ri] = __float2bfloat16(dc[i]);
  }
  // dp of the cluster's rows: each thread's sums over its rows and steps,
  // then the eight warps in order, into dp_part[chunk][3][n]. stage is
  // free here (its last copies were read before the last barrier).
  float* dp_s = reinterpret_cast<float*>(stage);
  dp_s[(0 * 8 + w) * 32 + l] = acc_pi;
  dp_s[(1 * 8 + w) * 32 + l] = acc_pf;
  dp_s[(2 * 8 + w) * 32 + l] = acc_po;
  __syncthreads();
  if (w < 3) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += dp_s[(w * 8 + k) * 32 + l];
    dp_part[(static_cast<size_t>(chunk) * 3 + w) * n + unit] = s;
  }
  lc::cluster_sync();
}

// dp = the clusters' partials summed in chunk order, rounded to bf16.
__global__ void lstm_bwd_dp_sum(const float* __restrict__ part,
                                bf16* __restrict__ dp, int chunks, int n3) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n3) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[static_cast<size_t>(c) * n3 + i];
  dp[i] = __float2bfloat16(s);
}

// dWh = h_prev^T dxz on sm90_gemm.cuh's mainloop (both MN-major, as K7's
// dW = x^T dz): the f32 tile rounded to bf16 and stored, four columns a
// lane.
struct DwhEpi {
  bf16* out;
  int rows, cols;
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
        if (row < rows && c < cols) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 raw;
          raw.x = *reinterpret_cast<const uint32_t*>(&lo);
          raw.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * cols +
                                    c) = raw;
        }
      }
    }
  }
};

int launch_cluster(const void* G, const void* cprev, const void* hprev,
                   const void* mask, const void* Wh, const void* p,
                   const void* dy, const void* dhT, const void* dcT,
                   void* dxz, void* dh0, void* dc0, void* dWh, void* dp,
                   float* dp_part, int steps, int b, int n,
                   cudaStream_t stream) {
  const int chunks = (b + lc::kRows - 1) / lc::kRows;
  int e = lc::launch_clusters(
      lstm_bwd_cluster_kernel, lc::cluster_size(n), chunks,
      cluster_smem_bytes(n), stream, static_cast<const bf16*>(G),
      static_cast<const bf16*>(cprev), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(Wh), static_cast<const bf16*>(p),
      static_cast<const bf16*>(dy), static_cast<const bf16*>(dhT),
      static_cast<const bf16*>(dcT), static_cast<bf16*>(dxz),
      static_cast<bf16*>(dh0), static_cast<bf16*>(dc0), dp_part, steps, b, n);
  if (e != 0) return e;
  const int n3 = 3 * n;
  lstm_bwd_dp_sum<<<(n3 + 255) / 256, 256, 0, stream>>>(
      dp_part, static_cast<bf16*>(dp), chunks, n3);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return ce;
  // dWh [n, 4n] = h_prev^T dxz over K = T b rows: A(i, k) = h_prev[k][i],
  // B(k, j) = dxz[k][j], both MN-major, one chunk of the whole reduction
  CUtensorMap mh, mdz;
  const int K = steps * b;
  ce = sm90::make_map(&mh, hprev, K, n);
  if (ce == cudaSuccess) ce = sm90::make_map(&mdz, dxz, K, 4 * n);
  if (ce != cudaSuccess) return ce;
  return sm90::launch<false, false>(
      mh, mdz, n, 4 * n, K, K, 1, DwhEpi{static_cast<bf16*>(dWh), n, 4 * n},
      stream);
}

}  // namespace

STEP_MARKS_ENTRY(dl4j_lstm_bwd_step_marks)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, in the layouts
// of deeplearning4j_tpu_torch/ops/lstm.py: residuals G [T,b,4n] and
// hprev/cprev [T,b,n]; mask [T,b]; Wh [n,4n]; p [3,n]; cotangents dy
// [T,b,n] and dhT/dcT [b,n], all in the compute dtype. Outputs dxz
// [T,b,4n], dh0/dc0 [b,n], dWh [n,4n], dp [3,n] in the compute dtype.
// dhbuf and dcbuf [b,n] are f32 scratch. Returns a cudaError_t (0 on
// success).
int dl4j_lstm_bwd(int dtype, const void* G, const void* cprev,
                  const void* hprev, const void* mask, const void* Wh,
                  const void* p, const void* dy, const void* dhT,
                  const void* dcT, void* dxz, void* dh0, void* dc0, void* dWh,
                  void* dp, void* dhbuf, void* dcbuf, int steps, int b, int n,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto hb = static_cast<float*>(dhbuf);
  auto cb = static_cast<float*>(dcbuf);
  if (dtype == 0)
    return launch<float>(G, cprev, hprev, mask, Wh, p, dy, dhT, dcT, dxz,
                         dh0, dc0, dWh, dp, hb, cb, steps, b, n, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(G, cprev, hprev, mask, Wh, p, dy, dhT, dcT,
                                 dxz, dh0, dc0, dWh, dp, hb, cb, steps, b, n,
                                 s);
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one chain block needs for hidden size n.
int dl4j_lstm_bwd_smem_bytes(int dtype, int n) {
  return static_cast<int>(
      smem_bytes(n, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16)));
}

// The cluster route: bf16 only, n a multiple of 64 in [64, 512]; the same
// layouts and outputs as dl4j_lstm_bwd. dp_part is f32 scratch of
// [ceil(b / 32), 3, n]. Three launches: the chain, the sum of dp's
// partials, dWh. Returns a cudaError_t, or -1 when not one cluster of
// n / 32 blocks fits on the card.
int dl4j_lstm_bwd_sm90(const void* G, const void* cprev, const void* hprev,
                       const void* mask, const void* Wh, const void* p,
                       const void* dy, const void* dhT, const void* dcT,
                       void* dxz, void* dh0, void* dc0, void* dWh, void* dp,
                       void* dp_part, int steps, int b, int n, void* stream) {
  if (n % 64 != 0 || n < 64 || n > lc::kMaxN || steps < 1 || b < 1)
    return cudaErrorInvalidValue;
  return launch_cluster(G, cprev, hprev, mask, Wh, p, dy, dhT, dcT, dxz, dh0,
                        dc0, dWh, dp, static_cast<float*>(dp_part), steps, b,
                        n, static_cast<cudaStream_t>(stream));
}

int dl4j_lstm_bwd_sm90_smem_bytes(int n) {
  return static_cast<int>(cluster_smem_bytes(n));
}

// Clusters of the cluster chain for hidden size n that fit on the card at
// once (0: none; -1: the query failed).
int dl4j_lstm_bwd_sm90_clusters(int n) {
  return lc::active_clusters(lstm_bwd_cluster_kernel, lc::cluster_size(n),
                             cluster_smem_bytes(n));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
