// Whole-sequence Graves LSTM backward for Hopper (sm_90a): two launches per
// sequence, the reverse-time chain and then the recurrent weight gradient.
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
// grid-wide barrier + one step's dependent loads and FMAs), not FLOPs or
// bytes.
//
// What the design does about it:
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

}  // namespace

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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
