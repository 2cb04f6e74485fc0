// Whole-sequence Graves LSTM forward for Hopper (sm_90a), one launch per
// sequence.
//
// Replaces deeplearning4j_tpu/ops/lstm.py::_fwd_kernel (the Pallas TPU
// kernel behind _fwd_call) and computes the same function with the same
// numerics: peepholes, gate order i, f, o, g; sigmoid gates and tanh cell;
// an f32 (h, c) carry; h_prev rounded to the compute dtype before the
// product with Wh; products accumulated in f32; gates in f32; outputs
// rounded to the compute dtype. On a step whose mask is <= 0 the carry
// keeps its previous value and the output is h * m.
//
// What bounds it: the T steps form a serial chain. Step t needs all of
// h[t-1], which every block contributes to, so the card can never run
// more than one step at a time. The work of one step at the serving
// shape (b = 32, n = 512) is only 2*b*n*4n = 67 MFLOP and ~0.2 MB, far
// below a microsecond at the card's FLOP and byte rates, so the floor
// that counts is T times (one grid-wide barrier + the latency of one
// step's dependent loads and FMAs), not FLOPs or bytes.
//
// What the design does about it: one persistent cooperative grid walks
// the whole sequence, so the chain costs one grid barrier per step and
// no kernel launch per step. Each block owns U hidden units and all four
// gate columns of them (u, n+u, 2n+u, 3n+u), so the cell update of its
// units is block-local: c never leaves the block's threads and only h is
// exchanged, through a double-buffered f32 global buffer indexed by t % 2.
// The block's n x 4U slice of Wh is loaded into shared memory once and
// read from there at every step. The product is plain FMA from shared
// memory; wgmma/TMA are later work.
//
// Each output element's reduction runs over k = 0..n-1 in order in one
// thread, whatever b is, so a row's result does not depend on the batch
// it was served in.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;                  // hidden units per block (U)
constexpr int kCols = 4 * kUnits;          // gate columns per block = lanes
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // batch rows per staged chunk
constexpr int kThreads = kWarps * 32;
static_assert(kCols == 32, "one warp lane per gate column");

// Wh slice [n][kCols] plus one staged chunk of h_prev [kRows][n].
inline size_t smem_bytes(int n, size_t elem) {
  return (static_cast<size_t>(n) * kCols + static_cast<size_t>(kRows) * n) *
         elem;
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

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ xz, const T* __restrict__ mask,
                const T* __restrict__ h0, const T* __restrict__ c0,
                const T* __restrict__ Wh, const T* __restrict__ p,
                T* __restrict__ y, T* __restrict__ hT, T* __restrict__ cT,
                T* __restrict__ G, T* __restrict__ hprev,
                T* __restrict__ cprev, float* hbuf, float* cbuf, int steps,
                int b, int n, int save) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W_s = reinterpret_cast<T*>(smem_raw);    // [n][kCols]
  T* h_s = W_s + static_cast<size_t>(n) * kCols;  // [kRows][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int u0 = blockIdx.x * kUnits;
  const int gate = lane / kUnits;
  const int u = lane % kUnits;
  const int unit = u0 + u;
  const bool unit_ok = unit < n;
  const size_t n4 = 4 * static_cast<size_t>(n);
  const size_t col = static_cast<size_t>(gate) * n + unit;
  const size_t bn = static_cast<size_t>(b) * n;

  // This block's Wh columns, loaded once for the whole sequence.
  for (int idx = tid; idx < n * kCols; idx += kThreads) {
    const int k = idx / kCols;
    const int j = idx % kCols;
    const int uu = u0 + j % kUnits;
    W_s[idx] = uu < n ? Wh[k * n4 + static_cast<size_t>(j / kUnits) * n + uu]
                      : from_f<T>(0.0f);
  }
  float p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  if (unit_ok) {
    p_i = to_f(p[unit]);
    p_f = to_f(p[n + unit]);
    p_o = to_f(p[2 * n + unit]);
  }
  // The f32 carry starts from h0/c0; each block writes its own units.
  for (int idx = tid; idx < b * kUnits; idx += kThreads) {
    const int r = idx / kUnits;
    const int uu = u0 + idx % kUnits;
    if (uu < n) {
      const size_t i = static_cast<size_t>(r) * n + uu;
      hbuf[i] = to_f(h0[i]);
      cbuf[i] = to_f(c0[i]);
    }
  }
  grid.sync();

  for (int t = 0; t < steps; ++t) {
    const float* hcur = hbuf + static_cast<size_t>(t & 1) * bn;
    float* hnxt = hbuf + static_cast<size_t>((t + 1) & 1) * bn;
    for (int r0 = 0; r0 < b; r0 += kRows) {
      // Stage h_prev rows [r0, r0 + kRows), rounded to the compute dtype.
      // __ldcg reads through L2: other SMs wrote these values.
      for (int idx = tid; idx < kRows * n; idx += kThreads) {
        const int r = r0 + idx / n;
        h_s[idx] = r < b ? from_f<T>(__ldcg(hcur + static_cast<size_t>(r0) * n + idx))
                         : from_f<T>(0.0f);
      }
      __syncthreads();

      float acc[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;
      const T* hrow = h_s + static_cast<size_t>(warp) * kRowsPerWarp * n;
      for (int k = 0; k < n; ++k) {
        const float w = to_f(W_s[k * kCols + lane]);
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q)
          acc[q] = fmaf(to_f(hrow[q * n + k]), w, acc[q]);
      }

#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int r = r0 + warp * kRowsPerWarp + q;
        const bool row_ok = r < b;
        const size_t tr = static_cast<size_t>(t) * b + r;
        float z = 0.0f;
        if (row_ok && unit_ok) z = to_f(xz[tr * n4 + col]) + acc[q];
        // Lanes u, U+u, 2U+u, 3U+u hold the four gates of unit u0+u.
        const float zi = __shfl_sync(0xffffffffu, z, u);
        const float zf = __shfl_sync(0xffffffffu, z, kUnits + u);
        const float zo = __shfl_sync(0xffffffffu, z, 2 * kUnits + u);
        const float zg = __shfl_sync(0xffffffffu, z, 3 * kUnits + u);
        if (lane < kUnits && row_ok && unit_ok) {
          const size_t ri = static_cast<size_t>(r) * n + unit;
          const float c_prev = cbuf[ri];
          const float h_prev = __ldcg(hcur + ri);
          const float ig = sigmoid_f(zi + p_i * c_prev);
          const float fg = sigmoid_f(zf + p_f * c_prev);
          const float gg = tanhf(zg);
          const float c = fg * c_prev + ig * gg;
          const float og = sigmoid_f(zo + p_o * c);
          const float h = og * tanhf(c);
          const float m = to_f(mask[tr]);
          const bool keep = m > 0.0f;
          const float hk = keep ? h : h_prev;
          const float ck = keep ? c : c_prev;
          const size_t oi = tr * n + unit;
          y[oi] = from_f<T>(h * m);
          hnxt[ri] = hk;
          cbuf[ri] = ck;
          if (save) {
            const size_t gi = tr * n4 + unit;
            G[gi] = from_f<T>(ig);
            G[gi + n] = from_f<T>(fg);
            G[gi + 2 * static_cast<size_t>(n)] = from_f<T>(og);
            G[gi + 3 * static_cast<size_t>(n)] = from_f<T>(gg);
            hprev[oi] = from_f<T>(h_prev);
            cprev[oi] = from_f<T>(c_prev);
          }
          if (t == steps - 1) {
            hT[ri] = from_f<T>(hk);
            cT[ri] = from_f<T>(ck);
          }
        }
      }
      __syncthreads();  // h_s is restaged for the next chunk of rows
    }
    grid.sync();  // h[t] complete everywhere before step t+1 reads it
  }
}

template <typename T>
int launch(const void* xz, const void* mask, const void* h0, const void* c0,
           const void* Wh, const void* p, void* y, void* hT, void* cT,
           void* G, void* hprev, void* cprev, float* hbuf, float* cbuf,
           int steps, int b, int n, int save, cudaStream_t stream) {
  auto kern = lstm_fwd_kernel<T>;
  const size_t smem = smem_bytes(n, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n + kUnits - 1) / kUnits;
  // Every block must be resident at once for the grid barrier.
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;

  const T* a_xz = static_cast<const T*>(xz);
  const T* a_mask = static_cast<const T*>(mask);
  const T* a_h0 = static_cast<const T*>(h0);
  const T* a_c0 = static_cast<const T*>(c0);
  const T* a_Wh = static_cast<const T*>(Wh);
  const T* a_p = static_cast<const T*>(p);
  T* a_y = static_cast<T*>(y);
  T* a_hT = static_cast<T*>(hT);
  T* a_cT = static_cast<T*>(cT);
  T* a_G = static_cast<T*>(G);
  T* a_hprev = static_cast<T*>(hprev);
  T* a_cprev = static_cast<T*>(cprev);
  void* args[] = {&a_xz, &a_mask, &a_h0, &a_c0, &a_Wh, &a_p,
                  &a_y, &a_hT, &a_cT, &a_G, &a_hprev, &a_cprev,
                  &hbuf, &cbuf, &steps, &b, &n, &save};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), blocks,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, in the layouts
// of deeplearning4j_tpu_torch/ops/lstm.py: xz [T,b,4n], mask [T,b],
// h0/c0 [b,n], Wh [n,4n], p [3,n]; outputs y [T,b,n], hT/cT [b,n] and,
// when save != 0, G [T,b,4n], hprev/cprev [T,b,n]. hbuf [2,b,n] and
// cbuf [b,n] are f32 scratch. Returns a cudaError_t (0 on success).
int dl4j_lstm_fwd(int dtype, const void* xz, const void* mask,
                  const void* h0, const void* c0, const void* Wh,
                  const void* p, void* y, void* hT, void* cT, void* G,
                  void* hprev, void* cprev, void* hbuf, void* cbuf,
                  int steps, int b, int n, int save, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto hb = static_cast<float*>(hbuf);
  auto cb = static_cast<float*>(cbuf);
  if (dtype == 0)
    return launch<float>(xz, mask, h0, c0, Wh, p, y, hT, cT, G, hprev, cprev,
                         hb, cb, steps, b, n, save, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xz, mask, h0, c0, Wh, p, y, hT, cT, G,
                                 hprev, cprev, hb, cb, steps, b, n, save, s);
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block needs for hidden size n.
int dl4j_lstm_fwd_smem_bytes(int dtype, int n) {
  return static_cast<int>(
      smem_bytes(n, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16)));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
