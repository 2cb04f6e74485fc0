// Whole-sequence Graves LSTM forward for Hopper (sm_90a), one launch per
// sequence, on one of two routes (chosen in ops/lstm.py::takes_cluster by
// dtype and n only):
// - bf16 with n a multiple of 64 up to 512: lstm_fwd_cluster_kernel, a
//   thread-block cluster per 32 batch rows, Wh resident in the cluster's
//   shared memory, h exchanged through DSMEM, the step's product on wgmma;
// - f32, and any other n: lstm_fwd_kernel, the first design, a persistent
//   cooperative grid.
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
// that counts is T times (one barrier + the latency of one step's
// dependent product, cell update and exchange), not FLOPs or bytes.
//
// The cluster route (see lstm_cluster.cuh for the ownership and layouts):
// block rank q of a cluster of n / 32 blocks owns units 32 q .. 32 q + 31
// and their four gate columns, and keeps Wh[:, those 128 columns] (128 KB
// bf16 at n = 512) in shared memory for the whole sequence, as the TPU
// kernel keeps Wh in VMEM. Each step:
// - z^T[128 columns][R = 32 rows] = Wh_slice^T h^T on wgmma m64n32k16,
//   one m64 tile per warpgroup, K = n in k16 steps, f32 sums, from the
//   block's own copy of h[t-1] (bf16, K-major, 64-byte swizzle) in shared
//   memory;
// - z goes through shared memory so that one thread holds a unit's four
//   gates, for four rows; the f32 cell update and mask rule are the first
//   kernel's, the (h, c) carry of the thread's items stays in registers;
// - the new h, rounded to bf16, is staged as the block's k block (R rows x
//   32 units, 2 KB) and copied into the other h buffer of every block of
//   the cluster through DSMEM, one bulk copy a block, counted in bytes on
//   that block's mbarrier for the buffer; a block waits on its own
//   (acquire; a trap after ~5 s) until all n units of its R rows have
//   arrived. A block pushes step t + 1's h only after its own wait of step
//   t, which needs every block's copies of step t, each issued after that
//   block's product had read the buffer: so the double buffer and that one
//   wait a step order every write after the last read of the buffer;
// - xz[t + 1] and mask[t + 1] of the thread's items are loaded into
//   registers a step ahead: they do not depend on the chain.
// Clusters are independent (one per 32 rows, the last padded with zero
// rows that stay zero), so any b runs, in waves where the card holds fewer
// clusters at once.
//
// Each output element's reduction runs over k = 0..n-1 in one fixed order
// (the first kernel: in one thread; the cluster: wgmma's k16 steps in
// turn) and on its row's h alone, so a row's result does not depend on the
// batch it was served in.
//
// Shared memory of a cluster block at n = 512: Wh slice 128 KB, two h
// buffers 2 x 32 KB, its own k block 2 KB, z 18 KB (f32, rows padded to
// 36), two barriers and 1 KB of alignment slack: 213 KB of the 227 KB
// (static_assert below).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------- grid route
// One persistent cooperative grid walks the whole sequence, one grid
// barrier per step. Each block owns U hidden units and all four gate
// columns of them, so the cell update of its units is block-local; h is
// exchanged through a double-buffered f32 global buffer indexed by t % 2,
// read back through L2. The block's n x 4U slice of Wh sits in shared
// memory; the product is scalar FMA from shared memory.

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

// ------------------------------------------------------- cluster route
namespace lc = lstm_cluster;
using lc::bf16;

// [Wh slice][h buffers 0 and 1][own h: R x 32 bf16, the block's k block
// on its way out][z: 128 x kStride f32][barriers 0 and 1],
// after up to 1 KB of slack that aligns the slice (and so every swizzle
// atom) to 1 KB.
constexpr size_t cluster_smem_bytes(int n) {
  return 1024 + lc::slice_bytes(n) + 2 * lc::rows_bytes(n) +
         lc::rows_bytes(lc::kUnits) +
         static_cast<size_t>(lc::kCols) * lc::kStride * sizeof(float) +
         2 * sizeof(uint64_t);
}
static_assert(cluster_smem_bytes(lc::kMaxN) <= sm90::kMaxSmem,
              "the Wh slice and the buffers of n = 512 must fit");

__global__ void __launch_bounds__(lc::kThreads, 1)
lstm_fwd_cluster_kernel(const bf16* __restrict__ xz,
                        const bf16* __restrict__ mask,
                        const bf16* __restrict__ h0,
                        const bf16* __restrict__ c0,
                        const bf16* __restrict__ Wh,
                        const bf16* __restrict__ p, bf16* __restrict__ y,
                        bf16* __restrict__ hT, bf16* __restrict__ cT,
                        bf16* __restrict__ G, bf16* __restrict__ hprev,
                        bf16* __restrict__ cprev, int steps, int b, int n,
                        int save) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* W_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* h_s = W_s + lc::slice_bytes(n);
  unsigned char* own = h_s + 2 * lc::rows_bytes(n);
  float* z_s = reinterpret_cast<float*>(own + lc::rows_bytes(lc::kUnits));
  uint64_t* full = reinterpret_cast<uint64_t*>(z_s + lc::kCols * lc::kStride);

  const int C = lc::cluster_size(n);
  const int q = lc::block_rank();
  const int row0 = lc::cluster_id() * lc::kRows;
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31, wg = w >> 2;
  const int unit = lc::kUnits * q + l;
  const size_t n4 = 4 * static_cast<size_t>(n);

  if (tid == 0) {
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  lc::load_slice(W_s, Wh, n, q);
  // h0 of the cluster's rows into buffer 0 (rows past b are zero)
  for (int idx = tid; idx < lc::kRows * (n / 8); idx += lc::kThreads) {
    const int r = idx / (n / 8), k = (idx % (n / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < b)
      v = *reinterpret_cast<const uint4*>(
          h0 + static_cast<size_t>(row0 + r) * n + k);
    *reinterpret_cast<uint4*>(h_s + lc::kmajor64_off(r, k)) = v;
  }
  // thread (w, l) keeps item i = (row 4 w + i, unit 32 q + l): its f32
  // carry, and its xz and mask a step ahead
  float hc[lc::kItems], cc[lc::kItems];
  bool ok[lc::kItems];
#pragma unroll
  for (int i = 0; i < lc::kItems; ++i) {
    const int gr = row0 + 4 * w + i;
    ok[i] = gr < b;
    const size_t ri = static_cast<size_t>(gr) * n + unit;
    hc[i] = ok[i] ? __bfloat162float(h0[ri]) : 0.f;
    cc[i] = ok[i] ? __bfloat162float(c0[ri]) : 0.f;
  }
  const float p_i = __bfloat162float(p[unit]);
  const float p_f = __bfloat162float(p[n + unit]);
  const float p_o = __bfloat162float(p[2 * n + unit]);
  uint16_t nx[lc::kItems][4], nm[lc::kItems];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i) {
      const size_t tr = static_cast<size_t>(t) * b + row0 + 4 * w + i;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        nx[i][g] = ok[i] ? lc::raw(xz + tr * n4 + static_cast<size_t>(g) * n +
                                   unit)
                         : uint16_t(0);
      nm[i] = ok[i] ? lc::raw(mask + tr) : uint16_t(0);
    }
  };
  fetch(0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  lc::cluster_sync();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    STEP_MARK(t, 0);
    // this step's pushes fill buffer cur ^ 1: R rows of all n units
    if (tid == 0 && t + 1 < steps)
      sm90::mbar_expect_tx(&full[cur ^ 1],
                           static_cast<uint32_t>(lc::rows_bytes(n)));
    uint16_t cx[lc::kItems][4], cm[lc::kItems];
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i) {
      cm[i] = nm[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) cx[i][g] = nx[i][g];
    }
    if (t + 1 < steps) fetch(t + 1);

    // z^T of this warpgroup's 64 columns: A = the slice's region wg
    // (MN-major), B = h[t-1] (K-major, 64-byte swizzle)
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    const unsigned char* A = W_s + static_cast<size_t>(wg) * n * 128;
    const unsigned char* B = h_s + cur * lc::rows_bytes(n);
    __syncwarp();  // wgmma is .aligned: the warp issues it together
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
#pragma unroll 4
    for (int s = 0; s < n / 16; ++s) {
      const uint64_t da = sm90::smem_desc(A + 2048 * s, sm90::kBoxBytes, 1024);
      const uint64_t db =
          lc::smem_desc64(B + (s >> 1) * (lc::kRows * 64) + 32 * (s & 1));
      lc::wgmma_m64n32k16<1, 0>(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    STEP_MARK(t, 1);  // the product
    sm90::fence_operands(acc);
    lc::store_frag(z_s, 64 * wg, acc);
    if (tid < C) sm90::bulk_wait_read();  // the last step's copies read own
    __syncthreads();

    STEP_MARK(t, 2);  // z through shared memory
    // the cell update of the thread's four rows of unit 32 q + l
    float z[4][lc::kItems];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          z_s + (lc::kUnits * g + l) * lc::kStride + 4 * w);
      z[g][0] = v.x;
      z[g][1] = v.y;
      z[g][2] = v.z;
      z[g][3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i) {
      const float c_prev = cc[i], h_prev = hc[i];
      const float ig = lc::sigmoid_f(lc::bf(cx[i][0]) + z[0][i] + p_i * c_prev);
      const float fg = lc::sigmoid_f(lc::bf(cx[i][1]) + z[1][i] + p_f * c_prev);
      const float gg = lc::tanh_f(lc::bf(cx[i][3]) + z[3][i]);
      const float c = fg * c_prev + ig * gg;
      const float og = lc::sigmoid_f(lc::bf(cx[i][2]) + z[2][i] + p_o * c);
      const float h = og * lc::tanh_f(c);
      const float m = lc::bf(cm[i]);
      const bool keep = m > 0.0f;
      if (ok[i]) {
        const size_t tr = static_cast<size_t>(t) * b + row0 + 4 * w + i;
        const size_t oi = tr * n + unit;
        y[oi] = __float2bfloat16(h * m);
        if (save) {
          const size_t gi = tr * n4 + unit;
          G[gi] = __float2bfloat16(ig);
          G[gi + n] = __float2bfloat16(fg);
          G[gi + 2 * static_cast<size_t>(n)] = __float2bfloat16(og);
          G[gi + 3 * static_cast<size_t>(n)] = __float2bfloat16(gg);
          hprev[oi] = __float2bfloat16(h_prev);
          cprev[oi] = __float2bfloat16(c_prev);
        }
      }
      hc[i] = keep ? h : h_prev;
      cc[i] = keep ? c : c_prev;
    }
    STEP_MARK(t, 3);  // the cell update
    if (t + 1 == steps) break;

    // h[t] in bf16 into buffer cur ^ 1 of every block: the block's k
    // block (its R rows x 32 units, 2 KB) is staged, then thread d copies
    // it into block d's buffer (cp.async.bulk), counted on d's barrier
#pragma unroll
    for (int i = 0; i < lc::kItems; ++i)
      *reinterpret_cast<bf16*>(own + lc::kmajor64_off(4 * w + i, l)) =
          __float2bfloat16(hc[i]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid < C) {
      const uint32_t dst = sm90::smem_u32(h_s + (cur ^ 1) * lc::rows_bytes(n) +
                                          q * lc::rows_bytes(lc::kUnits));
      lc::bulk_to(lc::remote(dst, tid), sm90::smem_u32(own),
                  static_cast<uint32_t>(lc::rows_bytes(lc::kUnits)),
                  lc::remote(sm90::smem_u32(&full[cur ^ 1]), tid));
      sm90::bulk_commit();
    }
    STEP_MARK(t, 4);  // h staged, the copies issued
    lc::wait_cluster(&full[cur ^ 1], (t >> 1) & 1);
    STEP_MARK(t, 5);  // the wait for every block's h
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < lc::kItems; ++i) {
    if (!ok[i]) continue;
    const size_t ri = static_cast<size_t>(row0 + 4 * w + i) * n + unit;
    hT[ri] = __float2bfloat16(hc[i]);
    cT[ri] = __float2bfloat16(cc[i]);
  }
  lc::cluster_sync();
}

}  // namespace

STEP_MARKS_ENTRY(dl4j_lstm_fwd_step_marks)

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

// The cluster route: bf16 only, n a multiple of 64 in [64, 512]; the same
// layouts and outputs as dl4j_lstm_fwd, no scratch. Returns a cudaError_t,
// or -1 when not one cluster of n / 32 blocks fits on the card.
int dl4j_lstm_fwd_sm90(const void* xz, const void* mask, const void* h0,
                       const void* c0, const void* Wh, const void* p, void* y,
                       void* hT, void* cT, void* G, void* hprev, void* cprev,
                       int steps, int b, int n, int save, void* stream) {
  if (n % 64 != 0 || n < 64 || n > lc::kMaxN || steps < 1 || b < 1)
    return cudaErrorInvalidValue;
  return lc::launch_clusters(
      lstm_fwd_cluster_kernel, lc::cluster_size(n),
      (b + lc::kRows - 1) / lc::kRows, cluster_smem_bytes(n),
      static_cast<cudaStream_t>(stream), static_cast<const bf16*>(xz),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(h0),
      static_cast<const bf16*>(c0), static_cast<const bf16*>(Wh),
      static_cast<const bf16*>(p), static_cast<bf16*>(y),
      static_cast<bf16*>(hT), static_cast<bf16*>(cT), static_cast<bf16*>(G),
      static_cast<bf16*>(hprev), static_cast<bf16*>(cprev), steps, b, n,
      save);
}

int dl4j_lstm_fwd_sm90_smem_bytes(int n) {
  return static_cast<int>(cluster_smem_bytes(n));
}

// Clusters of the cluster route for hidden size n that fit on the card at
// once (0: none; -1: the query failed).
int dl4j_lstm_fwd_sm90_clusters(int n) {
  return lc::active_clusters(lstm_fwd_cluster_kernel, lc::cluster_size(n),
                             cluster_smem_bytes(n));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
