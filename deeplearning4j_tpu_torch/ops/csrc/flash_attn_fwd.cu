// Causal multi-head attention forward for Hopper (sm_90a), flash style.
//
// Replaces deeplearning4j_tpu/ops/attention.py::_flash_kernel (the Pallas
// TPU kernel behind _flash_fwd_impl) and computes the same function:
// q, k, v [b, T, h, dh] -> out [b, T, h, dh]; per (batch, head) and block
// of query rows, an online softmax over key tiles with the running max m,
// the running sum l and the accumulator acc in f32. Per tile: s = (q . k)
// in f32 from the inputs, times the scale 1/sqrt(dh) (applied to s, not to
// q); s = -0.7 * FLT_MAX where col > row or col >= T (the finite mask
// value of the Pallas kernel, so a row's running max is always a real
// score: the first tile holds column 0); m_new = max(m, rowmax(s));
// alpha = exp(m - m_new); p = exp(s - m_new); l = alpha * l + rowsum(p)
// with p in f32; p is rounded to the compute dtype before the product
// with v, acc = alpha * acc + p . v in f32. At the end out = acc / l,
// rounded to the compute dtype. Tiles above the diagonal are skipped.
//
// What bounds it: at the served and trained shape (b = 32, T = 256, h = 4,
// dh = 64, bf16) the function reads q, k, v and writes out, 16.8 MB, ~5.0
// us at 3.35 TB/s, against ~1.07 GFLOP of causal products, ~1.1 us at the
// bf16 tensor-core rate: bytes bound it. The [T, T] score matrix never
// reaches device memory.
//
// Four kernels (the wrapper, ops/attention.py, decides): by dtype for dh
// 64 and 128, and by dtype for every other dh % 128 == 0 (see "wide head
// sizes" below: the FMA wide kernel for f32, flash_fwd_wide_kernel_sm90
// for bf16):
//
// bf16: flash_fwd_kernel_sm90 (dl4j_flash_attn_fwd_sm90), on the tensor
// cores. A block owns 64 query rows of one (batch, head): one producer
// warp and one consumer warpgroup (160 threads).
// - Loads: TMA, through one 4-D map a tensor over (dh, h, T, b) with boxes
//   of 64 x 1 x 64 x 1 in the 128-byte swizzle, so tiles come straight
//   from the layers' [b, T, h, dh] layout with no transposed copy; TMA
//   fills rows past T with zeros and never reads the next batch row. The
//   producer loads q once, then k and v tile by tile into a 2-stage ring
//   (full / empty mbarriers, sm90_gemm.cuh's helpers and ~5 s hang trap).
// - S = Q K^T: wgmma m64n64k16 over dh / 16 steps, both operands K-major
//   in shared memory. The scale, the mask (only on the diagonal tile: the
//   others hold no column past the row or past T), the row max and sum
//   (over the four lanes of a quad by shuffles, a fixed order), alpha and
//   p run on the f32 sum fragment in registers. exp is the hardware's
//   (__expf: ex2.approx of x log2 e): the accurate expf's range reduction
//   was a visible share of this short kernel's time, and __expf's error,
//   a few f32 ulps where p is near 1 and negligible against 1 where it is
//   not, is far below the bf16 rounding p then takes, so the outputs read
//   as they did against the plain version.
// - O += P V: wgmma m64n{dh}k16 with P from registers: the m64n64 sum
//   fragment maps onto the bf16 A fragment of each k16 step without
//   shuffles (sm90_gemm.cuh), p rounded to bf16 as it is packed; V is the
//   B operand in MN-major order (the transpose bit), so it too is read as
//   it lies. O is scaled by alpha in registers before the products.
// - Out: acc / l rounded to bf16 into q's shared buffer (free by then) in
//   the swizzled layout, then one TMA store of the tile, which writes
//   nothing past T.
// The grid takes the longest query tiles (most key tiles) first.
//
// f32: flash_fwd_kernel (dl4j_flash_attn_fwd with dtype 0), the first,
// simple kernel: one block of 256 threads owns 64 query rows of one
// (batch, head) and walks key tiles of 64 rows from 0 to the diagonal in a
// fixed order. The q tile is loaded once; each k and v tile once per
// block, into shared memory as f32. Each thread holds a 4 x 4 block of s
// and a 4 x (dh / 16) block of acc in registers; a row's max and sum are
// reduced over the 16 threads of the row by warp shuffles. The products
// are plain f32 FMA from shared memory (the tensor cores' f32 path, TF32,
// would round the inputs), so it is bound by its shared-memory loads and
// FMAs, well above the bytes bound. Its bf16 instantiation (dtype 1) is
// kept callable for timing beside the sm90 kernel; no path of the port
// calls it.
//
// Neither kernel uses atomics: each output row depends only on its own
// (batch, head) slice through the same tile order and the same reduction
// order, so a row's bits do not depend on the batch it was computed in,
// and two calls give the same bits. q, k and v are read in the layers'
// [b, T, h, dh] layout (row stride h * dh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "sm90_gemm.cuh"

namespace {

constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 64;                    // key rows per tile
constexpr int kThreads = 256;              // 16 row groups x 16 col groups
constexpr int kPadP = kBK + 4;             // sP row stride (floats)
constexpr float kMask = -0.7f * FLT_MAX;   // _MASK_VALUE
static_assert(kBQ == kBK, "the diagonal tile index equals the query tile's");

// sQ [kBQ][dh+4], sK and sV [kBK][dh+4], sP [kBQ][kBK+4], all f32. The
// +4 keeps rows 16-byte aligned and moves each row 4 banks over, so the
// 8 threads of one 128-bit load phase hit distinct banks.
inline size_t smem_bytes(int dh) {
  const size_t pad = static_cast<size_t>(dh) + 4;
  return (static_cast<size_t>(kBQ) * pad + 2 * static_cast<size_t>(kBK) * pad +
          static_cast<size_t>(kBQ) * kPadP) *
         sizeof(float);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// x rounded to the compute dtype and back (p before the PV product)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [row0, row0 + 64) of one (batch, head) slice of x [b, T, h, dh]
// into dst [64][dh+4] as f32; rows at or past T are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int row0, int seq, int row_stride) {
  constexpr int kVecs = DH / 4;
  for (int idx = threadIdx.x; idx < kBQ * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int d = (idx % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = load4(base + static_cast<size_t>(row0 + r) * row_stride + d);
    store4(dst + r * (DH + 4) + d, val);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int seq,
                 int heads, float scale) {
  constexpr int kPad = DH + 4;
  constexpr int kGroups = DH / 64;         // 4-wide dim groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * kPad;
  float* sV = sK + kBK * kPad;
  float* sP = sV + kBK * kPad;

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  // the heaviest query tiles (most key tiles) are scheduled first
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int row_stride = heads * DH;
  const size_t slice = static_cast<size_t>(bi) * seq * row_stride +
                       static_cast<size_t>(hi) * DH;
  const T* qb = q + slice;
  const T* kb = k + slice;
  const T* vb = v + slice;

  const int tid = threadIdx.x;
  const int tx = tid & 15;                 // column group (low lane bits)
  const int ty = tid >> 4;                 // row group
  const int q0 = qi * kBQ;

  load_tile<T, DH>(sQ, qb, q0, seq, row_stride);

  float m[4], l[4], acc[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kGroups; ++e) acc[i][e] = 0.f;
  }

  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * kBK;
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    load_tile<T, DH>(sK, kb, k0, seq, row_stride);
    load_tile<T, DH>(sV, vb, k0, seq, row_stride);
    __syncthreads();

    // s for rows 4*ty + i, columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(sQ + (4 * ty + i) * kPad + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(sK + (tx + 16 * j) * kPad + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col > row || col >= seq) x = kMask;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(4 * ty + i) * kPadP + tx + 16 * j] = round_to(p, q);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // pv for rows 4*ty + i, dims 64*g + 4*tx + e
    float pv[4][4 * kGroups];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4 * kGroups; ++e) pv[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(sP + (4 * ty + i) * kPadP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv = load4(sV + (c + cc) * kPad + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? pr[i].x
                             : cc == 1 ? pr[i].y
                             : cc == 2 ? pr[i].z
                                       : pr[i].w;
            pv[i][4 * g + 0] = fmaf(pc, vv.x, pv[i][4 * g + 0]);
            pv[i][4 * g + 1] = fmaf(pc, vv.y, pv[i][4 * g + 1]);
            pv[i][4 * g + 2] = fmaf(pc, vv.z, pv[i][4 * g + 2]);
            pv[i][4 * g + 3] = fmaf(pc, vv.w, pv[i][4 * g + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4 * kGroups; ++e)
        acc[i][e] = acc[i][e] * alpha[i] + pv[i][e];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= seq) continue;
    T* orow = out + slice + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 o = make_float4(
          acc[i][4 * g + 0] / l[i], acc[i][4 * g + 1] / l[i],
          acc[i][4 * g + 2] / l[i], acc[i][4 * g + 3] / l[i]);
      store4(orow + 64 * g + 4 * tx, o);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int seq, int heads, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DH>;
  const size_t smem = smem_bytes(DH);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b) * heads, (seq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, heads,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}


// ------------------------------------------------------- wide head sizes
// Every dh % 128 == 0 other than 128 (the JAX flash kernel's rule; its
// VMEM budget holds dh up to 2,944 in f32 and 5,248 in bf16) in f32:
// flash_fwd_wide_kernel (dl4j_flash_attn_fwd_wide); its bf16 instantiation
// is kept callable for timing beside flash_fwd_wide_kernel_sm90 (below),
// which takes bf16 on the port's path. The FMA kernel's
// tiles are [64][dh + 4] f32, which past dh = 128 would need 200 KB and
// more of shared memory, so this one keeps its shared memory fixed:
// - the output's dh is split over grid axis z into slices of kWideDV =
//   128 columns; a block owns 64 query rows of one (batch, head) and one
//   such slice, and walks key tiles as the FMA kernel does;
// - s = q . k over the whole dh is summed chunk by chunk: q and k columns
//   [d0, d0 + 64) are staged, then 64 more, d ascending in one thread,
//   the FMA kernel's order; so every block of a row recomputes the same
//   s, m and l bit for bit, and its slice of acc / l is the slice the
//   whole row would give;
// - P V runs against the slice's 128 columns of v, p rounded to the
//   compute dtype as in the other kernels.
// Its cost: s is computed dh / 128 times, so it is bound by its FMAs
// (2 T^2 dh (dh / 128 + 1) a head, causal half), not by bytes. Simple and
// right; the tensor-core design for bf16 is flash_fwd_wide_kernel_sm90, and
// f32's is later work (the tensor cores' f32 path, TF32, rounds the inputs).
constexpr int kWideDK = 64;    // s: q and k columns staged at a time
constexpr int kWideDV = 128;   // output columns a block owns

inline size_t wide_smem_bytes() {
  return (2 * static_cast<size_t>(kBQ) * (kWideDK + 4) +
          static_cast<size_t>(kBK) * (kWideDV + 4) +
          static_cast<size_t>(kBQ) * kPadP) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int seq,
                      int heads, int dh, float scale) {
  constexpr int kPadK = kWideDK + 4;
  constexpr int kPadV = kWideDV + 4;
  constexpr int kGroups = kWideDV / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * kPadK;
  float* sV = sK + kBK * kPadK;
  float* sP = sV + kBK * kPadV;

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int dv0 = blockIdx.z * kWideDV;
  const int row_stride = heads * dh;
  const size_t slice = static_cast<size_t>(bi) * seq * row_stride +
                       static_cast<size_t>(hi) * dh;
  const T* qb = q + slice;
  const T* kb = k + slice;
  const T* vb = v + slice;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qi * kBQ;

  float m[4], l[4], acc[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kGroups; ++e) acc[i][e] = 0.f;
  }

  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * kBK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kWideDK) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      load_tile<T, kWideDK>(sQ, qb + d0, q0, seq, row_stride);
      load_tile<T, kWideDK>(sK, kb + d0, k0, seq, row_stride);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kWideDK; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = load4(sQ + (4 * ty + i) * kPadK + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = load4(sK + (tx + 16 * j) * kPadK + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }
    }
    // the slice's columns of v for this key tile (sV and sP were last
    // read before the first chunk's barrier above)
    load_tile<T, kWideDV>(sV, vb + dv0, k0, seq, row_stride);

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col > row || col >= seq) x = kMask;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(4 * ty + i) * kPadP + tx + 16 * j] = round_to(p, q);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][4 * kGroups];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4 * kGroups; ++e) pv[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(sP + (4 * ty + i) * kPadP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv = load4(sV + (c + cc) * kPadV + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? pr[i].x
                             : cc == 1 ? pr[i].y
                             : cc == 2 ? pr[i].z
                                       : pr[i].w;
            pv[i][4 * g + 0] = fmaf(pc, vv.x, pv[i][4 * g + 0]);
            pv[i][4 * g + 1] = fmaf(pc, vv.y, pv[i][4 * g + 1]);
            pv[i][4 * g + 2] = fmaf(pc, vv.z, pv[i][4 * g + 2]);
            pv[i][4 * g + 3] = fmaf(pc, vv.w, pv[i][4 * g + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4 * kGroups; ++e)
        acc[i][e] = acc[i][e] * alpha[i] + pv[i][e];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= seq) continue;
    T* orow = out + slice + static_cast<size_t>(row) * row_stride + dv0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 o = make_float4(
          acc[i][4 * g + 0] / l[i], acc[i][4 * g + 1] / l[i],
          acc[i][4 * g + 2] / l[i], acc[i][4 * g + 3] / l[i]);
      store4(orow + 64 * g + 4 * tx, o);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, int b, int seq, int heads, int dh,
                        cudaStream_t stream) {
  auto kern = flash_fwd_wide_kernel<T>;
  const size_t smem = wide_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b) * heads, (seq + kBQ - 1) / kBQ,
                  dh / kWideDV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, heads, dh,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

// ------------------------------------------------------------- bf16, sm90
namespace fa90 {

constexpr int kRows = 64;                 // query rows a block, key rows a tile
constexpr int kStages = 2;                // k/v ring depth
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kThreads = kConsumers + 32; // + the producer warp
constexpr uint32_t kBox = 64 * 64 * 2;    // one 64 x 64 bf16 TMA box, 8 KB

// Shared memory: q (later the output tile) | kStages x (k | v) | barriers;
// every tile 1 KB aligned (the 128-byte swizzle's atom).
template <int DH>
struct Smem {
  static constexpr int kBoxes = DH / 64;              // boxes along dh
  static constexpr uint32_t kTile = kBoxes * kBox;    // one [64][DH] tile
  static constexpr size_t kBytes =
      1024 + (1 + 2 * kStages) * static_cast<size_t>(kTile) +
      (1 + 2 * kStages) * sizeof(uint64_t);
};

// the byte offset of element (r, c) of a [64][DH] bf16 tile kept as
// DH / 64 swizzled boxes of [64][64]
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  const int cb = (c & 63) * 2;
  return (c >> 6) * kBox + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mo, int seq,
                          int heads, int bh_n, float scale) {
  using L = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sq + L::kTile;  // stage s: k, then v
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + 2 * kStages * L::kTile);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  // the longest query tiles first: block t takes tile nq - 1 - t / bh_n
  const int nq = (seq + kRows - 1) / kRows;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / bh_n;
  const int bh = static_cast<int>(blockIdx.x) % bh_n;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = qi * kRows;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers / 32) {  // the producer
    if (lane != 0) return;
    sm90::mbar_expect_tx(qbar, L::kTile);
#pragma unroll
    for (int d = 0; d < L::kBoxes; ++d)
      sm90::tma_load_4d(sq + d * kBox, &mq, qbar, 64 * d, hi, q0, bi);
    for (int ki = 0; ki <= qi; ++ki) {
      const int s = ki % kStages;
      // round n of stage s waits for the consumers to release round n - 1
      sm90::mbar_wait(&empty[s], ((ki / kStages) & 1) ^ 1);
      sm90::mbar_expect_tx(&full[s], 2 * L::kTile);
      unsigned char* kt = ring + 2 * s * L::kTile;
      unsigned char* vt = kt + L::kTile;
#pragma unroll
      for (int d = 0; d < L::kBoxes; ++d) {
        sm90::tma_load_4d(kt + d * kBox, &mk, &full[s], 64 * d, hi,
                          ki * kRows, bi);
        sm90::tma_load_4d(vt + d * kBox, &mv, &full[s], 64 * d, hi,
                          ki * kRows, bi);
      }
    }
    return;
  }

  // the consumer warpgroup: thread (warp w, lane l) holds rows
  // 16 w + l / 4 + 8 h (h = 0, 1) of the tile and, in a sum fragment,
  // columns 8 j + 2 (l % 4) + e at index 4 j + 2 h + e (sm90::Frag)
  const int g = lane >> 2, t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  sm90::mbar_wait(qbar, 0);

  for (int ki = 0; ki <= qi; ++ki) {
    const int s = ki % kStages;
    sm90::mbar_wait(&full[s], (ki / kStages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp issues it together
    const unsigned char* kt = ring + 2 * s * L::kTile;
    const unsigned char* vt = kt + L::kTile;

    // S = Q K^T, both K-major: the k16 step kk is 32 bytes into its box
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    sm90::fence_operands(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBox + 32 * (kk & 3);
      sm90::wgmma_m64n64k16<0, 0>(sc, sm90::smem_desc(sq + off, 16, 1024),
                                  sm90::smem_desc(kt + off, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);

    // the online softmax on the fragment
    const bool diag = ki == qi;
    const int k0 = ki * kRows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int col = k0 + 8 * j + 2 * t + e;
          float x = sc[i] * scale;
          if (diag && (col > row || col >= seq)) x = kMask;
          sc[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = __expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = __expf(sc[i] - m_new);
          sc[i] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = alpha * l[h] + sum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }

    // P as the A fragment of each k16 step kk (columns 16 kk .. 16 kk + 15
    // are n8 blocks 2 kk and 2 kk + 1), p rounded to bf16
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf2(sc[8 * kk + 0], sc[8 * kk + 1]);  // row g
      pa[kk][1] = pack_bf2(sc[8 * kk + 2], sc[8 * kk + 3]);  // row g + 8
      pa[kk][2] = pack_bf2(sc[8 * kk + 4], sc[8 * kk + 5]);  // row g, +8
      pa[kk][3] = pack_bf2(sc[8 * kk + 6], sc[8 * kk + 7]);  // row g + 8, +8
    }

    // O += P V, V MN-major: the k16 step kk starts 2 KB in; the two 64-wide
    // boxes of dh = 128 are 8 KB apart
    sm90::fence_operands(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sm90::smem_desc(vt + 2048 * kk, kBox, 1024);
      if constexpr (DH == 64)
        sm90::wgmma_m64n64k16_rs<1>(o, pa[kk], db);
      else
        sm90::wgmma_m64n128k16_rs<1>(o, pa[kk], db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // out = acc / l in bf16, through q's buffer (no product reads it any
  // more once every warp is here), then one TMA store per box
  consumer_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(sq + tile_off(r, 8 * j + 2 * t)) =
          pack_bf2(o[i] / l[h], o[i + 1] / l[h]);
    }
  }
  sm90::fence_proxy_async();
  consumer_sync();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < L::kBoxes; ++d)
      sm90::tma_store_4d(&mo, sq + d * kBox, 64 * d, hi, q0, bi);
    sm90::bulk_commit();
    sm90::bulk_wait_all();
  }
}

// A TMA map over x [b][T][h][dh] bf16 (contiguous, dh a multiple of 64):
// dimensions (dh, h, T, b), boxes of 64 x 1 x 64 x 1 (one [64 rows][64]
// tile of one (batch, head)), 128-byte swizzle, zeros outside. Under a
// captured train step the maps are encoded once, at capture, from q, k,
// v and out's addresses, which the graph's private pool keeps for its
// life (see sm90::make_map).
inline cudaError_t make_map(CUtensorMap* map, const void* p, int b, int seq,
                            int heads, int dh) {
  const sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int seq, int heads, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e = make_map(&mq, q, b, seq, heads, DH);
  if (e == cudaSuccess) e = make_map(&mk, k, b, seq, heads, DH);
  if (e == cudaSuccess) e = make_map(&mv, v, b, seq, heads, DH);
  if (e == cudaSuccess) e = make_map(&mo, out, b, seq, heads, DH);
  if (e != cudaSuccess) return e;
  auto kern = flash_fwd_kernel_sm90<DH>;
  const size_t smem = Smem<DH>::kBytes;
  // the shared-memory opt-in, once a device (a bit each): it is host work
  // on every call otherwise, and this kernel is short
  static std::atomic<uint64_t> opted{0};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || !(opted.load() & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted.fetch_or(bit);
  }
  const long long blocks = static_cast<long long>(b) * heads *
                           ((seq + kRows - 1) / kRows);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      mq, mk, mv, mo, seq, heads, b * heads,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

}  // namespace fa90

// ------------------------------------------------ wide head sizes, bf16, sm90
// bf16 at every dh % 128 == 0 from 256 up: flash_fwd_wide_kernel_sm90
// (dl4j_flash_attn_fwd_wide_sm90), the tensor-core design of the wide route;
// f32 keeps flash_fwd_wide_kernel above. It computes what _flash_kernel
// computes (the head of this file) at the head sizes the JAX kernel takes
// past 128 (dh % 128 == 0; its VMEM budget reaches 5,248 in bf16).
//
// What bounds it: the causal products are 4 dh T (T + 1) / 2 operations a
// (batch, head) against 8 T dh bytes of q, k, v and out, so at dh >= 256 and
// T >= 1,024 operations bound it (GPT-J's attention, b = 4, T = 2,048, 16
// heads of 256: 137.5 GFLOP, 0.139 ms at 989 TFLOP/s, against 268 MB,
// 0.080 ms), and bytes at the small shapes. Beside the products, each
// 64 x 64 tile of scores takes the CUDA cores a softmax (a max, 4,096
// exponentials, a sum, O's rescale), which has to run while the tensor
// cores do the other products. So the products run on wgmma, a block
// shares each k and v tile between two warpgroups where the q tile fits,
// the softmax overlaps the products, and the [T, T] scores never leave
// the registers.
//
// - A block owns WGS x 64 query rows of one (batch, head) (WGS = 2 consumer
//   warpgroups where the [128, dh] q tile fits in shared memory beside the
//   ring, dh <= 384; else one) and one slice of the output's columns, 256
//   wide (the last 128 where dh % 256 == 128), plus a producer (threads<>).
//   The grid runs the (batch, head) pairs in groups whose k and v fit in
//   24 MB of the 50 MB L2 (12 at GPT-J's T = 2,048, dh = 256, whose 64
//   pairs hold 134 MB of k and v: taken all at once, each wave of blocks
//   read them from device memory again); in a group the longest query
//   tiles go first, and a tile's slices side by side (they read the same
//   q and k tiles).
// - Loads: TMA through fa90's 4-D maps (64 x 64 boxes, 128-byte swizzle,
//   straight from [b, T, h, dh]) into a ring of kStages stages of 32 KB
//   (four boxes) under full / empty mbarriers (sm90_gemm.cuh's helpers and
//   hang trap, the consumers' out of line: hang_trap); both warpgroups read
//   every stage, and each releases it. For each key tile the producer
//   fills its S units, then its V unit. q is resident, loaded once, where
//   its tile fits beside the ring (dh <= 384 at 128 rows, <= 768 at 64):
//   an S unit is 4 k boxes (256 columns of d; the last may hold 2). Past
//   that q (64 rows) streams with k: an S unit is 2 q boxes and 2 k boxes
//   (128 columns). The V unit is the slice's columns of v.
// - S = Q K^T: each warpgroup its 64 rows, wgmma m64n64k16 over the whole
//   dh in d order; a unit's stage is released once the wgmma group that
//   reads it has completed (wgmma_wait<1> after the next unit's group is
//   issued). Every slice's block issues the same sequence on the same
//   inputs, and the softmax is written in explicitly rounded operations
//   (no contraction the compiler could choose differently), so every block
//   of a row holds the same s, m and l bit for bit, and its slice of
//   acc / l is the whole row's.
// - Softmax (online_softmax): fa90's function in base 2, the scale and
//   log2 e in one factor, the finite mask on a warpgroup's diagonal tile
//   only, the row's max and sum as trees then the quad's fixed shuffles,
//   and a running max that moves only by more than kLazy, so that O's
//   rescale is mostly skipped. The first warpgroup stops at its own
//   diagonal tile; the producer loads one more for the second.
// - O += P V: wgmma m64n{256|128}k16 with P from registers (fa90's fragment
//   mapping, p rounded to bf16 as it is packed), V MN-major.
// - Overlap (one S unit a key tile, dh <= 256): key tile k's P V is issued
//   right behind tile k + 1's S, O's rescale between the two, so the
//   tensor cores run it while the warpgroup computes tile k + 1's softmax,
//   and the other warpgroup's products fill the rest; the ring holds V(k)
//   until it has landed. At more S units a tile runs S, softmax and P V in
//   turn.
// - Out: acc / l rounded to bf16 into the warpgroup's own q rows (resident)
//   or the stage that held the last V (streamed), one TMA store a box;
//   nothing past T is written.
// - Registers: a thread holds 128 f32 of O, 32 of S and 16 of P; with two
//   consumer warpgroups the producer's warpgroup gives its registers up
//   (setmaxnreg) so that they may take 232 each (threads<>).
// Shared memory: 1 KB of alignment, q where resident (128 x 64 WGS dh
// bytes), the ring (128 KB) and the barriers: 193 KB at dh = 256, 129 KB
// past 768.
namespace fw90 {

constexpr int kRows = 64;                       // rows a warpgroup, key tile
constexpr int kStages = 4;                      // ring depth
constexpr uint32_t kBox = fa90::kBox;           // one 64 x 64 bf16 box, 8 KB
constexpr uint32_t kStageBytes = 4 * kBox;      // 32 KB
constexpr int kSlice = 256;                     // output columns a block
constexpr long long kGroupBytes = 24LL << 20;   // k and v a group keeps in L2
constexpr size_t kFixed = 1024 + kStages * static_cast<size_t>(kStageBytes) +
                          (1 + 2 * kStages) * sizeof(uint64_t);

// A block's threads: WGS consumer warpgroups, then the producer: a warp
// beside one warpgroup; beside two, a whole warpgroup. Each of the SM's
// four sub-partitions holds 16,384 registers and one warp of each
// warpgroup, so three warpgroups start at 168 registers a thread; the
// producer's gives its registers up (setmaxnreg) for the consumers'.
// (128 x 40 + 256 x 232 = 64,512 registers, what 384 x 168 took.)
template <int WGS>
__host__ __device__ constexpr int threads() {
  return 128 * WGS + (WGS == 2 ? 128 : 32);
}

// the q tile's bytes for wgs warpgroups
__host__ __device__ inline size_t q_bytes(int dh, int wgs) {
  return static_cast<size_t>(kRows) * wgs * dh * 2;
}
// two consumer warpgroups where their [128, dh] q tile fits beside the ring
__host__ __device__ inline int warpgroups(int dh) {
  return kFixed + q_bytes(dh, 2) <= sm90::kMaxSmem ? 2 : 1;
}
__host__ __device__ inline bool q_resident(int dh) {
  return kFixed + q_bytes(dh, warpgroups(dh)) <= sm90::kMaxSmem;
}
__host__ __device__ inline size_t smem_bytes(int dh) {
  return kFixed + (q_resident(dh) ? q_bytes(dh, warpgroups(dh)) : 0);
}

__device__ __forceinline__ void release(uint64_t* empty, int step) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&empty[step % kStages]);
}

// sm90::mbar_wait's hang trap, out of line: a trap inline in the consumer
// warpgroups' code keeps ptxas from giving them setmaxnreg's registers
__device__ __noinline__ void hang_trap() { __trap(); }

// whether the phase of parity `parity` of the barrier at addr is complete
__device__ __forceinline__ bool try_full(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Waits for the phase of step n's stage (the ring's round n / kStages);
// a wait over sm90::kHangCycles traps rather than hang the card.
__device__ __forceinline__ void wait_full(uint64_t* full, int step) {
  const uint32_t addr = sm90::smem_u32(&full[step % kStages]);
  const uint32_t parity = (step / kStages) & 1;
  if (!try_full(addr, parity)) {  // the clock only when it must wait
    const long long t0 = clock64();
    while (!try_full(addr, parity))
      if (clock64() - t0 > sm90::kHangCycles) hang_trap();
  }
  __syncwarp();  // wgmma is .aligned: the warp issues it together
}

// the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// O += P V for one key tile: the slice's SW columns of v at vt, MN-major
// (the k16 step kk starts 2 KB in, the 64-column boxes 8 KB apart)
template <int SW>
__device__ __forceinline__ void issue_pv(float (&o)[SW / 2],
                                         uint32_t (&pa)[4][4],
                                         const unsigned char* vt) {
  sm90::fence_operands(o);
  sm90::wgmma_fence();
  const uint64_t d0 = sm90::smem_desc(vt, kBox, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // a descriptor's start address is in 16-byte units, and shared
    // memory's 228 KB never carries out of its 14 bits
    const uint64_t db = d0 + (2048 * kk >> 4);
    if constexpr (SW == 256)
      sm90::wgmma_m64n256k16_rs<1>(o, pa[kk], db);
    else
      sm90::wgmma_m64n128k16_rs<1>(o, pa[kk], db);
  }
  sm90::wgmma_commit();
}

// after the wait that covers a P V: its sums are in o, and the compiler
// kept pa's registers untouched until here
template <int SW>
__device__ __forceinline__ void pv_landed(float (&o)[SW / 2],
                                          uint32_t (&pa)[4][4]) {
  sm90::fence_operands(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
}

// What a consumer warpgroup works on.
struct Work {
  const unsigned char* sq;  // its q rows (resident), else unused
  unsigned char* ring;
  uint64_t *qbar, *full, *empty;
  bool resident;
  int units, boxes;  // S units a key tile; 64-column boxes along dh
  int last;          // its diagonal key tile
  int q0, seq, hi, bi, dv0, wg;
  float scale_log2;  // 1 / sqrt(dh) * log2 e
};

// The ring's stage of step n.
__device__ __forceinline__ unsigned char* stage(const Work& w, int n) {
  return w.ring + (n % kStages) * kStageBytes;
}

// Issues S unit u of a key tile (its stage at step n) into sc: wgmma
// m64n64k16 over the unit's 64-column chunks of d, in d order, q from its
// resident rows or from the stage.
__device__ __forceinline__ void issue_s_unit(float (&sc)[32], const Work& w,
                                             int u, int n) {
  wait_full(w.full, n);
  const unsigned char* st = stage(w, n);
  const int chunks = w.resident ? min(4, w.boxes - 4 * u) : 2;
  // descriptors as a base plus offsets (see issue_pv)
  const uint64_t dq = sm90::smem_desc(
      w.resident ? w.sq + 4 * u * kBox : st, 16, 1024);
  const uint64_t dk = sm90::smem_desc(w.resident ? st : st + 2 * kBox, 16,
                                      1024);
  sm90::fence_operands(sc);
  sm90::wgmma_fence();
  for (int c = 0; c < chunks; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t off = (c * kBox + 32 * kk) >> 4;
      sm90::wgmma_m64n64k16<0, 0>(sc, dq + off, dk + off);
    }
  sm90::wgmma_commit();
}

// S = Q K^T of the key tile whose first step is n0, every unit's group
// issued; each unit's stage is released once the next unit's group is
// issued and the group before it has completed. The last unit's group is
// left to the caller.
__device__ __forceinline__ void issue_s(float (&sc)[32], const Work& w,
                                        int n0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  issue_s_unit(sc, w, 0, n0);
  for (int u = 1; u < w.units; ++u) {
    issue_s_unit(sc, w, u, n0 + u);
    sm90::wgmma_wait<1>();
    release(w.empty, n0 + u - 1);
  }
}

constexpr float kLazy = 8.f;  // base-2 headroom of the running max

// 2^x on the special-function unit (ex2.approx; exp(y) is 2^(y log2 e))
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of key tile ki on the S fragment, in base 2, with
// c = scale log2 e: the tile's row max is c rowmax s over the unmasked
// scores (c > 0 and rounding is monotone, so that is the max of the
// rounded c s: the max the scale alone would give, times log2 e); the
// running max m takes it where it exceeds m by more than kLazy (always at
// the first tile), alpha = 2^(m_old - m) (else 1); p = 2^(c s - m) in one
// fused rounding, so p <= 2^kLazy, and 0 where masked (the diagonal tile
// only, kDiag: column past the row or past T, where the finite mask value
// gives 0 too). So p = exp(s scale - m') for m' = m ln 2, a row's m' at
// most kLazy ln 2 below its max: acc / l is the same quotient, p's bf16
// rounding the same relative one. sc becomes p (f32), m and l move on,
// alpha is the factor O takes. The
// row's max and sum run as trees (depth 4, then the quad's two shuffles)
// to keep the chains short, in one fixed order, and in explicitly
// rounded operations, so that every slice's block gets the same bits.
template <bool kDiag>
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const Work& w, int k0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a row's 16 values a thread: sc[4 j + 2 h + e], column 8 j + 2 t + e
  auto at = [](int h, int n) { return 4 * (n >> 1) + 2 * h + (n & 1); };
  float tree[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w.q0 + 16 * warp + g + 8 * h;
    float x[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      x[n] = sc[at(h, n)];
      if (kDiag) {
        const int col = k0 + 8 * (n >> 1) + 2 * t + (n & 1);
        if (col > row || col >= w.seq) x[n] = -INFINITY;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) tree[h][n] = fmaxf(x[2 * n], x[2 * n + 1]);
#pragma unroll
    for (int s = 4; s >= 1; s >>= 1)
#pragma unroll
      for (int n = 0; n < s; ++n)
        tree[h][n] = fmaxf(tree[h][2 * n], tree[h][2 * n + 1]);
  }
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = tree[h][0];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // the running max moves only when the tile's exceeds it by more than
    // kLazy, so that p stays within 2^kLazy and O mostly needs no rescale
    const float m_new = fmaxf(m[h], __fmul_rn(mx, w.scale_log2));
    alpha[h] = 1.f;
    if (m_new > __fadd_rn(m[h], kLazy)) {
      alpha[h] = exp2_approx(__fsub_rn(m[h], m_new));
      m[h] = m_new;
    }
    mc[h] = -m[h];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w.q0 + 16 * warp + g + 8 * h;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int i = at(h, n);
      float p = exp2_approx(__fmaf_rn(sc[i], w.scale_log2, mc[h]));
      if (kDiag) {
        const int col = k0 + 8 * (n >> 1) + 2 * t + (n & 1);
        if (col > row || col >= w.seq) p = 0.f;
      }
      sc[i] = p;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
      tree[h][n] = __fadd_rn(sc[at(h, 2 * n)], sc[at(h, 2 * n + 1)]);
#pragma unroll
    for (int s = 4; s >= 1; s >>= 1)
#pragma unroll
      for (int n = 0; n < s; ++n)
        tree[h][n] = __fadd_rn(tree[h][2 * n], tree[h][2 * n + 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = tree[h][0];
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    l[h] = __fmaf_rn(alpha[h], l[h], sum);
  }
}

__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Work& w, int ki) {
  if (ki == w.last)
    online_softmax<true>(sc, m, l, alpha, w, ki * kRows);
  else
    online_softmax<false>(sc, m, l, alpha, w, ki * kRows);
}

// O *= alpha, skipped where no row of the warp moved its max (alpha is 1
// exactly, and O * 1 is O)
template <int SW>
__device__ __forceinline__ void rescale(float (&o)[SW / 2],
                                        const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < SW / 8; ++j) {
      o[4 * j + 2 * h] *= alpha[h];
      o[4 * j + 2 * h + 1] *= alpha[h];
    }
}

// P as the A fragment of each k16 step kk, p rounded to bf16 (fa90's
// mapping)
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = fa90::pack_bf2(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = fa90::pack_bf2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = fa90::pack_bf2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = fa90::pack_bf2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// A consumer warpgroup for a slice of SW columns. Thread (warp w of the
// warpgroup, lane l) holds rows 16 w + l / 4 + 8 h (h = 0, 1) of the
// warpgroup's 64 and, in a sum fragment, columns 8 j + 2 (l % 4) + e at
// index 4 j + 2 h + e (sm90::Frag). kOverlap (one S unit a key tile): key
// tile k's P V is issued right behind tile k + 1's S (O rescaled between
// the two, while S runs) and runs while the warpgroup computes tile
// k + 1's softmax; the loop has no branch between a group's issue and its
// wait, so that ptxas keeps the products asynchronous. Otherwise each
// tile runs S, softmax, P V in turn.
template <int SW, bool kOverlap>
__device__ __forceinline__ void consume(const CUtensorMap* mo,
                                        const Work& w) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per_tile = w.units + 1;  // ring steps a key tile: S units, V
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  float o[SW / 2];
#pragma unroll
  for (int i = 0; i < SW / 2; ++i) o[i] = 0.f;
  uint32_t pa[4][4];  // a key tile's P, until its P V has landed
  float sc[32];
  if (w.resident) wait_full(w.qbar, 0);  // step 0 of a one-stage ring

  if constexpr (kOverlap) {
    issue_s(sc, w, 0);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    release(w.empty, 0);
    softmax_tile(sc, m, l, alpha, w, 0);
    pack_p(pa, sc);
    for (int ki = 1; ki <= w.last; ++ki) {
      const int n0 = 2 * ki;  // S at n0, the last tile's V at n0 - 1
      issue_s(sc, w, n0);
      rescale<SW>(o, alpha);
      wait_full(w.full, n0 - 1);
      issue_pv<SW>(o, pa, stage(w, n0 - 1));
      sm90::wgmma_wait<1>();  // S is done; the P V may still run
      sm90::fence_operands(sc);
      release(w.empty, n0);
      softmax_tile(sc, m, l, alpha, w, ki);
      sm90::wgmma_wait<0>();
      pv_landed<SW>(o, pa);
      release(w.empty, n0 - 1);
      pack_p(pa, sc);
    }
    const int nv = 2 * w.last + 1;
    rescale<SW>(o, alpha);
    wait_full(w.full, nv);
    issue_pv<SW>(o, pa, stage(w, nv));
    sm90::wgmma_wait<0>();
    pv_landed<SW>(o, pa);
  } else {
    for (int ki = 0; ki <= w.last; ++ki) {
      const int n0 = ki * per_tile;
      issue_s(sc, w, n0);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(sc);
      release(w.empty, n0 + w.units - 1);
      softmax_tile(sc, m, l, alpha, w, ki);
      rescale<SW>(o, alpha);
      pack_p(pa, sc);
      const int nv = n0 + w.units;
      wait_full(w.full, nv);
      issue_pv<SW>(o, pa, stage(w, nv));
      sm90::wgmma_wait<0>();
      pv_landed<SW>(o, pa);
      // (the producer loads nothing more into the last tile's stage, which
      // the epilogue may take)
      release(w.empty, nv);
    }
  }

  // out = acc / l in bf16 through the warpgroup's own q rows (every warp
  // of it is past its products once all are here), or through the last
  // V's stage where q streams (one warpgroup: the producer is done), then
  // one TMA store a box
  unsigned char* buf = w.resident ? const_cast<unsigned char*>(w.sq)
                                  : stage(w, w.last * per_tile + w.units);
  warpgroup_sync(w.wg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < SW / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(buf + fa90::tile_off(r, 8 * j + 2 * t)) =
          fa90::pack_bf2(o[i] / l[h], o[i + 1] / l[h]);
    }
  }
  sm90::fence_proxy_async();
  warpgroup_sync(w.wg);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int d = 0; d < SW / 64; ++d)
      sm90::tma_store_4d(mo, buf + d * kBox, w.dv0 + 64 * d, w.hi, w.q0,
                         w.bi);
    sm90::bulk_commit();
    sm90::bulk_wait_all();
  }
}

// The producer (one thread): q once where resident, then for each key tile
// up to the last warpgroup's diagonal its S units and its V unit.
template <int WGS>
__device__ __forceinline__ void produce(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    unsigned char* sq, unsigned char* ring, uint64_t* qbar, uint64_t* full,
    uint64_t* empty, bool resident, int units, int boxes, int q0, int hi,
    int bi, int dv0, int sw) {
  if (resident) {
    sm90::mbar_expect_tx(qbar, WGS * boxes * kBox);
    for (int r = 0; r < WGS; ++r)
      for (int d = 0; d < boxes; ++d)
        sm90::tma_load_4d(sq + (r * boxes + d) * kBox, mq, qbar, 64 * d, hi,
                          q0 + kRows * r, bi);
  }
  int step = 0;
  const int tiles = (q0 + kRows * WGS) / kRows;
  for (int ki = 0; ki < tiles; ++ki) {
    const int k0 = ki * kRows;
    for (int u = 0; u <= units; ++u, ++step) {
      const int s = step % kStages;
      // round n of stage s waits for the consumers to release round n - 1
      sm90::mbar_wait(&empty[s], ((step / kStages) & 1) ^ 1);
      unsigned char* st = ring + s * kStageBytes;
      if (u == units) {  // the V unit: the slice's columns of v
        sm90::mbar_expect_tx(&full[s], (sw / 64) * kBox);
        for (int d = 0; d < sw / 64; ++d)
          sm90::tma_load_4d(st + d * kBox, mv, &full[s], dv0 + 64 * d, hi,
                            k0, bi);
      } else if (resident) {
        const int n = min(4, boxes - 4 * u);
        sm90::mbar_expect_tx(&full[s], n * kBox);
        for (int c = 0; c < n; ++c)
          sm90::tma_load_4d(st + c * kBox, mk, &full[s], 64 * (4 * u + c), hi,
                            k0, bi);
      } else {
        sm90::mbar_expect_tx(&full[s], kStageBytes);
        for (int c = 0; c < 2; ++c) {
          sm90::tma_load_4d(st + c * kBox, mq, &full[s], 64 * (2 * u + c), hi,
                            q0, bi);
          sm90::tma_load_4d(st + (2 + c) * kBox, mk, &full[s],
                            64 * (2 * u + c), hi, k0, bi);
        }
      }
    }
  }
}

template <int WGS>
__global__ void __launch_bounds__(threads<WGS>(), 1)
    flash_fwd_wide_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mo,
                               int seq, int heads, int bh_n, int group,
                               int dh, float scale_log2) {
  constexpr int kConsumers = 128 * WGS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bool resident = q_resident(dh);
  unsigned char* ring = sq + (resident ? q_bytes(dh, WGS) : 0);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  // (batch, head) pairs in groups of `group`, whose k and v L2 holds at
  // once; in a group the longest query tiles first, a tile's slices side
  // by side
  const int slices = (dh + kSlice - 1) / kSlice;
  const int nq = (seq + kRows * WGS - 1) / (kRows * WGS);
  const int gi = static_cast<int>(blockIdx.x) / (group * nq * slices);
  const int in_group = min(group, bh_n - gi * group);
  const int r = static_cast<int>(blockIdx.x) % (group * nq * slices);
  const int qi = nq - 1 - r / (in_group * slices);
  const int bh = gi * group + (r % (in_group * slices)) / slices;
  const int sl = r % slices;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = qi * kRows * WGS;
  const int dv0 = sl * kSlice;
  const int sw = min(kSlice, dh - dv0);  // 256, or 128 for the last slice
  const int boxes = dh / 64;
  const int units = resident ? (boxes + 3) / 4 : boxes / 2;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if / else for the two roles, which never meet again, on a
  // warpgroup index the compiler can see is the same across a warp (a
  // shuffle from lane 0): setmaxnreg takes effect only so
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == WGS) {  // the producer
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers)
      produce<WGS>(&mq, &mk, &mv, sq, ring, qbar, full, empty, resident,
                   units, boxes, q0, hi, bi, dv0, sw);
  } else {
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = role;
    Work w;
    w.sq = sq + wg * boxes * kBox;
    w.ring = ring;
    w.qbar = qbar;
    w.full = full;
    w.empty = empty;
    w.resident = resident;
    w.units = units;
    w.boxes = boxes;
    w.q0 = q0 + kRows * wg;
    w.last = w.q0 / kRows;
    w.seq = seq;
    w.hi = hi;
    w.bi = bi;
    w.dv0 = dv0;
    w.wg = wg;
    w.scale_log2 = scale_log2;
    if (sw == kSlice && units == 1)
      consume<kSlice, true>(&mo, w);
    else if (sw == kSlice)
      consume<kSlice, false>(&mo, w);
    else
      consume<kSlice / 2, false>(&mo, w);
  }
}

template <int WGS>
cudaError_t launch_wgs(const CUtensorMap& mq, const CUtensorMap& mk,
                       const CUtensorMap& mv, const CUtensorMap& mo, int b,
                       int seq, int heads, int dh, cudaStream_t stream) {
  auto kern = flash_fwd_wide_kernel_sm90<WGS>;
  // the shared-memory opt-in, once a device (a bit each), at the most any
  // dh asks for
  static std::atomic<uint64_t> opted{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || !(opted.load() & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm90::kMaxSmem));
    if (e != cudaSuccess) return e;
    opted.fetch_or(bit);
  }
  const long long blocks = static_cast<long long>(b) * heads *
                           ((seq + kRows * WGS - 1) / (kRows * WGS)) *
                           ((dh + kSlice - 1) / kSlice);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  // as many (batch, head) pairs a group as keep their k and v (4 T dh
  // bytes each) within kGroupBytes of L2
  const long long kv = 4LL * seq * dh;
  const int group = static_cast<int>(
      std::max(1LL, std::min<long long>(b * heads, kGroupBytes / kv)));
  kern<<<static_cast<unsigned>(blocks), threads<WGS>(), smem_bytes(dh),
         stream>>>(mq, mk, mv, mo, seq, heads, b * heads, group, dh,
                   static_cast<float>(1.4426950408889634 /
                                      sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

inline cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int b, int seq, int heads, int dh,
                          cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e = fa90::make_map(&mq, q, b, seq, heads, dh);
  if (e == cudaSuccess) e = fa90::make_map(&mk, k, b, seq, heads, dh);
  if (e == cudaSuccess) e = fa90::make_map(&mv, v, b, seq, heads, dh);
  if (e == cudaSuccess) e = fa90::make_map(&mo, out, b, seq, heads, dh);
  if (e != cudaSuccess) return e;
  return warpgroups(dh) == 2
             ? launch_wgs<2>(mq, mk, mv, mo, b, seq, heads, dh, stream)
             : launch_wgs<1>(mq, mk, mv, mo, b, seq, heads, dh, stream);
}

}  // namespace fw90

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out are contiguous
// [b, T, h, dh] with dh 64 or 128, each 16-byte aligned. Returns a
// cudaError_t (0 on success).
int dl4j_flash_attn_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, int b, int seq, int heads,
                        int dh, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b < 1 || seq < 1 || heads < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, out, b, seq, heads, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, out, b, seq, heads, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, b, seq, heads, s);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, b, seq, heads, s);
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block needs for head size dh.
int dl4j_flash_attn_fwd_smem_bytes(int dtype, int dh) {
  (void)dtype;
  return static_cast<int>(smem_bytes(dh));
}

// bf16 on the tensor cores (flash_fwd_kernel_sm90): q, k, v and out are
// contiguous [b, T, h, dh] bf16 with dh 64 or 128, each 16-byte aligned.
// Returns a cudaError_t (0 on success).
int dl4j_flash_attn_fwd_sm90(const void* q, const void* k, const void* v,
                             void* out, int b, int seq, int heads, int dh,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const void* arrays[] = {q, k, v, out};
  for (const void* p : arrays)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  if (b < 1 || seq < 1 || heads < 1) return cudaErrorInvalidValue;
  if (dh == 64) return fa90::launch<64>(q, k, v, out, b, seq, heads, s);
  if (dh == 128) return fa90::launch<128>(q, k, v, out, b, seq, heads, s);
  return cudaErrorInvalidValue;
}

int dl4j_flash_attn_fwd_sm90_smem_bytes(int dh) {
  return static_cast<int>(dh == 128 ? fa90::Smem<128>::kBytes
                                    : fa90::Smem<64>::kBytes);
}

// Every head size dh % 128 == 0 (flash_fwd_wide_kernel), bf16 or f32:
// q, k, v and out are contiguous [b, T, h, dh], each 16-byte aligned.
// Returns a cudaError_t (0 on success).
int dl4j_flash_attn_fwd_wide(int dtype, const void* q, const void* k,
                             const void* v, void* out, int b, int seq,
                             int heads, int dh, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b < 1 || seq < 1 || heads < 1 || dh < kWideDV || dh % kWideDV)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_wide<float>(q, k, v, out, b, seq, heads, dh, s);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16>(q, k, v, out, b, seq, heads, dh, s);
  return cudaErrorInvalidValue;
}

int dl4j_flash_attn_fwd_wide_smem_bytes() {
  return static_cast<int>(wide_smem_bytes());
}

// bf16 at every dh % 128 == 0 from 256 up, on the tensor cores
// (flash_fwd_wide_kernel_sm90): q, k, v and out are contiguous
// [b, T, h, dh] bf16, each 16-byte aligned. Returns a cudaError_t (0 on
// success).
int dl4j_flash_attn_fwd_wide_sm90(const void* q, const void* k,
                                  const void* v, void* out, int b, int seq,
                                  int heads, int dh, void* stream) {
  const void* arrays[] = {q, k, v, out};
  for (const void* p : arrays)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  if (b < 1 || seq < 1 || heads < 1 || dh < 2 * kWideDV || dh % kWideDV)
    return cudaErrorInvalidValue;
  return fw90::launch(q, k, v, out, b, seq, heads, dh,
                      static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory one block of the kernel above takes at
// head size dh (ops/attention.py::wide_sm90_plan states the same).
int dl4j_flash_attn_fwd_wide_sm90_smem_bytes(int dh) {
  return static_cast<int>(fw90::smem_bytes(dh));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
