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
// Three kernels (the wrapper, ops/attention.py, decides): by dtype for dh
// 64 and 128, and one for every other dh % 128 == 0 (see "wide head
// sizes" below):
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
// VMEM budget holds dh up to 2,944 in f32 and 5,248 in bf16), bf16 and
// f32: flash_fwd_wide_kernel (dl4j_flash_attn_fwd_wide). The FMA kernel's
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
// right; a tensor-core design is later work.
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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
