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
// What the design does about it, simply: one block of 256 threads owns 64
// query rows of one (batch, head) and walks key tiles of 64 rows from 0 to
// the diagonal in a fixed order. The q tile is loaded once; each k and v
// tile once per block, into shared memory as f32. Each thread holds a 4 x
// 4 block of s and a 4 x (dh / 16) block of acc in registers; a row's max
// and sum are reduced over the 16 threads of the row by warp shuffles.
// The products are plain f32 FMA from shared memory (wgmma, TMA and warp
// specialization are later work), so this kernel is bound by its shared-
// memory loads and FMAs, well above the bytes bound.
//
// q, k and v are read in the layers' [b, T, h, dh] layout (row stride
// h * dh), with no transposed copies. No atomics: each output row depends
// only on its own (batch, head) slice through the same tile order, so a
// row's bits do not depend on the batch it was computed in, and two calls
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
