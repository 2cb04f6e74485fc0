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
// of rows, the query length, q_start or the bucket.
//
// S1 (dl4j_stream_dense): y[r, c] = (sum_i x[r, i] * W[i, c]) + bias[c],
// f32. One thread per output element; a block of 128 threads covers 128
// consecutive columns of one row, so the W reads of a warp are coalesced
// and x[r, i] is one broadcast load. Bound: at a decode step of 32 rows
// and the MLP's [256, 1024] W, W (1 MB) is the traffic, ~0.3 us at
// 3.35 TB/s, against 16.8 MFLOP, ~0.25 us at the f32 rate: bytes, barely.
// The sequential sum per thread is far from either; speed is a later PR's.
//
// S2 (dl4j_stream_mha): causal MHA of q [b, t, h, dh] against the
// fixed-extent cache k, v [b, C, h, dh] (f32), row i of batch row r at
// absolute position pos[r] + i. One warp per (r, i, head):
//   1. q's row to shared memory;
//   2. lane j, j + 32, ... computes s_j = (sum_d q[d] * k[j, d]) * scale
//      for the visible positions j <= min(pos[r] + i, C - 1), ascending d;
//   3. m = max_j s_j by a warp shuffle (max is exact in any order);
//   4. p_j = expf(s_j - m) into shared memory;
//   5. l = sum_j p_j and o[d] = sum_j p_j * v[j, d], each ascending in j,
//      each lane owning the columns d = lane, lane + 32, ...;
//   6. out[d] = o[d] / l (normalised after the sum, as _causal_mha_exact).
// Masked positions add an exact zero in the plain version and are skipped
// here; which ones are skipped depends only on the row's own position.
// Bound: a decode step reads the cache, 2 x 32 x 256 x 4 x 64 x 4 B = 16.8
// MB for 32 rows at C = 256, ~5 us at 3.35 TB/s: bytes. This kernel reads
// k with one row per lane (uncoalesced) and is slower than that.
//
// S3 (dl4j_stream_rownorm): LayerNorm of each row of x [rows, w], f32:
// mu = (sum_i x_i) / w, d = x - mu, var = (sum_i d_i * d_i) / w,
// y = d * (1 / sqrt(var + eps)) * gamma + beta, every sum ascending in i,
// the reciprocal square root as a rounded sqrt and a rounded division (the
// plain version's torch.sqrt and division round the same way). PyTorch's
// own mean is not decode-stable on the card: chip_smoke.py's
// [stream_invariance] read 5 of 8 rows moving by up to 2.4e-7 when the
// same rows came in a batch of 8 instead of 2048 (NVIDIA H100 80GB HBM3,
// 700.00 W). One block of 128 threads per row: the row to shared memory,
// thread 0 sums it twice in order, then every thread normalises its
// columns. Bound: x read once and y written once, 2 x 4 B a value: bytes.
//
// The wrappers (ops/stream_exact.py) check shapes, dtypes, contiguity and
// the device, allocate the outputs and count the launches. Every entry
// point returns a cudaError_t (0 on success) and launches on the stream it
// is given.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDenseThreads = 128;
constexpr int kMhaWarps = 4;
constexpr int kNormThreads = 128;

__global__ void stream_dense_kernel(const float* __restrict__ x,
                                    const float* __restrict__ W,
                                    const float* __restrict__ bias,
                                    float* __restrict__ y, int f, int g) {
  const int c = blockIdx.x * kDenseThreads + threadIdx.x;
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
__global__ void stream_mha_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const int* __restrict__ pos,
                                  float* __restrict__ out, int b, int t,
                                  int heads, int dh, int C, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kMhaWarps + warp;
  const int64_t n_rows = static_cast<int64_t>(b) * t * heads;
  if (row >= n_rows) return;
  float* qs = smem + warp * (dh + C);
  float* ps = qs + dh;
  const int hd = static_cast<int>(row % heads);
  const int i = static_cast<int>((row / heads) % t);
  const int r = static_cast<int>(row / (static_cast<int64_t>(heads) * t));
  // q [b, t, h, dh]: this row's dh values
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

// dynamic shared memory: the row (w floats) and its two statistics
__global__ void stream_rownorm_kernel(const float* __restrict__ x,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float* __restrict__ y, int w,
                                     float eps) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* stats = smem + w;
  const int64_t r = blockIdx.x;
  const float* xr = x + r * w;
  for (int i = threadIdx.x; i < w; i += kNormThreads) xs[i] = xr[i];
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
  for (int i = threadIdx.x; i < w; i += kNormThreads) {
    const float d = __fsub_rn(xs[i], mu);
    yr[i] = __fadd_rn(__fmul_rn(__fmul_rn(d, inv), gamma[i]), beta[i]);
  }
}

}  // namespace

extern "C" {

// x [rows, f], W [f, g], bias [g] or null, y [rows, g]; all f32 and
// contiguous.
int dl4j_stream_dense(const void* x, const void* W, const void* bias,
                      void* y, int rows, int f, int g, void* stream) {
  if (rows < 1 || f < 1 || g < 1 || rows > 65535) return cudaErrorInvalidValue;
  dim3 grid((g + kDenseThreads - 1) / kDenseThreads, rows);
  stream_dense_kernel<<<grid, kDenseThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const float*>(bias), static_cast<float*>(y), f, g);
  return static_cast<int>(cudaGetLastError());
}

int dl4j_stream_mha_smem_bytes(int dh, int cache_len) {
  return static_cast<int>(kMhaWarps * (dh + cache_len) * sizeof(float));
}

// q, out [b, t, h, dh]; k, v [b, C, h, dh]; pos [b] int32; all f32 (pos
// int32) and contiguous.
int dl4j_stream_mha(const void* q, const void* k, const void* v,
                    const void* pos, void* out, int b, int t, int heads,
                    int dh, int cache_len, float scale, void* stream) {
  if (b < 1 || t < 1 || heads < 1 || dh < 1 || cache_len < 1)
    return cudaErrorInvalidValue;
  const int smem = dl4j_stream_mha_smem_bytes(dh, cache_len);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t rows = static_cast<int64_t>(b) * t * heads;
  const int64_t blocks = (rows + kMhaWarps - 1) / kMhaWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  stream_mha_kernel<<<static_cast<unsigned>(blocks), kMhaWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos),
      static_cast<float*>(out), b, t, heads, dh, cache_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// x, y [rows, w]; gamma, beta [w]; all f32 and contiguous.
int dl4j_stream_rownorm(const void* x, const void* gamma, const void* beta,
                        void* y, int rows, int w, float eps, void* stream) {
  if (rows < 1 || w < 1) return cudaErrorInvalidValue;
  const int smem = static_cast<int>((w + 2) * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_rownorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stream_rownorm_kernel<<<rows, kNormThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y), w, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
