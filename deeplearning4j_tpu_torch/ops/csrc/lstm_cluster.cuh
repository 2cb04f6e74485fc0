// What the LSTM's cluster kernels (lstm_fwd.cu's and lstm_bwd.cu's bf16
// route on Hopper, sm_90a) share: the ownership of Wh, the shared-memory
// layouts the wgmma products read, and the cluster's exchange through
// distributed shared memory (DSMEM).
//
// Ownership. A thread-block cluster of C = n / 32 blocks (16 at n = 512)
// walks the sequence for R = 32 batch rows; block rank q owns hidden units
// 32 q .. 32 q + 31 and all four gate columns of each, 128 columns in all,
// in local order lc = 32 g + u (gate g of unit 32 q + u; g = i, f, o, g).
// Its slice of Wh, n x 128 bf16 (128 KB at n = 512), is loaded into shared
// memory once per launch and read there at every step.
//
// The slice's layout serves both kernels' products. It is two regions, one
// for local columns 0-63 (gates i, f) and one for 64-127 (o, g), each n
// rows of 128 bytes: row k holds Wh[k][those 64 columns], in 8-row atoms
// of 1 KB with the 128-byte swizzle (the 16-byte chunk c of row k lies at
// chunk c ^ (k % 8)), which is what TMA writes for a [64 k][64 mn] box.
// - K1's z^T = Wh_slice^T h^T reads it as A(m = lc, k = unit), MN-major:
//   one region is one m64 tile, k16 step s starts 2 KB * s in, SBO 1 KB.
// - K2's P = Wh_slice dz^T reads it as A(m = unit, k = lc), K-major: the
//   region is the 64-wide k block, m64 tile mu starts 8 KB * mu in, k16
//   step j of the block 32 * j bytes in, SBO 1 KB (sm90_gemm.cuh's head
//   comment describes both forms).
// The other operand is K-major: K2's dz [R rows][64 k] per k block, 128
// bytes a row, in the same swizzle (kmajor_off); K1's h [R rows][32 k] per
// k block, 64 bytes a row, in the 64-byte swizzle (kmajor64_off), so that
// each rank's 32 units are one contiguous 2 KB block to copy.
//
// Exchange. A block stages what other blocks need in its own shared
// memory, contiguous per receiver, and pushes it with one bulk copy a
// receiver (cp.async.bulk shared::cta -> shared::cluster, bulk_to), counted
// in bytes against the receiving block's barrier; the receiver arms the
// barrier's phase with the bytes it expects and waits on it with acquire
// at cluster scope. Where a sender must know that a receiver has read a
// buffer before it writes it again, the receiver arrives on the sender's
// barrier (release at cluster scope). A wait that lasts ~5 s traps
// (sm90::kHangCycles) instead of hanging the card, so a copy that never
// comes fails the launch. Bulk copies, because 16-byte DSMEM loads or
// stores (each store counted on the receiver's barrier) took most of a K2
// step on the card (PERF.md, section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace lstm_cluster {

using bf16 = __nv_bfloat16;

constexpr int kUnits = 32;         // hidden units a block owns
constexpr int kCols = 4 * kUnits;  // its gate columns: two m64 tiles
constexpr int kRows = 32;          // batch rows a cluster walks (R)
constexpr int kMaxCluster = 16;    // the largest cluster Hopper schedules
constexpr int kMaxN = kUnits * kMaxCluster;  // 512
constexpr int kThreads = 256;      // two warpgroups
constexpr int kItems = kRows * kUnits / kThreads;  // (row, unit) a thread
constexpr int kStride = kRows + 4;  // f32 row of z / P: 16-byte aligned
static_assert(kItems == 4, "thread (w, l) keeps rows 4 w .. 4 w + 3 of unit l");
static_assert(kRows % 8 == 0 && kRows <= 256, "wgmma n = R");

// The cluster size for hidden size n; the route takes n % 64 == 0, 64 <= n
// <= kMaxN (lstm.py::takes_cluster).
__host__ __device__ constexpr int cluster_size(int n) { return n / kUnits; }

// Bytes of the Wh slice and of one K-major [R][n] bf16 operand.
__host__ __device__ constexpr size_t slice_bytes(int n) {
  return static_cast<size_t>(n) * kCols * 2;
}
__host__ __device__ constexpr size_t rows_bytes(int k) {
  return static_cast<size_t>(kRows) * k * 2;
}

// Byte offset of element (r, k) of K1's h buffer, a K-major [R rows][n]
// bf16 operand in k blocks of 32 (one block a rank, 2 KB, so that a rank's
// units are one contiguous bulk copy), R rows of 64 bytes each, in the
// 64-byte swizzle: the 16-byte chunk c of row r at chunk c ^ ((r / 2) % 4).
__device__ __forceinline__ uint32_t kmajor64_off(int r, int k) {
  const int kb = k >> 5, ch = (k & 31) >> 3;
  return kb * (kRows * 64) + r * 64 + ((ch ^ ((r >> 1) & 3)) << 4) +
         ((k & 7) << 1);
}

// wgmma's shared-memory descriptor for that layout (swizzle mode 2, 64
// bytes; SBO 512 between 8-row groups), as sm90::smem_desc for 128 bytes.
__device__ __forceinline__ uint64_t smem_desc64(const void* p) {
  uint64_t d = (sm90::smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(16 >> 4) << 16;
  d |= static_cast<uint64_t>(512 >> 4) << 32;
  d |= 2ull << 62;
  return d;
}

// One contiguous copy of `bytes` from this block's shared memory at `src`
// into shared memory of a block of the cluster at `dst` (cp.async.bulk),
// counted on the barrier at `bar` there (dst and bar shared::cluster
// addresses, remote() of the block's own), in the issuing thread's bulk
// group.
__device__ __forceinline__ void bulk_to(uint32_t dst, uint32_t src,
                                        uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset of element (r, k) of a K-major [R rows][k] bf16 operand:
// k blocks of 64 one after another, R rows of 128 bytes each, swizzled.
__device__ __forceinline__ uint32_t kmajor_off(int r, int k) {
  const int kb = k >> 6, ch = (k & 63) >> 3;
  return kb * (kRows * 128) + r * 128 + ((ch ^ (r & 7)) << 4) +
         ((k & 7) << 1);
}

// The Wh slice of block q into W_s (1 KB aligned) by cp.async, 16 bytes a
// copy: element (k, lc) at region lc / 64, row k, swizzled column lc % 64.
__device__ __forceinline__ void load_slice(unsigned char* W_s, const bf16* Wh,
                                           int n, int q) {
  const size_t n4 = 4 * static_cast<size_t>(n);
  for (int idx = threadIdx.x; idx < n * (kCols / 8); idx += kThreads) {
    const int k = idx / (kCols / 8), cc = idx % (kCols / 8);
    const int g = cc / 4, u0 = (cc % 4) * 8;
    const bf16* src = Wh + k * n4 + static_cast<size_t>(g) * n + kUnits * q +
                      u0;
    const uint32_t dst =
        sm90::smem_u32(W_s + (cc / 8) * static_cast<size_t>(n) * 128 +
                       k * 128 + (((cc % 8) ^ (k & 7)) << 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// d += A(64 x 16) B(16 x 32), both from shared memory; TA / TB the
// transpose bits (0: K-major, 1: MN-major), as sm90::wgmma_m64n128k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %18, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// An m64n32 f32 sum fragment to rows [row0, row0 + 64) of an f32 [rows]
// [kStride] array: acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h (w the
// warp in the warpgroup), column 8 j + 2 (l % 4) + e.
__device__ __forceinline__ void store_frag(float* out, int row0,
                                           const float (&acc)[16]) {
  const int w = (threadIdx.x >> 5) & 3, l = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = out + (row0 + 16 * w + (l >> 2) + 8 * h) * kStride + 2 * (l & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// Step marks, for scripts/lstm_step_parts.py: built with
// -DDL4J_LSTM_STEP_MARKS, STEP_MARK(it, k) stores clock64() at the end of
// part k of step it (it < 64) of block 0 of cluster 0, threads 0 and 128
// (one a warpgroup), into step_marks, which the script reads through
// dl4j_lstm_{fwd,bwd}_step_marks. In the build the wrappers load it is
// empty.
#ifdef DL4J_LSTM_STEP_MARKS
__device__ long long step_marks[2][64][8];
#define STEP_MARK(it, k)                                                    \
  do {                                                                      \
    if ((threadIdx.x & 127) == 0 && blockIdx.x == 0 && (it) < 64)           \
      lstm_cluster::step_marks[threadIdx.x >> 7][it][k] = clock64();        \
  } while (0)
#define STEP_MARKS_ENTRY(name)                                              \
  extern "C" int name(void* host) {                                         \
    return cudaMemcpyFromSymbol(host, lstm_cluster::step_marks,             \
                                sizeof(lstm_cluster::step_marks));          \
  }
#else
#define STEP_MARK(it, k) \
  do {                   \
  } while (0)
#define STEP_MARKS_ENTRY(name)
#endif

__device__ __forceinline__ uint32_t block_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// The address of this block's shared-memory word at `local` in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t remote(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}


// One arrival, with release at cluster scope, on the barrier at `addr` (a
// shared::cluster address, remote() of the barrier).
__device__ __forceinline__ void arrive_remote(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          addr)
      : "memory");
}

// Waits, with acquire at cluster scope, until phase `parity` of this
// block's barrier b has completed; traps after ~5 s.
__device__ __forceinline__ void wait_cluster(uint64_t* b, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(b);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > sm90::kHangCycles) __trap();
  }
}

// A plain cluster barrier, for the start (every block running and its
// barriers initialised before any remote access) and the end (no block
// leaves while another may still touch its shared memory).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// Each block of the cluster signals barrier `b` of every block once, after
// its threads' reads that the signal releases (the caller's __syncthreads
// comes first): thread r arrives on block r's copy.
__device__ __forceinline__ void signal_all(uint64_t* b, int C) {
  if (threadIdx.x < C) arrive_remote(remote(sm90::smem_u32(b), threadIdx.x));
}

// The cluster kernels' gates, from __expf and __fdividef: within ~1e-6
// relative of expf-based ones (a few f32 ulps), far below the bf16
// outputs' 2^-8; tanh(x) = 1 - 2 / (e^(2x) + 1) saturates to +-1 where
// e^(2x) overflows or vanishes. (expf and tanhf took most of K1's cell
// update on the card.)
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_f(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

__device__ __forceinline__ float bf(uint16_t raw) {
  return __bfloat162float(__ushort_as_bfloat16(raw));
}
__device__ __forceinline__ uint16_t raw(const bf16* p) {
  return __bfloat16_as_ushort(*p);
}

// The launch of `chunks` clusters of C blocks: the attributes a
// non-portable size needs, and the configuration (attr is its one
// attribute, the cluster's size).
template <typename... Params>
cudaError_t cluster_config(void (*kern)(Params...), int C, int chunks,
                           size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(C * chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return e;
}

// How many clusters of C blocks of the kernel fit on the card at once (0:
// none), or -1 when the query fails.
template <typename... Params>
int active_clusters(void (*kern)(Params...), int C, size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int fit = 0;
  if (cluster_config(kern, C, 1, smem, nullptr, cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&fit, kern, &cfg) != cudaSuccess)
    return -1;
  return fit;
}

// Launches `chunks` clusters of C blocks; returns kNoCluster when not one
// fits on the card, else cudaLaunchKernelEx's error.
constexpr int kNoCluster = -1;

template <typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), int C, int chunks, size_t smem,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kern, C, chunks, smem, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  int fit = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg)) != cudaSuccess)
    return e;
  if (fit < 1) return kNoCluster;
  if ((e = cudaLaunchKernelEx(&cfg, kern, args...)) != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace lstm_cluster
