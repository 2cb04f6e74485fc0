// A Hopper (sm_90a) GEMM mainloop for bf16 operands with f32 sums: TMA
// loads into a ring of shared-memory stages, wgmma products, the sums left
// in registers for an epilogue that the caller supplies.
//
// A block of kThreads = 288 threads walks BM x BN = 128 x 128 output
// tiles (persistent: as many blocks as the card holds at once, each taking
// every gridDim.x-th tile) and the reduction of each in steps of BK = 64:
//
// - warp 8, the producer: one thread issues, for each step, four TMA
//   loads (cp.async.bulk.tensor, 64 x 64 bf16 boxes, 128-byte swizzle)
//   into one of the ring's stages (kStages = 3; 2 where a staged
//   epilogue's buffers leave no room for the third, ring_stages), after
//   waiting on that stage's `empty` mbarrier; the loads complete on its
//   `full` mbarrier;
// - warps 0-7, two consumer warpgroups: each waits on `full`, issues four
//   wgmma.mma_async m64n128k16 (its 64 rows of the tile), waits for them
//   with wgmma.wait_group and only then releases the stage on `empty`
//   (one arrival per warp), then runs the epilogue on its registers. The
//   producer's ring runs on across tiles, so the next tile's loads overlap
//   this tile's epilogue.
//
// An epilogue either reads and writes device memory itself from its
// registers, or (Epi::kStagedBytes > 0) has TMA bring its inputs into
// shared memory and take its outputs out, double-buffered across tiles
// (tma_wgmma_gemm says how); a lane's loads then wait on one barrier
// instead of on each load's latency in turn. Every epilogue also gets an
// 8 KB scratch region of shared memory (kScratchBytes: 16 x 128 f32, what
// a cross-warp column sum of the tile needs), its own for the tile.
//
// Operands. A(i, r) is [rows][R] or [R][rows] in memory, B(r, j) is
// [cols][R] or [R][cols]: each is "K-major" (the reduction index r is the
// contiguous one) or "MN-major", chosen by the template flags KA and KB
// and passed to wgmma as its transpose bits (allowed for 16-bit types).
// Both layouts come from the same TMA map over the row-major matrix as it
// lies in memory; only the box coordinates and the shared-memory
// descriptors differ:
//
// - K-major: a stage holds [128 rows][64 r], 128 bytes a row, in 8-row
//   swizzle atoms of 1 KB (SBO = 1 KB); the k16 step j starts 32 * j bytes
//   into the atom;
// - MN-major: a stage holds two boxes of [64 r][64 rows], each 8 KB; the
//   atoms are 8 r x 64 rows (SBO = 1 KB between atoms along r, LBO = 8 KB
//   between the two 64-row boxes); the k16 step j starts 2 KB * j in.
//
// Edges: TMA fills every element outside the matrix with zeros, so a
// ragged M, K or N (or a reduction that ends inside a step) adds nothing;
// an epilogue stores nothing out of range (a TMA store writes nothing
// there). TMA needs every row stride a multiple of 16 bytes and a
// 16-byte-aligned base: the caller checks.
//
// The sums: sm90::Frag names the register layout (the PTX ISA's m64nNk16
// f32 accumulator): acc[4 * j + 2 * h + e] of thread (warp w of its
// warpgroup, lane l) is row 16 * w + l / 4 + 8 * h of the warpgroup's 64,
// column 8 * j + 2 * (l % 4) + e, for j < 16 and h, e in {0, 1}.
// Frag::quad regroups them into four consecutive columns a lane, so that
// an epilogue moves whole 32-byte sectors.
//
// The reduction over r runs in one fixed order (the steps in turn, k16 by
// k16 inside each), so two launches give the same bits.
//
// Users: fused_block.cu's K4 and K6 (one GEMM each with a column-sum
// epilogue), K5 (one GEMM with a staged epilogue) and K7 (three GEMMs);
// lstm_bwd.cu's dWh (one GEMM). flash_attn_fwd.cu takes only the building
// blocks (the barriers, the 4-D TMA load and store, the descriptors, wgmma
// m64n64k16 from shared memory and m64n{64,128,256}k16 with A from
// registers), not the mainloop, and so do the LSTM's cluster kernels
// (lstm_cluster.cuh: the barriers, the descriptors, the bulk-group waits).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing links libcuda
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

constexpr int BM = 128;                    // tile rows (two warpgroups)
constexpr int BN = 128;                    // tile columns (wgmma n)
constexpr int BK = 64;                     // reduction step
constexpr int kStages = 3;                 // ring depth (ring_stages)
constexpr int kConsumers = 256;            // two warpgroups (warps 0-7)
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kBox = 64;                   // TMA box: 64 x 64 bf16
constexpr uint32_t kBoxBytes = kBox * kBox * 2;   // 8 KB
constexpr uint32_t kTileBytes = 2 * kBoxBytes;    // one operand's stage
constexpr uint32_t kStageBytes = 2 * kTileBytes;  // A and B
constexpr int kCols = 8;                   // per-column f32 vectors
constexpr uint32_t kScratchBytes = 16 * BN * sizeof(float);  // 8 KB
constexpr size_t kMaxSmem = 232448;        // the most a block may have
// a barrier wait that lasts this many cycles (~5 s) is a fault: trap
// rather than hang the card
constexpr long long kHangCycles = 1LL << 33;

struct Frag {
  // the tile row of acc[4 * j + 2 * h + e] for this thread
  __device__ __forceinline__ static int row(int wg, int h) {
    return 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
           8 * h;
  }
  // Four consecutive columns of row(wg, h) out of n8 blocks 2m and 2m + 1:
  // the lanes of each pair (t, t ^ 1) of a quad swap one column pair, so
  // that lane t holds columns col4(m) .. col4(m) + 3 in v, and a quad's
  // lanes cover 16 consecutive columns of the row (a full 32-byte sector of
  // bf16). Every lane of the warp must call it (it shuffles).
  __device__ __forceinline__ static int col4(int m) {
    const int t = threadIdx.x & 3;
    return 8 * (2 * m + (t & 1)) + 4 * (t >> 1);
  }
  __device__ __forceinline__ static void quad(const float (&acc)[64], int h,
                                              int m, float (&v)[4]) {
    const bool odd = threadIdx.x & 1;
    const int a = 8 * m + 2 * h, b = a + 4;  // blocks 2m and 2m + 1
    const float k0 = odd ? acc[b] : acc[a], k1 = odd ? acc[b + 1] : acc[a + 1];
    const float s0 = odd ? acc[a] : acc[b], s1 = odd ? acc[a + 1] : acc[b + 1];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    v[0] = odd ? r0 : k0;
    v[1] = odd ? r1 : k1;
    v[2] = odd ? k0 : r0;
    v[3] = odd ? k1 : r1;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// Waits until the phase of parity `parity` of barrier b has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  const long long t0 = clock64();
  while (true) {
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
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// One 64 x 64 box at (c0, c1) (c0 the contiguous coordinate) of map into
// dst, completing on barrier b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* b, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(b)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the sums across the
// asynchronous products (they are only known done after wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A(64 x 16) B(16 x 128), both from shared memory; TA / TB are the
// transpose bits (0: K-major, 1: MN-major); scale-d is 1 (accumulate).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// The products attention needs (flash_attn_fwd.cu): S = Q K^T on m64n64
// with both operands in shared memory, and O += P V with P, the rounded
// softmax weights, from registers: the m64n64 f32 sum fragment holds, for
// each k16 step, exactly the bf16 A fragment's rows and columns (the PTX
// ISA's layouts), so P needs no shuffle or shared-memory round trip.
// d += A(64 x 16) B(16 x 64), both from shared memory; TA / TB as for
// wgmma_m64n128k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// d += A(64 x 16) B(16 x 64): A from registers (the bf16 A fragment,
// four 32-bit words of two values a thread), B from shared memory with
// transpose bit TB.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1));
}

// d += A(64 x 16) B(16 x 128): A from registers (the bf16 A fragment,
// four 32-bit words of two values a thread), B from shared memory with
// transpose bit TB.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1));
}

// d += A(64 x 16) B(16 x 256): A from registers (the bf16 A fragment,
// four 32-bit words of two values a thread), B from shared memory with
// transpose bit TB. K3's wide kernel: one slice of 256 output columns.
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %133;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1));
}

// Keeps the A fragment's registers live, and unmoved, up to this point: a
// wgmma with A from registers reads them asynchronously, so they must not
// be reused before the wgmma_wait that covers it (call this after it).
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The tiles of a rows x cols output in `splits` chunks of the reduction R,
// columns fastest, then rows, then splits: tile -> its origin, its split
// and its reduction steps.
struct Tiles {
  int cols_n, rows_n, R, chunk;
  __device__ __forceinline__ void at(int tile, int& i0, int& j0, int& z,
                                     int& r_begin, int& steps) const {
    j0 = (tile % cols_n) * BN;
    i0 = ((tile / cols_n) % rows_n) * BM;
    z = tile / (cols_n * rows_n);
    r_begin = z * chunk;
    steps = (min(R, r_begin + chunk) - r_begin + BK - 1) / BK;
  }
};

// One 64 x 64 box of shared memory at src to (c0, c1) of map (TMA store;
// the parts outside the matrix are not written), in the thread's bulk
// group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until the bulk stores have read their shared memory (.read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// The 4-D forms (flash_attn_fwd.cu's [b, T, h, dh] maps): one box at
// (c0, c1, c2, c3), c0 the contiguous coordinate.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* b, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(b)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// generic-proxy writes to shared memory, made visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The byte offset of element (r, c) of a 128 x 128 bf16 tile kept as four
// 64 x 64 TMA boxes (row-major by box) in the 128-byte swizzle.
__device__ __forceinline__ uint32_t staged_off(int r, int c) {
  const int rr = r & 63, cb = (c & 63) * 2;
  return ((r >> 6) * 2 + (c >> 6)) * kBoxBytes + rr * 128 +
         ((((cb >> 4) ^ (rr & 7)) << 4) | (cb & 15));
}

// Shared memory beside the ring and the staging buffers: the alignment
// slack, the barriers, cv and the epilogue's scratch.
constexpr size_t kFixedBytes = 1024 + (2 * kStages + 4) * sizeof(uint64_t) +
                               kCols * BN * sizeof(float) + kScratchBytes;

// The ring's depth: kStages, unless an epilogue's two staging buffers leave
// no room for them (64 KB buffers, K6's and K7's dz pass: 2 stages; 32 KB,
// K5's: 3).
template <typename Epi>
__host__ __device__ constexpr int ring_stages() {
  return kStages * kStageBytes + 2 * Epi::kStagedBytes + kFixedBytes <=
                 kMaxSmem
             ? kStages
             : 2;
}

template <typename Epi>
constexpr size_t smem_bytes() {
  return ring_stages<Epi>() * kStageBytes + 2 * Epi::kStagedBytes +
         kFixedBytes;
}

// Persistent: block b takes tiles b, b + gridDim.x, ... For each tile,
// acc = sum over r in [z * chunk, min(R, (z + 1) * chunk)) of A(i, r)
// B(r, j), then epi.store(acc, cv, staged, scratch, i0, j0, z, wg), where
// scratch is kScratchBytes of shared memory that no one else touches
// between the consumers' barrier at the start of the tile and the one at
// the start of the next. A is read through map ma, B through mb (see the
// head of this file for KA / KB).
// The producer runs up to ring_stages steps ahead, across tiles, so the
// next tile's loads overlap this tile's epilogue. At the start of each
// tile the consumers call epi.stage(cv, j0), which may fill
// cv[kCols][BN] with per-column f32 vectors. chunk must be a multiple of
// BK when there are several splits, so that no step reads a row of the
// next split.
//
// An epilogue with Epi::kStagedBytes > 0 has its tile's inputs and
// outputs moved by TMA through shared memory, in two buffers of that
// size: tile n uses buffer n % 2. For tile n the producer waits until TMA
// has read buffer n % 2 out for tile n - 2, has epi.load_staged bring in
// tile n's inputs (on staged_full), issues the tile's ring steps, then
// waits until the consumers are done with tile n - 1 (staged_done) and
// has epi.store_staged write that buffer out. So tile n's inputs arrive
// while the consumers work on tile n - 1. Such a kernel holds one block
// a multiprocessor; the others two (smem_bytes stays under half of the
// multiprocessor's 228 KB).
template <bool KA, bool KB, typename Epi>
__global__ void __launch_bounds__(kThreads, Epi::kStagedBytes ? 1 : 2)
    tma_wgmma_gemm(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb, Tiles tl,
                   int tiles, const __grid_constant__ Epi epi) {
  constexpr bool kStaged = Epi::kStagedBytes > 0;
  constexpr int kRing = ring_stages<Epi>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staged = ring + kRing * kStageBytes;  // two buffers
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staged + 2 * Epi::kStagedBytes);
  uint64_t* empty = full + kStages;
  uint64_t* staged_full = empty + kStages;  // [2]
  uint64_t* staged_done = staged_full + 2;  // [2]
  float(*cv)[BN] = reinterpret_cast<float(*)[BN]>(staged_done + 2);
  float* scratch = &cv[kCols][0];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      mbar_init(&staged_full[q], 1);
      mbar_init(&staged_done[q], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int i0, j0, z, r_begin, steps;
  int step = 0;  // the ring's steps so far: stage step % kRing, round
                 // step / kRing
  int n = 0;     // this block's tiles so far
  const int warp = threadIdx.x >> 5;
  if (warp == kConsumers / 32) {
    if ((threadIdx.x & 31) != 0) return;
    int prev_i0 = 0, prev_j0 = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      tl.at(tile, i0, j0, z, r_begin, steps);
      if constexpr (kStaged) {
        const int q = n & 1;
        bulk_wait_read();  // tile n - 2's store has read buffer q
        mbar_expect_tx(&staged_full[q], Epi::kStagedBytes);
        epi.load_staged(staged + q * Epi::kStagedBytes, &staged_full[q], i0,
                        j0);
      }
      for (int t = 0; t < steps; ++t, ++step) {
        const int s = step % kRing;
        // round n of stage s waits for the consumers to release round
        // n - 1 (parity 1 passes at once on a fresh barrier)
        mbar_wait(&empty[s], ((step / kRing) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageBytes);
        unsigned char* a = ring + s * kStageBytes;
        unsigned char* b = a + kTileBytes;
        const int r = r_begin + t * BK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (KA)
            tma_load(a + h * kBoxBytes, &ma, &full[s], r, i0 + kBox * h);
          else
            tma_load(a + h * kBoxBytes, &ma, &full[s], i0 + kBox * h, r);
          if (KB)
            tma_load(b + h * kBoxBytes, &mb, &full[s], r, j0 + kBox * h);
          else
            tma_load(b + h * kBoxBytes, &mb, &full[s], j0 + kBox * h, r);
        }
      }
      if constexpr (kStaged) {
        if (n > 0) {
          const int q = (n - 1) & 1;
          mbar_wait(&staged_done[q], ((n - 1) >> 1) & 1);
          epi.store_staged(staged + q * Epi::kStagedBytes, prev_i0, prev_j0);
          bulk_commit();
        }
      }
      prev_i0 = i0;
      prev_j0 = j0;
    }
    if constexpr (kStaged) {
      if (n > 0) {
        const int q = (n - 1) & 1;
        mbar_wait(&staged_done[q], ((n - 1) >> 1) & 1);
        epi.store_staged(staged + q * Epi::kStagedBytes, prev_i0, prev_j0);
        bulk_commit();
      }
      bulk_wait_all();
    }
    return;
  }

  const int wg = warp >> 2;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    tl.at(tile, i0, j0, z, r_begin, steps);
    consumer_sync();  // every consumer is done with the last tile's cv
    epi.stage(cv, j0);
    consumer_sync();
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < steps; ++t, ++step) {
      const int s = step % kRing;
      mbar_wait(&full[s], (step / kRing) & 1);
      __syncwarp();  // wgmma is .aligned: the warp issues it together
      const unsigned char* a = ring + s * kStageBytes + wg * kBoxBytes;
      const unsigned char* b = ring + s * kStageBytes + kTileBytes;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t da = KA ? smem_desc(a + 32 * k, 16, 1024)
                               : smem_desc(a + 2048 * k, kBoxBytes, 1024);
        const uint64_t db = KB ? smem_desc(b + 32 * k, 16, 1024)
                               : smem_desc(b + 2048 * k, kBoxBytes, 1024);
        wgmma_m64n128k16<KA ? 0 : 1, KB ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
    }
    const int q = n & 1;
    if constexpr (kStaged) {
      mbar_wait(&staged_full[q], (n >> 1) & 1);
      __syncwarp();
    }
    epi.store(acc, cv, staged + q * Epi::kStagedBytes, scratch, i0, j0, z,
              wg);
    if constexpr (kStaged) {
      fence_proxy_async();
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&staged_done[q]);
    }
  }
}

// cuTensorMapEncodeTiled from the CUDA driver (libcuda) the process has loaded
// (libcuda is not linked: the library keeps a plain C interface).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiledFn>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A TMA map over a row-major bf16 matrix [rows][cols] (rows of cols * 2
// bytes, a multiple of 16), 64 x 64 boxes, 128-byte swizzle, zeros
// outside.
//
// The map holds the address it was encoded from, and it reaches the
// kernel as a __grid_constant__ argument. When a train step is captured
// as a CUDA graph (nn/multistep.py) the map is encoded once, at capture,
// and every replay reads through it again: sound only because every
// operand of a captured step is a graph input buffer or a tensor of the
// graph's private pool, which keeps its address for the graph's life.
inline cudaError_t make_map(CUtensorMap* map, const void* p, int rows,
                            int cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches tma_wgmma_gemm over a rows x cols output in `splits` chunks of
// the reduction R: as many blocks as fit on the card at once, or one a
// tile if there are fewer tiles. Which block takes a tile does not change
// what the tile sums, or its order.
template <bool KA, bool KB, typename Epi>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, int rows,
                   int cols, int R, int chunk, int splits, const Epi& epi,
                   cudaStream_t st) {
  auto kern = tma_wgmma_gemm<KA, KB, Epi>;
  constexpr size_t smem = smem_bytes<Epi>();
  static_assert(smem <= kMaxSmem, "the epilogue's buffers do not fit");
  // a multiprocessor holds 228 KB, 1 KB of it reserved for each block
  static_assert(Epi::kStagedBytes > 0 || 2 * (smem + 1024) <= 228 * 1024,
                "two blocks of an unstaged epilogue no longer fit");
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const Tiles tl{(cols + BN - 1) / BN, (rows + BM - 1) / BM, R, chunk};
  const long long tiles =
      static_cast<long long>(tl.cols_n) * tl.rows_n * splits;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(sms) * per_sm ? tiles : sms * per_sm);
  kern<<<grid, kThreads, smem, st>>>(ma, mb, tl, static_cast<int>(tiles),
                                     epi);
  return cudaGetLastError();
}

}  // namespace sm90
