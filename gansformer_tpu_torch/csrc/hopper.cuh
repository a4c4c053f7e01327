// Hopper building blocks of the port's wgmma kernels (sm_90a only): a
// ring of shared-memory slots that one producer thread fills by TMA
// (cp.async.bulk.tensor, completion counted on mbarriers, boxes outside
// the tensor read as zeros) and consumer warpgroups drain with the
// warpgroup matrix multiply (wgmma.mma_async, bf16 operands read from
// shared memory through matrix descriptors, or A from registers after
// ldmatrix; fp32 accumulators in registers).  On the host side, the
// tensor maps (cuTensorMapEncodeTiled, cached per thread) and the opt-in
// to more than 48 KB of dynamic shared memory, shared by csrc/modconv.cu
// and csrc/modconv_bwd.cu.  Also the warp-level pieces of the kernels
// that need no warpgroup: cp.async with zero fill (csrc/upfirdn.cu,
// csrc/attention.cu, csrc/attention_bwd.cu), mma.sync with ldmatrix, the
// swizzle and the hi + lo bf16 split of the attention kernels, and the
// key tiling of the latent->grid kernels.
//
// Operand layout: the 128-byte swizzle that TMA writes and wgmma reads.
// A tile is stored as rows of 128 bytes (64 bf16 along the row's
// contiguous axis) in 8-row atoms of 1 KB aligned to 1 KB, the 16-byte
// chunk c of row r at chunk c ^ (r % 8) of its row, so that the eight rows
// of a core matrix, and the eight chunks of one row, fall in distinct
// banks.  Wider tiles are blocks of 64 such rows, side by side.  For a
// K-major operand (K along the row) the descriptor's stride offset is the
// 1 KB between 8-row atoms and a 16-deep K step moves the start by 32
// bytes; for an MN-major operand (M or N along the row, transpose bit
// set) the leading offset is the stride between 64-element blocks and the
// stride offset the 1 KB between atoms along K.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier of a TMA ring slot: one arrival (the thread that issues the
// copies, announcing their bytes) completes a phase once those bytes land.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Named barrier `id` among the first `count` threads of the block (the
// consumer warpgroups of a warp-specialized kernel; barrier 0 is
// __syncthreads).
template <int id, int count>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(id), "n"(count) : "memory");
}

// Block until the phase of parity `parity` of the barrier has completed.
// A copy that never lands (a fault of the kernel) traps after about 2^34
// cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// The ring of S shared-memory slots between one producer thread, which
// lands stage j in slot j % S by TMA, and the consumer warpgroups, which
// run wgmma on it: full[s] completes a phase when the slot's bytes have
// landed, empty[s] when every consumer warpgroup has handed the slot
// back.  The k-th use of a slot (stage j = s + k S) waits for phase k of
// full[s], and its refill for phase k of empty[s].
template <int S>
struct TmaRing {
  uint64_t full[S], empty[S];

  // By one thread, before a __syncthreads.
  __device__ __forceinline__ void init(int consumer_groups) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumer_groups);
    }
    fence_mbar_init();
  }
  // Producer: wait until stage j's slot is free, announce its bytes, and
  // return the barrier its TMA copies complete.
  __device__ __forceinline__ uint64_t* acquire(int j, uint32_t bytes) {
    if (j >= S) mbar_wait(&empty[j % S], (j / S - 1) & 1);
    mbar_expect_tx(&full[j % S], bytes);
    return &full[j % S];
  }
  // Consumers: wait until stage j has landed.
  __device__ __forceinline__ void wait(int j) {
    mbar_wait(&full[j % S], (j / S) & 1);
  }
  // One thread of each consumer warpgroup, once the warpgroup's wgmma
  // that read stage j has completed.
  __device__ __forceinline__ void release(int j) {
    mbar_arrive(&empty[j % S]);
  }
};

// TMA: a box of a tensor map (a __grid_constant__ kernel parameter) into
// shared memory, completing `bytes` of the barrier's transaction count;
// coordinates outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region (the registers change without its knowledge
// between the issue and the wait).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (each in 16-byte units, 14
// bits), layout type 1 (128-byte swizzle), base offset 0 (atoms 1 KB
// aligned).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D[64 x N] += A[64 x 16] * B[16 x N], bf16 operands from shared memory,
// fp32 accumulators in registers.  TransA / TransB = 1: the operand is
// MN-major (M or N contiguous in the chunks).  Accumulator i of thread
// l of warp w (of the warpgroup) is row w * 16 + (l % 32) / 4 + 8 * (i %
// 4 / 2), column 8 * (i / 4) + 2 * (l % 4) + i % 2.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TransA), "n"(TransB));
}

template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TransA), "n"(TransB));
}

template <int BN, int TransA, int TransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  static_assert(BN == 64 || BN == 128, "wgmma tile width");
  if constexpr (BN == 64)
    wgmma_m64n64k16<TransA, TransB>(d, da, db);
  else
    wgmma_m64n128k16<TransA, TransB>(d, da, db);
}

// D[64 x N] += A[64 x 16] * B[16 x N] with A from registers (bf16 pairs,
// the fragment ldmatrix_x4 loads: register q holds row (l % 32) / 4 + 8 *
// (q % 2) of the warp's 16 rows, columns 8 * (q / 2) + 2 * (l % 4) + {0,
// 1}) and B from shared memory; TransB = 1: B is N-major.  The registers
// must not change until a wgmma_wait covers the instruction.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TransB));
}

template <int BN, int TransB>
__device__ __forceinline__ void wgmma_tile_rs(float (&d)[BN / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(BN == 64 || BN == 128, "wgmma tile width");
  if constexpr (BN == 64)
    wgmma_m64n64k16_rs<TransB>(d, a, db);
  else
    wgmma_m64n128k16_rs<TransB>(d, a, db);
}

// Four 8 x 8 bf16 matrices from shared memory into the A fragment of
// wgmma_tile_rs: lane l gives the address of row l % 16 of the 16-row
// slice, at column 8 * (l / 16).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t saddr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr));
}

// The same four matrices transposed on the way (ldmatrix .trans): lane l
// gives the address of a row of a k-major [k][n] operand, and each thread
// receives the B fragment of mma_m16n8k16 (k pairs of one column n).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t saddr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr));
}

// D[16 x 8] += A[16 x 16] * B[16 x 8] on the tensor cores of one warp
// (mma.sync, bf16 operands, fp32 accumulators).  Fragments, with g = lane
// / 4 and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)} as bf16 pairs, b = {(k 2t.., n g), (k 2t + 8.., n
// g)}, d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global into shared memory without passing registers
// (cp.async, cached in L2 only); with `bytes` 0 nothing is read and the
// 16 bytes are zero-filled, so a load past an edge or a pad costs no
// branch.  A thread's copies complete in commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes the same way (cp.async.ca), zero-filled where `bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The wait of a cp.async ring of `stages` slots (3 or 4) that runs
// stages - 1 commit groups ahead, one group a stage: the oldest stage has
// landed once at most stages - 2 groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4)
    cp_async_wait<2>();
  else
    cp_async_wait<1>();
}

// Byte offset of 16-byte chunk `c` of row `r` in a shared-memory operand
// whose rows are `row_bytes` long (a multiple of 128): the chunk index is
// XOR-ed with r % 8, so the 8 rows of an ldmatrix 8 x 8 matrix, and the 8
// chunks of one row, fall in distinct banks (csrc/attention.cu,
// csrc/attention_bwd.cu).
__device__ __forceinline__ int swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x as the sum of two bf16 terms, hi = bf16(x) and lo = bf16(x - hi)
// (x - hi is exact in fp32): a tensor-core product of hi and of lo, summed
// in fp32, carries x to about 2^-17 of itself, where one bf16 rounding
// would keep 2^-9.
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  *hi = __float2bfloat16(x);
  *lo = __float2bfloat16(x - __bfloat162float(*hi));
}

// ---- host side: tensor maps and shared-memory opt-in ----------------------

// Dynamic shared memory of a launch, checked against the card's limit.
// cudaFuncSetAttribute acts on the current device only, so a launcher
// calls this at every launch and never keeps its result in a static:
// a result cached on one device would skip the opt-in on the others.
constexpr int kMaxSmem = 232448;

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The key tiling of the latent->grid tensor-core kernels, forward
// (csrc/attention.cu) and backward (csrc/attention_bwd.cu): a block of
// kKeyWarps warps walks a span of tiles of `kt` keys of one batch entry,
// each tile's K and V rows landed whole in one slot of a cp.async ring.
// kt is the largest of 64, 32, 16 whose ring has at least kKeyMinStages
// slots beside the kernel's `fixed` bytes (at most kKeyMaxStages), so
// two or three tiles are in flight while one is multiplied.  Spans: one
// block an SM over the batch (a block takes 120-227 KB), each span at
// least kKeySpanBytes of K and V; a batch entry of at most
// kKeyOneSpanTiles tiles runs in one span and needs no combine (such a
// launch is set by the host's time per launch, not the card's; a block
// takes 2-5 us a tile, so longer entries split).  The wrapper (ops/cuda_attention.py key_tiling)
// mirrors this; the plans are exported (gt_l2g_plan, gt_l2g_bwd_plan).
constexpr int kKeyWarps = 8;
constexpr int kKeyMinStages = 3;
constexpr int kKeyMaxStages = 4;
constexpr int kKeySpanBytes = 262144;
constexpr int kKeyOneSpanTiles = 8;
constexpr int kKeyPad = 8;          // bf16 padding of a P / dS row
constexpr int kKeyMaxLp = 32;       // latents, padded to 16 or 32
constexpr int kKeyMaxCols = 512;    // D and Dv: 8 warps x 64 columns
constexpr int kKeySms = 132;

// cp.async of rows key0 .. key0 + kt - 1 of batch entry b of k [B, n, D]
// and v [B, n, Dv] into the K and V parts of a ring slot, swizzled, rows
// past n zero-filled: 8 threads a row, nthreads / 8 rows a pass (by
// default all the block's kKeyWarps warps; D and Dv are multiples of 64,
// so a row is whole passes of 8 chunks and no thread divides).
__device__ __forceinline__ void load_key_tile(
    unsigned char* kslot, unsigned char* vslot,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    int b, int n, int key0, int kt, int D, int Dv, int tid = threadIdx.x,
    int nthreads = kKeyWarps * 32) {
  for (int r = tid >> 3; r < kt; r += nthreads >> 3) {
    const bool in = key0 + r < n;
    const size_t row = (size_t)b * n + (in ? key0 + r : 0);
    for (int c = tid & 7; c < D / 8; c += 8)
      cp_async16(kslot + swz(r, c, D * 2), k + row * D + c * 8, in ? 16 : 0);
    for (int c = tid & 7; c < Dv / 8; c += 8)
      cp_async16(vslot + swz(r, c, Dv * 2), v + row * Dv + c * 8,
                 in ? 16 : 0);
  }
}

// cp.async of the L rows of `width` bf16 of `src` into a swizzled
// resident operand of LP rows, the rows past L zeroed.
__device__ __forceinline__ void load_latent_rows(
    unsigned char* dst, const __nv_bfloat16* __restrict__ src, int L, int LP,
    int width) {
  const int tid = threadIdx.x, ch = width / 8;
  for (int i = tid; i < L * ch; i += blockDim.x)
    cp_async16(dst + swz(i / ch, i % ch, width * 2), src + (size_t)i * 8,
               16);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < (LP - L) * ch; i += blockDim.x)
    reinterpret_cast<uint4*>(dst + L * width * 2)[i] = zero;
}

// The latents padded to the kernels' bucket (16 or 32).
inline int key_lp(int L) { return L <= 16 ? 16 : 32; }

// The shapes the tensor-core kernels take (bf16 is checked by the
// caller): L <= 32, D and Dv multiples of 64 and at most 512.
inline bool key_shape_ok(int L, int D, int Dv) {
  return L >= 1 && L <= kKeyMaxLp && D > 0 && Dv > 0 && D % 64 == 0 &&
         Dv % 64 == 0 && D <= kKeyMaxCols && Dv <= kKeyMaxCols;
}

struct KeyTiling {
  int kt, stages, tps, spans;   // kt = 0: no tile fits
  size_t smem;
};

template <typename Fixed>
inline KeyTiling key_tiling(Fixed fixed, int key_bytes, int B, int n) {
  KeyTiling t{0, 0, 0, 0, 0};
  for (int kt = 64; kt >= 16; kt /= 2) {
    const size_t stage = (size_t)kt * key_bytes, f = fixed(kt);
    if (f >= (size_t)kMaxSmem) continue;
    size_t s = ((size_t)kMaxSmem - f) / stage;
    if (s > (size_t)kKeyMaxStages) s = kKeyMaxStages;
    if (s >= (size_t)kKeyMinStages) {
      t.kt = kt;
      t.stages = (int)s;
      t.smem = f + s * stage;
      break;
    }
  }
  if (t.kt == 0 || n < 1 || B < 1) return t;
  const int tiles = (n + t.kt - 1) / t.kt;
  const int spans_max = kKeySms / B > 1 ? kKeySms / B : 1;
  const long long stage = (long long)t.kt * key_bytes;
  const int min_tps = (int)((kKeySpanBytes + stage - 1) / stage);
  int tps = (tiles + spans_max - 1) / spans_max;
  if (tps < min_tps) tps = min_tps;
  if (tps > tiles || tiles <= kKeyOneSpanTiles) tps = tiles;
  t.tps = tps;
  t.spans = (tiles + tps - 1) / tps;
  return t;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links only the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor map of a dense bf16 tensor with `rank` dims (innermost first),
// read in boxes of `box` elements with the 128-byte swizzle; outside the
// tensor a box reads zeros (a box may be larger than the tensor).
// Encoding one costs the host tens of microseconds, as much as the whole
// launch of a small layer, so the maps are kept in a small per-thread
// cache keyed by everything that defines them (address, dims, box);
// PyTorch's caching allocator hands a training step the same addresses
// step after step.
struct MapKey {
  const void* ptr;
  int rank;
  cuuint64_t dims[4];
  cuuint32_t box[4];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank) return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    return true;
  }
};

constexpr int kMapCache = 64;

inline int bf16_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, const cuuint32_t* box) {
  struct Entry {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  thread_local Entry cache[kMapCache] = {};
  MapKey key{ptr, rank, {0, 0, 0, 0}, {0, 0, 0, 0}};
  unsigned long long h = reinterpret_cast<unsigned long long>(ptr) >> 8;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    h = h * 1000003ull ^ (dims[i] * 31ull + box[i]);
  }
  Entry& e = cache[h % kMapCache];
  if (e.used && e.key == key) {
    *map = e.map;
    return 0;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t strides[4];
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  cuuint64_t bytes = 2;
  for (int i = 0; i + 1 < rank; ++i) {
    bytes *= dims[i];
    strides[i] = bytes;
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  e.key = key;
  e.map = *map;
  e.used = true;
  return 0;
}

// Map of an NHWC activation [N, H, W, Ch] in boxes of 64 channels x
// `pixels` pixels (whole rows, or a run of one row).
inline int nhwc_map(CUtensorMap* map, const void* ptr, int N, int H, int W,
                    int Ch, int pixels) {
  const int bw = W < pixels ? W : pixels;
  const cuuint64_t dims[4] = {(cuuint64_t)Ch, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)(pixels / bw),
                             1};
  return bf16_map(map, ptr, 4, dims, box);
}
