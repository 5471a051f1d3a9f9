// Tensor-core, async-copy and bfloat16 building blocks of the hand-written
// Hopper kernels (csrc/mma_probe.cu, csrc/conv3d.cu, csrc/siren_wg.cu), each
// a small __device__ function around one PTX instruction so that a host
// compiler can be given a C++ body for it instead (the CPU emulation in
// tests/cuda_emulation/cuda_runtime.h):
//   mma_bf16  mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//   mma_s8    mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   ldsm_x4, ldsm_x4_trans
//             ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: four 8 x 8
//             16-bit matrices, lanes 8i .. 8i + 7 giving the rows of matrix i
//   cp_async16, cp_async_commit, cp_async_wait
//             cp.async.cg.shared.global of 16 bytes, zero-filled when the
//             source is out of range, and its commit/wait groups
//   wgmma_desc_sw128, wgmma_desc_sw64, wgmma_desc_plain
//             the shared-memory matrix descriptor of an operand in the
//             128- or 64-byte swizzled layout, or unswizzled (below)
//   wgmma_bf16_m64n128k16, wgmma_s8_m64n128k32
//             wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 and
//             .m64n128k32.s32.s8.s8, both operands from shared memory, both
//             K-major; wgmma_bf16_m64n128k16_t<TRANS_A, TRANS_B> the bf16 one
//             with either operand MN-major (the instruction's transpose bits)
//   wgmma_bf16_m64n96k16
//             .m64n96k16.f32.bf16.bf16, both operands K-major from shared
//             memory, always accumulating
//   wgmma_fence, wgmma_commit, wgmma_wait, wgmma_fence_operands
//             wgmma.fence / commit_group / wait_group, and a compiler-only
//             fence that keeps the accumulators' reads after a wait
//   fence_proxy_async
//             fence.proxy.async.shared::cta: shared-memory writes of the
//             threads (cp.async included) made visible to wgmma's reads
//   named_barrier_sync
//             bar.sync id, n: a barrier of n threads (a warpgroup) of the block
//   setmaxnreg_inc, setmaxnreg_dec
//             setmaxnreg.inc / .dec.sync.aligned.u32: a warpgroup's registers
//             a thread raised or lowered to N (a multiple of 8, 24-256)
//   mbar_init, mbar_init_fence, mbar_arrive, mbar_arrive_expect_tx, mbar_wait
//             mbarrier.init / fence.mbarrier_init / mbarrier.arrive[.expect_tx]
//             / a loop of mbarrier.try_wait.parity on a 64-bit shared barrier
//   tma_load_3d, tma_load_5d, tma_store_3d, bulk_commit, bulk_wait_read, bulk_wait
//             cp.async.bulk.tensor.3d / .5d (TMA): one box of a tensor map
//             from global to shared memory, completing its bytes on a
//             barrier, or from shared to global memory in a bulk group, and
//             that group's commit and waits; the host builds the map with
//             encode_tensor_map (any rank 3-5) or encode_tensor_map_3d.
//   bulk_load cp.async.bulk.shared.global (a plain bulk copy, no tensor map):
//             16-byte aligned bytes from global to shared memory, completing
//             on a barrier
//   spin_pause
//             nanosleep.u32 in a loop that waits on another block (in the
//             emulation: the block's other fibers and the other blocks of a
//             cooperative launch run)
// The mma and wgmma are asm volatile: every product really runs, none is
// hoisted out of a loop or merged with another.
//
// The 128-byte swizzled K-major layout (wgmma's canonical SW128 K-major
// layout): a tile of rows x 128 bytes of depth (64 bf16 or 128 int8), row r
// at byte r * 128, its 16-byte chunk c at chunk c ^ (r % 8), the tile's base
// 1024-byte aligned. The descriptor's stride byte offset is 1024 (one 8-row
// group), its leading byte offset unused (1); a k step of 32 bytes (16 bf16
// or 32 int8) is the tile's descriptor plus 2 (its start address in 16-byte
// units): the hardware swizzles the final address, bits 4-6 ^= bits 7-9.
//
// The 64-byte swizzled layouts (what a TMA box of 64-byte rows writes with
// CU_TENSOR_MAP_SWIZZLE_64B): rows of 64 bytes (32 bf16), row r at byte
// r * 64, the final address's bits 4-5 ^= bits 7-8 (the pattern repeats
// every 512 bytes: keep each box 512-byte aligned). K-major (depth along
// the row): a tile of rows x 32 bf16 of depth, stride byte offset 512 (one
// 8-row group), leading byte offset unused, a k step of 16 bf16 = 32 bytes.
// MN-major (the M or N index along the row, depth down the rows): boxes of
// 32 bf16 of M or N x d rows of depth, one box after another at lbo bytes;
// stride byte offset 512 (8 rows of depth), leading byte offset lbo (the
// next 32 of M or N), a k step of 16 rows = 1024 bytes.
//
// The unswizzled K-major layout: core matrices of 8 rows x 16 bytes (8
// bf16 of depth), each 128 contiguous bytes (row r of the core matrix at
// byte 16 r); the leading byte offset is the distance to the core matrix
// of the next 8 of depth, the stride byte offset to that of the next 8
// rows. Any 16-byte aligned start is a legal operand, so a run of rows 16
// bytes apart can be read from any row on.

#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda.h>  // CUtensorMap and its enums (cuTensorMapEncodeTiled is fetched at run time)
#endif

namespace {

// ---- bfloat16 bits -------------------------------------------------------------

__device__ __forceinline__ unsigned f2u(float f) {
#ifdef __CUDACC__
  return __float_as_uint(f);
#else
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
#endif
}

__device__ __forceinline__ float u2f(unsigned u) {
#ifdef __CUDACC__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

// bfloat16 bits -> float32 (exact) and float32 -> bfloat16 bits, rounded to
// nearest even (a NaN stays a NaN), as torch and XLA round.
__device__ __forceinline__ float bf16_to_f32(unsigned h) { return u2f(h << 16); }

__device__ __forceinline__ unsigned f32_to_bf16(float f) {
  unsigned u = f2u(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}

// bf16(v0) | bf16(v1) << 16, both rounded to nearest even, in one
// cvt.rn.bf16x2.f32 (a NaN becomes the canonical 0x7fff)
__device__ __forceinline__ unsigned bf16x2_rn(float v0, float v1) {
#ifdef __CUDACC__
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(v1), "f"(v0));
  return r;
#else
  const auto one = [](float f) {
    unsigned u = f2u(f);
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fffu;
    u += 0x7fffu + ((u >> 16) & 1u);
    return u >> 16;
  };
  return one(v0) | (one(v1) << 16);
#endif
}

// ---- mma.sync and ldmatrix (warp-wide) -----------------------------------------

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
#ifdef __CUDACC__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  emu_mma_bf16_m16n8k16(c, a, b);
#endif
}

// c (16 x 8, s32) += a (16 x 32, s8, row) b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4], const unsigned b[2]) {
#ifdef __CUDACC__
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  emu_mma_s8_m16n8k32(c, a, b);
#endif
}

// the shared-state-space address of a shared-memory pointer (in the
// emulation: its offset in the block's shared memory)
__device__ __forceinline__ unsigned shared_addr(const void* p) {
#ifdef __CUDACC__
  return (unsigned)__cvta_generic_to_shared(p);
#else
  return emu_shared_offset(p);
#endif
}

// r[i] = this lane's word of 8 x 8 matrix i (row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1); row is this lane's row address
// (16-byte aligned, 16 bytes)
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* row) {
#ifdef __CUDACC__
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(row)));
#else
  emu_ldmatrix_x4(r, row, false);
#endif
}

// the same for the transposed matrices: rows 2 (lane % 4) and 2 (lane % 4)
// + 1 of column lane / 4
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const void* row) {
#ifdef __CUDACC__
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(row)));
#else
  emu_ldmatrix_x4(r, row, true);
#endif
}

// ---- cp.async -----------------------------------------------------------------

// 16 bytes from global src to shared dst (both 16-byte aligned), or 16 zero
// bytes when !valid (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
#ifdef __CUDACC__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
#else
  emu_cp_async16(dst, src, valid ? 16 : 0);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// ---- wgmma (warpgroup-wide, sm_90a) ----------------------------------------------

// descriptor of the SW128 K-major tile at p (1024-byte aligned; see above)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return (uint64_t)((shared_addr(p) & 0x3ffff) >> 4)  // start address, 16-byte units
         | ((uint64_t)1 << 16)                         // leading byte offset (unused)
         | ((uint64_t)(1024 >> 4) << 32)               // stride byte offset: 8 rows
         | ((uint64_t)1 << 62);                        // layout: 128-byte swizzle
}

// descriptor of a 64-byte swizzled tile at p (512-byte aligned but for a
// K-major k step; see above): lbo is the MN-major layout's byte offset of
// the next 32 of M or N (K-major: unused, 16)
__device__ __forceinline__ uint64_t wgmma_desc_sw64(const void* p, unsigned lbo = 16) {
  return (uint64_t)((shared_addr(p) & 0x3ffff) >> 4)  // start address, 16-byte units
         | ((uint64_t)((lbo >> 4) & 0x3fff) << 16)     // leading byte offset
         | ((uint64_t)(512 >> 4) << 32)                // stride byte offset: 8 rows
         | ((uint64_t)2 << 62);                        // layout: 64-byte swizzle
}

// descriptor of an unswizzled K-major operand at p (16-byte aligned; see
// above): lbo bytes to the next 8 of depth, sbo bytes to the next 8 rows
__device__ __forceinline__ uint64_t wgmma_desc_plain(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((shared_addr(p) & 0x3ffff) >> 4)  // start address, 16-byte units
         | ((uint64_t)((lbo >> 4) & 0x3fff) << 16)     // leading byte offset
         | ((uint64_t)((sbo >> 4) & 0x3fff) << 32);    // stride byte offset; layout 0
}

// shared-memory writes of this thread made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
#ifdef __CUDACC__
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// the n threads (whole warps) that name barrier id (1-15; 0 is
// __syncthreads) meet here
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
#ifdef __CUDACC__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#else
  emu_named_barrier(id, n);
#endif
}

// every thread of the warpgroup: this warpgroup's registers a thread become
// N (inc: wait until the block's pool has them; dec: give them back)
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
#ifdef __CUDACC__
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
#ifdef __CUDACC__
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

// before the first wgmma, and after the accumulators were touched by others
__device__ __forceinline__ void wgmma_fence() {
#ifdef __CUDACC__
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#ifdef __CUDACC__
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#else
  emu_wgmma_commit();
#endif
}

// wait until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
#ifdef __CUDACC__
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#else
  emu_wgmma_wait(N);
#endif
}

// the compiler keeps every access of d on its side of this point (after a
// wgmma_wait: no read of an accumulator moves above the wait)
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(int (&d)[N]) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
#endif
}

#define WG_OP(c, x) "+" c(x)
#define WG_OP8(c, d, i)                                                                  \
  WG_OP(c, d[i]), WG_OP(c, d[i + 1]), WG_OP(c, d[i + 2]), WG_OP(c, d[i + 3]),             \
      WG_OP(c, d[i + 4]), WG_OP(c, d[i + 5]), WG_OP(c, d[i + 6]), WG_OP(c, d[i + 7])
#define WG_OP64(c, d)                                                                    \
  WG_OP8(c, d, 0), WG_OP8(c, d, 8), WG_OP8(c, d, 16), WG_OP8(c, d, 24), WG_OP8(c, d, 32), \
      WG_OP8(c, d, 40), WG_OP8(c, d, 48), WG_OP8(c, d, 56)
#define WG_D64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32; this thread's 64 of it) = a (64 x 16, bf16) b (16 x 128,
// bf16) + (accumulate ? d : 0); a and b K-major SW128 tiles. Thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 i + 2 (t % 4) (+ 1): d[4 i + 2 h + e] is row + 8 h, column + e.
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float (&d)[64], uint64_t da,
                                                      uint64_t db, int accumulate) {
#ifdef __CUDACC__
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_OP64("f", d)
      : "l"(da), "l"(db), "r"(accumulate));
#else
  emu_wgmma(EMU_WGMMA_BF16, d, da, db, accumulate, 128);
#endif
}

// the same with int8 operands and exact int32 sums, k 32
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
#ifdef __CUDACC__
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64 ", %64, %65, p;\n}\n"
      : WG_OP64("r", d)
      : "l"(da), "l"(db), "r"(accumulate));
#else
  emu_wgmma(EMU_WGMMA_S8, d, da, db, accumulate, 128);
#endif
}

// wgmma_bf16_m64n128k16 with A (TRANS_A = 1) or B (TRANS_B = 1) MN-major:
// the descriptor then describes a tile whose rows run along the depth
// (wgmma takes a transposed operand only in 16-bit types)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_m64n128k16_t(float (&d)[64], uint64_t da,
                                                        uint64_t db, int accumulate) {
#ifdef __CUDACC__
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_OP64("f", d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
#else
  emu_wgmma(EMU_WGMMA_BF16, d, da, db, accumulate, 128, TRANS_A, TRANS_B);
#endif
}

#define WG_OP16(c, d, i) WG_OP8(c, d, i), WG_OP8(c, d, i + 8)
#define WG_D48                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"

// d (64 x 96, f32; this thread's 48 of it) += a (64 x 16, bf16) b (16 x 96,
// bf16); a and b K-major descriptors. d[4 i + 2 h + e] is row 16 (t / 32) +
// (t % 32) / 4 + 8 h, column 8 i + 2 (t % 4) + e, as wgmma_bf16_m64n128k16's.
__device__ __forceinline__ void wgmma_bf16_m64n96k16(float (&d)[48], uint64_t da, uint64_t db) {
#ifdef __CUDACC__
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " WG_D48
      ", %48, %49, p, 1, 1, 0, 0;\n}\n"
      : WG_OP16("f", d, 0), WG_OP16("f", d, 16), WG_OP16("f", d, 32)
      : "l"(da), "l"(db), "r"(1));
#else
  emu_wgmma(EMU_WGMMA_BF16, d, da, db, 1, 96);
#endif
}

#undef WG_OP
#undef WG_OP8
#undef WG_OP16
#undef WG_OP64
#undef WG_D48
#undef WG_D64

// ---- mbarrier and TMA (sm_90) ---------------------------------------------------

// one thread: the barrier at bar (8 bytes of shared memory) expects count
// arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
#ifdef __CUDACC__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
#else
  emu_mbar_init(bar, count);
#endif
}

// the barriers' initialisation made visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
#ifdef __CUDACC__
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(bar)) : "memory");
#else
  emu_mbar_arrive(bar, 0);
#endif
}

// arrive, and expect bytes more of asynchronous copies before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
#ifdef __CUDACC__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
#else
  emu_mbar_arrive(bar, bytes);
#endif
}

// until the phase of parity `parity` (0 for the barrier's first phase) has
// completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
#ifdef __CUDACC__
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
#else
  while (!emu_mbar_try_wait(bar, parity)) {
  }
#endif
}

// one thread: the box of map at coordinates (c0 innermost, c1, c2) into
// dst (the box's bytes, laid out and swizzled as the map says), its bytes
// completed on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(shared_addr(bar))
      : "memory");
#else
  emu_tma_load_3d(dst, map, c0, c1, c2, bar);
#endif
}

// one thread: shared src (a box laid out and swizzled as map says) to the
// box of map at (c0, c1, c2), elements outside the tensor dropped; the
// copy joins this thread's current bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0, int c1, int c2,
                                             const void* src) {
#ifdef __CUDACC__
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(shared_addr(src))
      : "memory");
#else
  emu_tma_store_3d(map, c0, c1, c2, src);
#endif
}

// one thread: bytes (a multiple of 16) from global src to shared dst, both
// 16-byte aligned, completing on bar (whose phase must expect them)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
#else
  emu_bulk_load(dst, src, bytes, bar);
#endif
}

// the same for a tensor map of rank 5
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(shared_addr(bar))
      : "memory");
#else
  const int c[5] = {c0, c1, c2, c3, c4};
  emu_tma_load(dst, map, c, bar);
#endif
}

// a short pause in a loop that polls memory another block writes
__device__ __forceinline__ void spin_pause() {
#ifdef __CUDACC__
  __nanosleep(64);
#else
  emu_spin_pause();
#endif
}

// close this thread's bulk group; wait until at most N of its groups still
// read shared memory (bulk_wait_read) or are not complete (bulk_wait)
__device__ __forceinline__ void bulk_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
#endif
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Host: a tensor map of rank 3-5 of bf16 (elem_bytes 2) or float32 (4)
// (dims[0] innermost, each dims[i + 1] strides[i] bytes apart) whose boxes
// (box[0] x ... x box[rank - 1]) land in shared memory densely, with the
// given swizzle (0: none, 32, 64 or 128 bytes); out-of-range elements read
// as zeros. 0 on success.
inline int encode_tensor_map(CUtensorMap* map, int rank, const void* base, const uint64_t* dims,
                             const uint64_t* strides, const unsigned* box, int swizzle_bytes,
                             int elem_bytes = 2) {
#ifdef __CUDACC__
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return -2;
    encode = reinterpret_cast<Encode>(fn);
  }
  if (rank < 3 || rank > 5) return -3;
  cuuint64_t g_dims[5], g_strides[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    g_dims[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) g_strides[i] = strides[i];
  }
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), g_dims, g_strides, b, e,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
#else
  return emu_tensor_map_encode(map, rank, base, dims, strides, box, swizzle_bytes, elem_bytes);
#endif
}

// the same of rank 3 with boxes of box[0] x box[1] x 1 and a swizzle of 32,
// 64 or 128 bytes
inline int encode_tensor_map_3d(CUtensorMap* map, const void* base, const uint64_t dims[3],
                                const uint64_t strides[2], const unsigned box[2],
                                int swizzle_bytes, int elem_bytes = 2) {
  const unsigned box3[3] = {box[0], box[1], 1};
  return encode_tensor_map(map, 3, base, dims, strides, box3, swizzle_bytes, elem_bytes);
}

}  // namespace
