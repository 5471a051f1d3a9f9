// Tensor-core, async-copy and bfloat16 building blocks of the hand-written
// Hopper kernels (csrc/mma_probe.cu, csrc/conv3d.cu, csrc/siren_tc.cu), each
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
//   wgmma_desc_sw128
//             the shared-memory matrix descriptor of a K-major operand in
//             the 128-byte swizzled layout (below)
//   wgmma_bf16_m64n128k16, wgmma_s8_m64n128k32
//             wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 and
//             .m64n128k32.s32.s8.s8, both operands from shared memory
//   wgmma_fence, wgmma_commit, wgmma_wait, wgmma_fence_operands
//             wgmma.fence / commit_group / wait_group, and a compiler-only
//             fence that keeps the accumulators' reads after a wait
//   fence_proxy_async
//             fence.proxy.async.shared::cta: shared-memory writes of the
//             threads (cp.async included) made visible to wgmma's reads
//   named_barrier_sync
//             bar.sync id, n: a barrier of n threads (a warpgroup) of the block.
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

#pragma once

#include <cstdint>
#include <cstring>

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

#undef WG_OP
#undef WG_OP8
#undef WG_OP64
#undef WG_D64

}  // namespace
