// Warp-level tensor-core and async-copy building blocks of the hand-written
// Hopper kernels (csrc/mma_probe.cu, csrc/conv3d.cu), each a small
// __device__ function around one PTX instruction so that a host compiler can
// be given a C++ body for it instead (the CPU emulation in
// tests/cuda_emulation/cuda_runtime.h):
//   mma_bf16  mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//   mma_s8    mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   ldsm_x4, ldsm_x4_trans
//             ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: four 8 x 8
//             16-bit matrices, lanes 8i .. 8i + 7 giving the rows of matrix i
//   cp_async16, cp_async_commit, cp_async_wait
//             cp.async.cg.shared.global of 16 bytes, zero-filled when the
//             source is out of range, and its commit/wait groups.
// The mma is asm volatile: every product really runs, none is hoisted out
// of a loop or merged with another.

#pragma once

#include <cstdint>

namespace {

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

#ifdef __CUDACC__
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
#endif

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

}  // namespace
