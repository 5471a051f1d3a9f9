// CPU emulation of the CUDA subset that mri_super_resolution_tpu_torch/csrc
// uses, so the kernels' index arithmetic can run under a host compiler:
// every CUDA thread of a block runs on its own std::thread, blocks run one
// after another (so __shared__ arrays can be plain statics), __syncthreads is a
// block-wide barrier and __shfl_xor_sync exchanges through a per-warp buffer.
// The warp-wide tensor-core products of csrc/mma_probe.cu (mma.sync bf16
// m16n8k16 and int8 m16n8k32) exchange their fragments through a second
// per-warp buffer: every lane posts its registers, then computes its own
// four outputs in float32 (bf16) or exactly (int8).
// Include the .cu after defining LAUNCH as below; see
// tests/test_torch_cuda_emulated.py.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <semaphore>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct float4 {
  float x, y, z, w;
};
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
const int cudaSuccess = 0;
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline thread_local std::barrier<>* emu_block_barrier;
inline thread_local std::barrier<>* emu_warp_barrier;
inline thread_local float* emu_warp_buf;
inline thread_local unsigned* emu_warp_words;  // 32 lanes x 8 words

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int lane = threadIdx.x & 31;
  emu_warp_buf[lane] = v;
  emu_warp_barrier->arrive_and_wait();
  const float r = emu_warp_buf[lane ^ mask];
  emu_warp_barrier->arrive_and_wait();
  return r;
}
using std::min;

// The fragment layouts of PTX's mma.sync m16n8k16 (bf16) and m16n8k32 (s8)
// in 32-bit words: a is 16 rows x 8 words, b 8 words x 8 columns, c 16 x 8.
// Lane l (group g = l / 4, t = l % 4) holds a words (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4), b words (t, g), (t + 4, g), and c (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
inline void emu_mma_post(const unsigned a[4], const unsigned b[2]) {
  unsigned* mine = emu_warp_words + (threadIdx.x & 31) * 8;
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  emu_warp_barrier->arrive_and_wait();
}
inline unsigned emu_a_word(int row, int w) {
  const int lane = (row & 7) * 4 + (w & 3);
  return emu_warp_words[lane * 8 + (row >> 3) + 2 * (w >> 2)];
}
inline unsigned emu_b_word(int w, int col) {
  return emu_warp_words[(col * 4 + (w & 3)) * 8 + 4 + (w >> 2)];
}
inline float emu_bf16(unsigned word, int half) {
  const unsigned bits = (half ? word & 0xffff0000u : word << 16);
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}
inline int emu_s8(unsigned word, int byte) { return (int8_t)((word >> (8 * byte)) & 0xffu); }
template <class C, class Dot>
inline void emu_mma_outputs(C c[4], Dot dot) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int q = 0; q < 4; ++q) c[q] += dot(rows[q], cols[q]);
  emu_warp_barrier->arrive_and_wait();  // the buffer is free again
}
inline void emu_mma_bf16_m16n8k16(float c[4], const unsigned a[4], const unsigned b[2]) {
  emu_mma_post(a, b);
  emu_mma_outputs(c, [](int row, int col) {
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += emu_bf16(emu_a_word(row, k / 2), k % 2) * emu_bf16(emu_b_word(k / 2, col), k % 2);
    return s;
  });
}
inline void emu_mma_s8_m16n8k32(int c[4], const unsigned a[4], const unsigned b[2]) {
  emu_mma_post(a, b);
  emu_mma_outputs(c, [](int row, int col) {
    int s = 0;
    for (int k = 0; k < 32; ++k)
      s += emu_s8(emu_a_word(row, k / 4), k % 4) * emu_s8(emu_b_word(k / 4, col), k % 4);
    return s;
  });
}
inline void sincosf(float x, float* s, float* c) {
  *s = std::sin(x);
  *c = std::cos(x);
}

namespace emu {
// A fixed pool of worker threads, one per CUDA thread of the largest block
// (1024), each waiting on its own semaphore: a block of nt threads wakes
// only the first nt workers and waits for nt completions. Spawning threads
// per block instead costs milliseconds per block. The pool is never torn
// down: its idle workers end with the process.
struct Pool {
  static constexpr int N = 1024;
  std::vector<std::unique_ptr<std::binary_semaphore>> go;
  std::binary_semaphore finished{0};
  std::atomic<int> remaining{0};
  std::function<void(int)> task;
  Pool() {
    for (int t = 0; t < N; ++t) go.emplace_back(new std::binary_semaphore(0));
    for (int t = 0; t < N; ++t)
      std::thread([this, t]() {
        for (;;) {
          go[t]->acquire();
          task(t);
          if (remaining.fetch_sub(1) == 1) finished.release();
        }
      }).detach();
  }
  void run(int nt, std::function<void(int)> f) {
    task = std::move(f);
    remaining.store(nt);
    for (int t = 0; t < nt; ++t) go[t]->release();
    finished.acquire();
  }
};
inline Pool& pool() {
  static Pool* p = new Pool;
  return *p;
}

template <class K>
struct Launcher {
  K kernel;
  dim3 grid, block;
  template <class... A>
  void operator()(A... args) {
    gridDim = grid;
    blockDim = block;
    const int nt = block.x;
    const int nw = (nt + 31) / 32;
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          std::barrier<> block_barrier(nt);
          std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
          std::vector<float> warp_buf(nw * 32);
          std::vector<unsigned> warp_words(nw * 32 * 8);
          for (int w = 0; w < nw; ++w)
            warp_barriers.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
          pool().run(nt, [&](int t) {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {bx, by, bz};
            emu_block_barrier = &block_barrier;
            emu_warp_barrier = warp_barriers[t / 32].get();
            emu_warp_buf = &warp_buf[(t / 32) * 32];
            emu_warp_words = &warp_words[(t / 32) * 32 * 8];
            kernel(args...);
          });
        }
  }
};
template <class K>
Launcher<K> launch(K kernel, dim3 grid, dim3 block) {
  return {kernel, grid, block};
}
}  // namespace emu

#define LAUNCH(kernel, grid, block, stream) emu::launch(kernel, dim3(grid), dim3(block))
