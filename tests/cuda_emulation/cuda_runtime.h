// CPU emulation of the CUDA subset that mri_super_resolution_tpu_torch/csrc
// uses, so the kernels' index arithmetic can run under a host compiler.
// Blocks run one after another, the last first (so __shared__ arrays can be
// plain statics, and a block that writes over outputs of a block before it
// leaves its wrong values in place);
// within a block every CUDA thread is a fiber with its own stack, all on the
// launching OS thread, switched by hand (a few instructions) whenever one
// waits: __syncthreads is a block-wide barrier (bar.sync id, n one of n
// threads) and __shfl_xor_sync exchanges
// through a per-warp buffer behind a warp barrier. The warp-wide
// instructions of the tensor-core kernels exchange through per-warp buffers
// the same way: mma.sync bf16 m16n8k16 and int8 m16n8k32 (every lane posts
// its fragment registers, then computes its own four outputs in float32
// (bf16) or exactly (int8)) and ldmatrix .x4 (every lane posts a row
// address, then reads its four words, transposed or not). cp.async is a
// synchronous 16-byte copy with zero fill, so commit_group and wait_group
// have nothing to wait for: the block barrier that follows them on the card
// orders the copies here too. emu_poison_shared fills a kernel's shared
// memory with NaN bits at the start of each block, as the card's starts
// undefined, and makes it the block's shared window: a shared address
// (shared_addr, a wgmma descriptor's start) is an offset into it.
// wgmma (warpgroup-wide, asynchronous) is deferred as on the card: each
// thread queues its wgmma, commit_group closes the queue into a group, and
// wait_group N runs this thread's oldest groups until N are left, each
// thread computing its own accumulator fragment from shared memory as it
// stands then (a slot refilled before the wait is read refilled, as on the
// card). The operands' descriptors are decoded as the hardware does; only
// the 128-byte swizzled K-major layout is emulated, anything else aborts.
// Include the .cu after this header; see tests/cuda_emulation/emulated.py.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
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
inline uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
const int cudaSuccess = 0;
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// one device with an H100's 132 SMs
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? 132 : 0;
  return cudaSuccess;
}

namespace emu {

// ---- fibers ----------------------------------------------------------------
// emu_switch(from, to) saves the callee-saved registers and the stack pointer
// of the running fiber in *from and resumes the fiber whose stack pointer is
// to (x86-64 System V).
extern "C" void emu_switch(void** from, void* to);
__asm__(
    ".text\n"
    ".p2align 4\n"
    ".globl emu_switch\n"
    ".hidden emu_switch\n"
    ".type emu_switch,@function\n"
    "emu_switch:\n"
    "  pushq %rbp\n"
    "  pushq %rbx\n"
    "  pushq %r12\n"
    "  pushq %r13\n"
    "  pushq %r14\n"
    "  pushq %r15\n"
    "  movq %rsp, (%rdi)\n"
    "  movq %rsi, %rsp\n"
    "  popq %r15\n"
    "  popq %r14\n"
    "  popq %r13\n"
    "  popq %r12\n"
    "  popq %rbx\n"
    "  popq %rbp\n"
    "  ret\n"
    ".size emu_switch, .-emu_switch\n");

constexpr int MAX_THREADS = 1024;
constexpr size_t STACK_BYTES = 256 << 10;

struct Barrier;
struct WgmmaOp {
  int kind;  // EMU_WGMMA_BF16 or EMU_WGMMA_S8
  void* d;   // the thread's accumulator fragment
  uint64_t da, db;
  int accumulate, n;
};

// The running block: its fibers' saved stack pointers, the queue of fibers
// that may run, and the per-warp exchange buffers.
struct Block {
  int nt = 0, finished = 0, current = 0;
  void* sched_sp = nullptr;
  std::vector<void*> sp;
  std::deque<int> ready;
  std::function<void(int)> task;
  std::vector<std::unique_ptr<Barrier>> warp_barriers;
  std::unique_ptr<Barrier> block_barrier;
  std::vector<float> warp_buf;         // 32 floats a warp (shuffles)
  std::vector<unsigned> warp_words;    // 32 lanes x 8 words a warp (mma)
  std::vector<const void*> warp_ptrs;  // 32 addresses a warp (ldmatrix)
  char* shared_base = nullptr;         // the block's shared window
  std::unique_ptr<Barrier> named[16];  // bar.sync id, n (ids 1-15)
  std::vector<std::vector<struct WgmmaOp>> wg_open;                // per thread
  std::vector<std::deque<std::vector<struct WgmmaOp>>> wg_groups;  // per thread
};
inline Block* block;

inline char* stack_of(int t) {
  static std::vector<std::unique_ptr<char[]>> stacks(MAX_THREADS);
  if (!stacks[t]) stacks[t].reset(new char[STACK_BYTES]);
  return stacks[t].get();
}

// the running fiber waits: hand the OS thread back to the scheduler
inline void park() { emu_switch(&block->sp[block->current], block->sched_sp); }

struct Barrier {
  int expected, count = 0;
  std::vector<int> waiters;
  explicit Barrier(int n) : expected(n) {}
  void arrive_and_wait() {
    if (++count == expected) {  // the last to arrive releases the others and goes on
      count = 0;
      for (int w : waiters) block->ready.push_back(w);
      waiters.clear();
      return;
    }
    waiters.push_back(block->current);
    park();
  }
};

[[noreturn]] inline void fiber_entry() {
  block->task(block->current);
  ++block->finished;
  park();
  std::abort();  // a finished fiber is never resumed
}

inline void* fresh_stack(int t) {
  // six zeroed callee-saved registers, then fiber_entry as the return address;
  // the stack pointer after emu_switch's ret is 8 mod 16, as after a call
  auto** sp = reinterpret_cast<void**>(stack_of(t) + STACK_BYTES - 64);
  for (int i = 0; i < 6; ++i) sp[i] = nullptr;
  sp[6] = reinterpret_cast<void*>(&fiber_entry);
  sp[7] = nullptr;
  return sp;
}

}  // namespace emu

inline void __syncthreads() { emu::block->block_barrier->arrive_and_wait(); }
// bar.sync id, n: the first thread to name id fixes its count
inline void emu_named_barrier(int id, int n) {
  auto& b = emu::block->named[id];
  if (id < 1 || id > 15 || n % 32 || (b && b->expected != n)) std::abort();
  if (!b) b.reset(new emu::Barrier(n));
  b->arrive_and_wait();
}
inline emu::Barrier* emu_warp_barrier() { return emu::block->warp_barriers[threadIdx.x / 32].get(); }
inline float* emu_warp_buf() { return &emu::block->warp_buf[threadIdx.x / 32 * 32]; }
inline unsigned* emu_warp_words() { return &emu::block->warp_words[threadIdx.x / 32 * 256]; }
inline const void** emu_warp_ptrs() { return &emu::block->warp_ptrs[threadIdx.x / 32 * 32]; }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int lane = threadIdx.x & 31;
  emu_warp_buf()[lane] = v;
  emu_warp_barrier()->arrive_and_wait();
  const float r = emu_warp_buf()[lane ^ mask];
  emu_warp_barrier()->arrive_and_wait();
  return r;
}
using std::min;

// The fragment layouts of PTX's mma.sync m16n8k16 (bf16) and m16n8k32 (s8)
// in 32-bit words: a is 16 rows x 8 words, b 8 words x 8 columns, c 16 x 8.
// Lane l (group g = l / 4, t = l % 4) holds a words (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4), b words (t, g), (t + 4, g), and c (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
inline void emu_mma_post(const unsigned a[4], const unsigned b[2]) {
  unsigned* mine = emu_warp_words() + (threadIdx.x & 31) * 8;
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  emu_warp_barrier()->arrive_and_wait();
}
inline unsigned emu_a_word(int row, int w) {
  const int lane = (row & 7) * 4 + (w & 3);
  return emu_warp_words()[lane * 8 + (row >> 3) + 2 * (w >> 2)];
}
inline unsigned emu_b_word(int w, int col) {
  return emu_warp_words()[(col * 4 + (w & 3)) * 8 + 4 + (w >> 2)];
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
  emu_warp_barrier()->arrive_and_wait();  // the buffer is free again
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

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lanes 8i .. 8i + 7 give
// the addresses of rows 0-7 of matrix i (16 bytes each); lane l receives in
// r[i] the elements (l / 4, 2 (l % 4)) and (l / 4, 2 (l % 4) + 1) of matrix
// i, or with trans those of its transpose.
inline void emu_ldmatrix_x4(unsigned r[4], const void* row, bool trans) {
  const int lane = threadIdx.x & 31;
  emu_warp_ptrs()[lane] = row;
  emu_warp_barrier()->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const void* const* rows = emu_warp_ptrs() + 8 * i;
    uint16_t lo, hi;
    if (trans) {
      std::memcpy(&lo, static_cast<const char*>(rows[2 * t]) + 2 * g, 2);
      std::memcpy(&hi, static_cast<const char*>(rows[2 * t + 1]) + 2 * g, 2);
    } else {
      std::memcpy(&lo, static_cast<const char*>(rows[g]) + 4 * t, 2);
      std::memcpy(&hi, static_cast<const char*>(rows[g]) + 4 * t + 2, 2);
    }
    r[i] = lo | ((unsigned)hi << 16);
  }
  emu_warp_barrier()->arrive_and_wait();  // the addresses are free again
}

// cp.async.cg.shared.global [dst], [src], 16, src_bytes: src_bytes (0 or 16)
// copied, the rest of the 16 bytes zero
inline void emu_cp_async16(void* dst, const void* src, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);
}

// thread 0 fills the block's shared memory with 0xff bytes (NaN in bf16 and
// float32), then the block meets at a barrier; p is the block's shared
// window from then on
inline void emu_poison_shared(void* p, size_t bytes) {
  emu::block->shared_base = static_cast<char*>(p);
  if (threadIdx.x == 0) std::memset(p, 0xff, bytes);
  __syncthreads();
}

// the offset of p in the shared window: what shared_addr gives on the card
// (an 18-bit shared-state-space address)
inline unsigned emu_shared_offset(const void* p) {
  const long long o = static_cast<const char*>(p) - emu::block->shared_base;
  if (emu::block->shared_base == nullptr || o < 0 || o >= (1 << 18)) {
    std::fprintf(stderr, "emulated shared address outside the block's window\n");
    std::abort();
  }
  return (unsigned)o;
}

// ---- wgmma ------------------------------------------------------------------
// The shared-memory matrix descriptor: start address >> 4 in bits 0-13,
// leading byte offset >> 4 in 16-29, stride byte offset >> 4 in 32-45, base
// offset in 49-51, layout in 62-63 (1: 128-byte swizzle). In the K-major
// SW128 layout, byte kb (< 32) of the instruction's depth in row r (of m
// for A, of n for B) lies at start + (r / 8) SBO + (r % 8) 128 + kb, its
// bits 4-6 then XORed with bits 7-9.
enum { EMU_WGMMA_BF16 = 0, EMU_WGMMA_S8 = 1 };

inline const unsigned char* emu_desc_byte(uint64_t desc, int r, int kb) {
  const unsigned start = (unsigned)(desc & 0x3fff) << 4;
  const unsigned sbo = (unsigned)((desc >> 32) & 0x3fff) << 4;
  const unsigned base_offset = (unsigned)(desc >> 49) & 7;
  const unsigned layout = (unsigned)(desc >> 62);
  // the instruction's 32 bytes of depth must lie in the first 128-byte row
  // of a 1024-byte swizzle atom
  if (layout != 1 || base_offset != 0 || ((start >> 7) & 7) != 0 || (start & 127) > 96) {
    std::fprintf(stderr, "emulated wgmma: descriptor %016llx is not a SW128 K-major tile\n",
                 (unsigned long long)desc);
    std::abort();
  }
  unsigned addr = start + (unsigned)(r / 8) * sbo + (unsigned)(r % 8) * 128 + (unsigned)kb;
  addr ^= ((addr >> 7) & 7) << 4;
  return reinterpret_cast<const unsigned char*>(emu::block->shared_base) + addr;
}

// this thread's fragment of one wgmma m64nNk(16 bf16 | 32 s8): rows
// 16 w + l / 4 (+ 8), columns 8 i + 2 (l % 4) (+ 1) for warp w, lane l of
// the warpgroup
inline void emu_wgmma_run(const emu::WgmmaOp& op) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int i = 0; i < op.n / 8; ++i)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * w + l / 4 + 8 * h, col = 8 * i + 2 * (l % 4) + e;
        const int q = 4 * i + 2 * h + e;
        if (op.kind == EMU_WGMMA_BF16) {
          float s = 0.f;
          for (int k = 0; k < 16; ++k) {
            uint16_t a, b;
            std::memcpy(&a, emu_desc_byte(op.da, row, 2 * k), 2);
            std::memcpy(&b, emu_desc_byte(op.db, col, 2 * k), 2);
            s += emu_bf16(a, 0) * emu_bf16(b, 0);
          }
          float& d = static_cast<float*>(op.d)[q];
          d = op.accumulate ? d + s : s;
        } else {
          int s = 0;
          for (int k = 0; k < 32; ++k)
            s += (int8_t)*emu_desc_byte(op.da, row, k) * (int8_t)*emu_desc_byte(op.db, col, k);
          int& d = static_cast<int*>(op.d)[q];
          d = op.accumulate ? d + s : s;
        }
      }
}

inline void emu_wgmma(int kind, void* d, uint64_t da, uint64_t db, int accumulate, int n) {
  emu::block->wg_open[threadIdx.x].push_back({kind, d, da, db, accumulate, n});
}

inline void emu_wgmma_commit() {
  auto& open = emu::block->wg_open[threadIdx.x];
  emu::block->wg_groups[threadIdx.x].push_back(std::move(open));
  open.clear();
}

inline void emu_wgmma_wait(int n) {
  auto& groups = emu::block->wg_groups[threadIdx.x];
  while ((int)groups.size() > n) {
    for (const auto& op : groups.front()) emu_wgmma_run(op);
    groups.pop_front();
  }
}

inline void sincosf(float x, float* s, float* c) {
  *s = std::sin(x);
  *c = std::cos(x);
}

namespace emu {

template <class K>
struct Launcher {
  K kernel;
  dim3 grid, block_dim;
  template <class... A>
  void operator()(A... args) {
    gridDim = grid;
    blockDim = block_dim;
    const int nt = block_dim.x;
    const int nw = (nt + 31) / 32;
    if (nt > MAX_THREADS) std::abort();
    Block b;
    b.nt = nt;
    b.sp.resize(nt);
    b.block_barrier.reset(new Barrier(nt));
    for (int w = 0; w < nw; ++w) b.warp_barriers.emplace_back(new Barrier(std::min(32, nt - 32 * w)));
    b.warp_buf.resize(nw * 32);
    b.warp_words.resize(nw * 32 * 8);
    b.warp_ptrs.resize(nw * 32);
    b.wg_open.resize(nt);
    b.wg_groups.resize(nt);
    b.task = [&](int) { kernel(args...); };
    Block* outer = block;
    block = &b;
    for (unsigned bz = grid.z; bz-- > 0;)
      for (unsigned by = grid.y; by-- > 0;)
        for (unsigned bx = grid.x; bx-- > 0;) {
          blockIdx = {bx, by, bz};
          b.finished = 0;
          b.shared_base = nullptr;
          for (auto& nb : b.named) nb.reset();
          for (int t = 0; t < nt; ++t) {
            b.wg_open[t].clear();
            b.wg_groups[t].clear();
            b.sp[t] = fresh_stack(t);
            b.ready.push_back(t);
          }
          while (!b.ready.empty()) {
            b.current = b.ready.front();
            b.ready.pop_front();
            threadIdx = {(unsigned)b.current, 0, 0};
            emu_switch(&b.sched_sp, b.sp[b.current]);
          }
          if (b.finished != nt) {
            std::fprintf(stderr, "emulated block (%u, %u, %u): %d of %d threads never "
                         "left a barrier\n", bx, by, bz, nt - b.finished, nt);
            std::abort();
          }
        }
    block = outer;
  }
};
template <class K>
Launcher<K> launch(K kernel, dim3 grid, dim3 block) {
  return {kernel, grid, block};
}
}  // namespace emu

#define LAUNCH(kernel, grid, block, stream) emu::launch(kernel, dim3(grid), dim3(block))
