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
// card). The operands' descriptors are decoded as the hardware does: the
// 128- and 64-byte swizzled layouts, K-major or (bf16, the instruction's
// transpose bits) MN-major, and the unswizzled K-major layout (8-row core
// matrices of 16-byte rows, 128 contiguous bytes each); anything else
// aborts.
// mbarriers live in a side table keyed by their shared address: init,
// arrive (with expect-tx) and try_wait.parity as PTX defines them, a phase
// completing when its arrivals and its transaction bytes are all in; a
// fiber whose try_wait fails yields to the others (many yields with no
// barrier progress abort as a deadlock). A TMA tile load
// (cp.async.bulk.tensor, of rank 3 to 5) is a synchronous copy of its box,
// zero outside the tensor, laid out and swizzled (or not) as the tensor map
// says, whose bytes then complete on its barrier; a TMA tile store (rank 3)
// copies a box back at once, dropping what lies outside the tensor; a
// tensor map is the emulation's own struct. A plain bulk copy
// (cp.async.bulk) is a synchronous copy whose bytes then complete on its
// barrier.
// A cooperative launch (LAUNCH_COOP) runs every block at once: each block's
// fibers have their own stacks and their own shared window
// (emu_block_shared), and the scheduler takes the blocks in turn, the last
// first, each until none of its fibers can run; a fiber that polls memory
// another block writes (spin_pause) waits for the next turn of its block.
// Integer atomics are plain read-modify-writes and __threadfence orders
// nothing (one OS thread runs every fiber); many turns in which only
// pollers ran abort as a deadlock.
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
#include <map>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
struct float4 {
  float x, y, z, w;
};
inline uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
const int cudaSuccess = 0;
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// one device with an H100's 132 SMs, or $EMU_SM_COUNT of them (read at each
// query: a test can shrink a persistent kernel's grid)
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  const char* sms = std::getenv("EMU_SM_COUNT");
  *value = attr == cudaDevAttrMultiProcessorCount ? (sms ? std::atoi(sms) : 132) : 0;
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
  int accumulate, n, trans_a, trans_b;
};
// an mbarrier: arrivals a phase, arrivals and transaction bytes still
// pending in this phase, and the phase's parity
struct Mbar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
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
  std::map<unsigned, Mbar> mbars;  // by shared address
  long long idle_yields = 0;       // yields since a barrier last moved
  // a cooperative launch's block: its index, its own fiber stacks and
  // shared window, the fibers waiting for its next turn, and the runs and
  // pauses of its fibers (a turn of pauses alone is no progress)
  uint3 idx{0, 0, 0};
  std::vector<std::unique_ptr<char[]>> own_stacks;
  std::unique_ptr<char[]> own_shared;
  std::vector<int> pausing;
  long long runs = 0, pauses = 0;
};
inline Block* block;

inline char* stack_of(int t) {
  if (!block->own_stacks.empty()) {
    auto& s = block->own_stacks[t];
    if (!s) s.reset(new char[STACK_BYTES]);
    return s.get();
  }
  static std::vector<std::unique_ptr<char[]>> stacks(MAX_THREADS);
  if (!stacks[t]) stacks[t].reset(new char[STACK_BYTES]);
  return stacks[t].get();
}

// the running fiber waits: hand the OS thread back to the scheduler
inline void park() { emu_switch(&block->sp[block->current], block->sched_sp); }

// the running fiber lets the others run, then goes on
inline void yield() {
  block->ready.push_back(block->current);
  park();
}

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
inline unsigned __shfl_xor_sync(unsigned mask, unsigned v, int lane_mask) {
  float f, r;
  std::memcpy(&f, &v, 4);
  r = __shfl_xor_sync(mask, f, lane_mask);
  unsigned u;
  std::memcpy(&u, &r, 4);
  return u;
}
struct uint4 {
  unsigned x, y, z, w;
};
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
// offset in 49-51, layout in 62-63 (0: no swizzle, 1: 128-byte swizzle, 2:
// 64-byte). With a swizzle of S bytes, element (r, k) of an operand (r of m
// for A, of n for B; k of the instruction's depth) lies, K-major, at start
// + (r / 8) SBO + (r % 8) S + k size and, MN-major (bf16), at start + (r /
// (S / 2)) LBO + (k / 8) SBO + (k % 8) S + 2 (r % (S / 2)); then the
// address's bits 4 .. 4 + log2(S / 16) are XORed with the bits 3 above
// them. Without a swizzle (K-major only), the operand is 8 x 16-byte core
// matrices: element (r, k) at start + (r / 8) SBO + (r % 8) 16 + (k size /
// 16) LBO + (k size) % 16, the leading offset running along the depth.
enum { EMU_WGMMA_BF16 = 0, EMU_WGMMA_S8 = 1 };

struct EmuDesc {
  unsigned start, lbo, sbo, swz;  // swz: the swizzle's bytes
  bool mn;
};

inline EmuDesc emu_desc(uint64_t desc, bool mn) {
  EmuDesc d;
  d.start = (unsigned)(desc & 0x3fff) << 4;
  d.lbo = (unsigned)((desc >> 16) & 0x3fff) << 4;
  d.sbo = (unsigned)((desc >> 32) & 0x3fff) << 4;
  d.mn = mn;
  const unsigned base_offset = (unsigned)(desc >> 49) & 7;
  const unsigned layout = (unsigned)(desc >> 62);
  d.swz = layout == 1 ? 128 : layout == 2 ? 64 : 0;
  if (layout == 0) {
    if (mn || base_offset != 0) {
      std::fprintf(stderr, "emulated wgmma: descriptor %016llx: an unswizzled operand must be "
                   "K-major\n", (unsigned long long)desc);
      std::abort();
    }
    return d;
  }
  // K-major: the instruction's 32 bytes of depth lie in the first row of a
  // swizzle atom (8 rows); MN-major: the start is an atom's
  const unsigned in_atom = d.start % (d.swz ? 8 * d.swz : 1);
  if (d.swz == 0 || base_offset != 0 ||
      (mn ? in_atom != 0 : (in_atom >= d.swz || in_atom + 32 > d.swz))) {
    std::fprintf(stderr, "emulated wgmma: descriptor %016llx is not a %s tile in a swizzled "
                 "layout the emulation knows\n", (unsigned long long)desc,
                 mn ? "MN-major" : "K-major");
    std::abort();
  }
  return d;
}

// element (r, k) of an operand of `size` bytes an element
inline const unsigned char* emu_desc_at(const EmuDesc& d, int r, int k, int size) {
  unsigned addr;
  if (d.swz == 0) {
    const unsigned kb = (unsigned)(k * size);
    return reinterpret_cast<const unsigned char*>(emu::block->shared_base) + d.start +
           (unsigned)(r / 8) * d.sbo + (unsigned)(r % 8) * 16 + kb / 16 * d.lbo + kb % 16;
  }
  if (d.mn) {
    const int w = (int)d.swz / 2;  // bf16 along a row
    addr = d.start + (unsigned)(r / w) * d.lbo + (unsigned)(k / 8) * d.sbo +
           (unsigned)(k % 8) * d.swz + (unsigned)(r % w) * 2;
  } else {
    addr = d.start + (unsigned)(r / 8) * d.sbo + (unsigned)(r % 8) * d.swz + (unsigned)(k * size);
  }
  addr ^= ((addr >> 7) & (d.swz / 16 - 1)) << 4;
  return reinterpret_cast<const unsigned char*>(emu::block->shared_base) + addr;
}

// this thread's fragment of one wgmma m64nNk(16 bf16 | 32 s8): rows
// 16 w + l / 4 (+ 8), columns 8 i + 2 (l % 4) (+ 1) for warp w, lane l of
// the warpgroup
inline void emu_wgmma_run(const emu::WgmmaOp& op) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const bool bf = op.kind == EMU_WGMMA_BF16;
  const int K = bf ? 16 : 32, size = bf ? 2 : 1;
  const EmuDesc da = emu_desc(op.da, op.trans_a), db = emu_desc(op.db, op.trans_b);
  float a[2][32], b[2][32];
  int ai[2][32], bi[2][32];
  auto load = [&](const EmuDesc& d, int r, float* f, int* n) {
    for (int k = 0; k < K; ++k) {
      const unsigned char* p = emu_desc_at(d, r, k, size);
      if (bf) {
        uint16_t v;
        std::memcpy(&v, p, 2);
        f[k] = emu_bf16(v, 0);
      } else {
        n[k] = (int8_t)*p;
      }
    }
  };
  for (int h = 0; h < 2; ++h) load(da, 16 * w + l / 4 + 8 * h, a[h], ai[h]);
  for (int i = 0; i < op.n / 8; ++i) {
    for (int e = 0; e < 2; ++e) load(db, 8 * i + 2 * (l % 4) + e, b[e], bi[e]);
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e) {
        const int q = 4 * i + 2 * h + e;
        if (bf) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s += a[h][k] * b[e][k];
          float& d = static_cast<float*>(op.d)[q];
          d = op.accumulate ? d + s : s;
        } else {
          int s = 0;
          for (int k = 0; k < K; ++k) s += ai[h][k] * bi[e][k];
          int& d = static_cast<int*>(op.d)[q];
          d = op.accumulate ? d + s : s;
        }
      }
  }
}

inline void emu_wgmma(int kind, void* d, uint64_t da, uint64_t db, int accumulate, int n,
                      int trans_a = 0, int trans_b = 0) {
  if ((trans_a || trans_b) && kind != EMU_WGMMA_BF16) std::abort();
  emu::block->wg_open[threadIdx.x].push_back({kind, d, da, db, accumulate, n, trans_a, trans_b});
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

// ---- mbarrier and TMA ----------------------------------------------------------
inline emu::Mbar& emu_mbar(const void* bar) {
  auto& m = emu::block->mbars;
  const auto it = m.find(emu_shared_offset(bar));
  if (it == m.end()) {
    std::fprintf(stderr, "emulated mbarrier used before its init\n");
    std::abort();
  }
  return it->second;
}

inline void emu_mbar_progress(emu::Mbar& b) {
  emu::block->idle_yields = 0;
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.expected;
  }
}

inline void emu_mbar_init(void* bar, unsigned count) {
  emu::Mbar b;
  b.expected = b.pending = (int)count;
  emu::block->mbars[emu_shared_offset(bar)] = b;
}

// one arrival, after expecting tx more bytes of this phase
inline void emu_mbar_arrive(void* bar, unsigned tx) {
  emu::Mbar& b = emu_mbar(bar);
  if (b.pending <= 0) std::abort();
  b.tx += tx;
  --b.pending;
  emu_mbar_progress(b);
}

// whether the phase of this parity has completed; if not, the fiber yields
inline bool emu_mbar_try_wait(void* bar, unsigned parity) {
  if (emu_mbar(bar).phase != (parity & 1u)) return true;
  if (++emu::block->idle_yields > 1000LL * emu::block->nt) {
    std::fprintf(stderr, "emulated mbarrier wait: no barrier moved in %lld yields (deadlock)\n",
                 emu::block->idle_yields);
    std::abort();
  }
  emu::yield();
  return false;
}

// the emulation's tensor map: an array of rank 3 to 5 of bf16 or float32
// (elem bytes each), dims[0] innermost, strides[i] the bytes between
// consecutive dims[i + 1], and the box a load copies
struct CUtensorMap {
  const char* base;
  int rank;
  uint64_t dims[5], strides[4];
  unsigned box[5];
  int swizzle, elem;  // swizzle: 0 (none), 32, 64 or 128 bytes
};

inline int emu_tensor_map_encode(CUtensorMap* map, int rank, const void* base,
                                 const uint64_t* dims, const uint64_t* strides,
                                 const unsigned* box, int swizzle, int elem) {
  // the card's rules: 16-byte aligned base and strides, a box row of a
  // multiple of 16 bytes and within the swizzle, at most 256 a box side
  if (rank < 3 || rank > 5 || reinterpret_cast<uintptr_t>(base) % 16 || (elem != 2 && elem != 4) ||
      box[0] * elem % 16 || (swizzle && box[0] * elem > (unsigned)swizzle))
    return -3;
  for (int i = 0; i < rank; ++i)
    if (box[i] == 0 || box[i] > 256 || (i + 1 < rank && strides[i] % 16)) return -3;
  map->base = static_cast<const char*>(base);
  map->rank = rank;
  for (int i = 0; i < rank; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i + 1 < rank) map->strides[i] = strides[i];
  }
  map->swizzle = swizzle;
  map->elem = elem;
  return 0;
}

// the box at coordinates c (c[0] innermost) into dst, its elements written
// densely in order (dims[0] fastest), each 16-byte chunk at its swizzled
// shared address, zero outside the tensor; then its bytes complete on bar
inline void emu_tma_load(void* dst, const CUtensorMap* map, const int* c, void* bar) {
  const unsigned d0 = emu_shared_offset(dst);
  if (d0 % 128) std::abort();  // the card wants 128-byte aligned boxes (and the swizzle atom's)
  const unsigned e = map->elem;
  const int rank = map->rank;
  long long n = 1;
  for (int i = 0; i < rank; ++i) n *= map->box[i];
  char* sbase = emu::block->shared_base;
  for (long long k = 0; k < n; ++k) {
    long long rest = k, off = 0;
    bool in = true;
    for (int i = 0; i < rank; ++i) {
      const long long idx = (long long)c[i] + rest % map->box[i];
      rest /= map->box[i];
      if (idx < 0 || (uint64_t)idx >= map->dims[i]) in = false;
      off += i == 0 ? idx * e : idx * (long long)map->strides[i - 1];
    }
    uint32_t v = 0;
    if (in) std::memcpy(&v, map->base + off, e);
    unsigned addr = d0 + (unsigned)(k * e);
    if (map->swizzle) addr ^= ((addr >> 7) & (unsigned)(map->swizzle / 16 - 1)) << 4;
    std::memcpy(sbase + addr, &v, e);
  }
  emu::Mbar& b = emu_mbar(bar);
  b.tx -= n * e;
  emu_mbar_progress(b);
}

inline void emu_tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                            void* bar) {
  const int c[3] = {c0, c1, c2};
  emu_tma_load(dst, map, c, bar);
}

// the box at (c0, c1, c2) from src (laid out and swizzled as for a load) to
// the tensor, elements outside it dropped: a synchronous copy, so that the
// bulk group's commit and waits have nothing to wait for
inline void emu_tma_store_3d(const CUtensorMap* map, int c0, int c1, int c2, const void* src) {
  const unsigned s0 = emu_shared_offset(src);
  if (s0 % 128) std::abort();
  if (map->rank != 3 || map->box[2] != 1) std::abort();
  const unsigned e = map->elem, row_bytes = map->box[0] * e;
  const char* sbase = emu::block->shared_base;
  char* base = const_cast<char*>(map->base);
  for (unsigned r = 0; r < map->box[1]; ++r)
    for (unsigned c = 0; c < map->box[0]; ++c) {
      const long long i0 = (long long)c0 + c, i1 = (long long)c1 + r, i2 = c2;
      if (i0 < 0 || i1 < 0 || i2 < 0 || (uint64_t)i0 >= map->dims[0] ||
          (uint64_t)i1 >= map->dims[1] || (uint64_t)i2 >= map->dims[2])
        continue;
      unsigned addr = s0 + r * row_bytes + e * c;
      addr ^= ((addr >> 7) & (unsigned)(map->swizzle / 16 - 1)) << 4;
      std::memcpy(base + i2 * map->strides[1] + i1 * map->strides[0] + e * i0, sbase + addr, e);
    }
}

// cp.async.bulk.shared.global: bytes (a multiple of 16, both addresses
// 16-byte aligned, as the card wants) copied at once, then completed on bar
inline void emu_bulk_load(void* dst, const void* src, unsigned bytes, void* bar) {
  if (reinterpret_cast<uintptr_t>(src) % 16 || emu_shared_offset(dst) % 16 || bytes % 16)
    std::abort();
  std::memcpy(dst, src, bytes);
  emu::Mbar& b = emu_mbar(bar);
  b.tx -= bytes;
  emu_mbar_progress(b);
}

// a fiber polling memory that another block writes: it waits for its
// block's next turn (a block launched on its own has no other turn: abort)
inline void emu_spin_pause() {
  auto& b = *emu::block;
  if (b.own_stacks.empty()) {
    std::fprintf(stderr, "emulated spin outside a cooperative launch (deadlock)\n");
    std::abort();
  }
  b.pausing.push_back(b.current);
  ++b.pauses;
  emu::park();
}

inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = v;
  return old;
}
inline void __threadfence() {}

// the block's shared window of a cooperative launch's kernel (bytes, NaN
// bits to start with, as emu_poison_shared)
inline void* emu_block_shared(size_t bytes) {
  auto& b = *emu::block;
  if (threadIdx.x == 0) {
    b.own_shared.reset(new char[bytes + 128]);
    char* p = b.own_shared.get();
    p += (128 - reinterpret_cast<uintptr_t>(p) % 128) % 128;
    std::memset(p, 0xff, bytes);
    b.shared_base = p;
  }
  __syncthreads();
  return b.shared_base;
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
          b.mbars.clear();
          b.idle_yields = 0;
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

// every block at once: each its own Block (fibers, stacks, shared window),
// run in turns, the last block first, each turn until none of its fibers
// can run
template <class K>
struct CoopLauncher {
  K kernel;
  dim3 grid, block_dim;
  template <class... A>
  int operator()(A... args) {
    gridDim = grid;
    blockDim = block_dim;
    const int nt = block_dim.x;
    const int nw = (nt + 31) / 32;
    if (nt > MAX_THREADS) std::abort();
    std::vector<std::unique_ptr<Block>> blocks;
    Block* outer = block;
    for (unsigned bz = grid.z; bz-- > 0;)
      for (unsigned by = grid.y; by-- > 0;)
        for (unsigned bx = grid.x; bx-- > 0;) {
          blocks.emplace_back(new Block);
          Block& b = *blocks.back();
          b.idx = {bx, by, bz};
          b.nt = nt;
          b.sp.resize(nt);
          b.own_stacks.resize(nt);
          b.block_barrier.reset(new Barrier(nt));
          for (int w = 0; w < nw; ++w)
            b.warp_barriers.emplace_back(new Barrier(std::min(32, nt - 32 * w)));
          b.warp_buf.resize(nw * 32);
          b.warp_words.resize(nw * 32 * 8);
          b.warp_ptrs.resize(nw * 32);
          b.wg_open.resize(nt);
          b.wg_groups.resize(nt);
          b.task = [&](int) { kernel(args...); };
          block = &b;
          for (int t = 0; t < nt; ++t) {
            b.sp[t] = fresh_stack(t);
            b.ready.push_back(t);
          }
        }
    long long idle_turns = 0;
    for (;;) {
      bool done = true, moved = false;
      for (auto& bp : blocks) {
        Block& b = *bp;
        if (b.finished == b.nt) continue;
        done = false;
        block = &b;
        blockIdx = b.idx;
        for (int f : b.pausing) b.ready.push_back(f);
        b.pausing.clear();
        const long long runs = b.runs, pauses = b.pauses;
        while (!b.ready.empty()) {
          b.current = b.ready.front();
          b.ready.pop_front();
          threadIdx = {(unsigned)b.current, 0, 0};
          ++b.runs;
          emu_switch(&b.sched_sp, b.sp[b.current]);
        }
        moved = moved || (b.runs - runs) != (b.pauses - pauses);
      }
      if (done) break;
      idle_turns = moved ? 0 : idle_turns + 1;
      if (idle_turns > 100000) {
        std::fprintf(stderr, "emulated cooperative launch: only pollers ran in %lld turns "
                     "(deadlock)\n", idle_turns);
        std::abort();
      }
    }
    block = outer;
    return 0;
  }
};
template <class K>
CoopLauncher<K> launch_coop(K kernel, dim3 grid, dim3 block) {
  return {kernel, grid, block};
}
}  // namespace emu

#define LAUNCH(kernel, grid, block, stream) emu::launch(kernel, dim3(grid), dim3(block))
#define LAUNCH_COOP(kernel, grid, block, smem, stream, ...) \
  emu::launch_coop(kernel, dim3(grid), dim3(block))(__VA_ARGS__)
