// Hand-written Hopper (sm_90a) tensor-core rate probe P1: does the card run
// int8 products at twice the bf16 rate?
//
// Replaces the Pallas TPU probe of scripts/int8_mxu_probe.py (``build``,
// pallas_call at :57): GRID steps, each the sum over REPS of the products
// A_r B of a (T, H) slice of A (REPS T, H) with B (H, H), added in float32
// into one (T, H) output. bf16 operands sum in float32; int8 operands sum in
// int32 within a step, and the step's sum is converted to float32 before it
// is added.
//
// The product is wgmma, warpgroup-wide, both operands from shared memory:
//   bf16 wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16
//   int8 wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8
// (wgmma_bf16_m64n128k16 and wgmma_s8_m64n128k32 of csrc/tensor_core.cuh),
// the only instruction that reaches the card's dense peaks. It is asm
// volatile: every step really runs, none is hoisted out of the loop or
// merged with another, though every step computes the same sum.
//
// What bounds it: operations. At T 384, H 512, REPS 8, GRID 512 a call is
// 2 * 384 * 512 * 512 * 8 * 512 = 824.6 GFLOP (or int8 operations) on
// 3.5 MB of inputs: 0.834 ms at the H100's 989 TFLOP/s of dense bf16 and
// 0.417 ms at its 1,979 TOP/s of int8.
//
// Design: the (T, H) output is only 12 tiles of 128 x 128, 12 of the card's
// 132 SMs, so the GRID steps are spread over blocks as well: block (tile, z)
// runs steps [z GRID / S, (z + 1) GRID / S) of its tile, keeps its float32
// running sum in registers and writes it to its own slot of a workspace;
// a second pass adds the S slots in a fixed order (reduce_splits_kernel; no
// atomics, so a run repeats bit for bit). Two warpgroups a block, each a
// 64 x 128 half of the tile: 64 accumulators of the step and 64 of the
// running sum a thread. The block's 128 columns of B (at most 128 KB) are
// copied into shared memory once and stay; A streams through a ring of
// three 32 KB stages of 128 rows x 256 bytes of depth (128 bf16 or 256 int8:
// two 128-byte atoms), all in the 128-byte swizzled K-major layout that
// wgmma reads (tensor_core.cuh), filled by cp.async of 16 bytes. Each
// warpgroup fills and reads only its own 64 rows of each stage, so after B
// is in (one block barrier) the two run their pipelines apart, each on its
// own named barrier, and one's wgmmas run while the other waits. Per stage:
// wait for its copies, fence them to the async proxy, the warpgroup's
// barrier, refill the stage before it, eight wgmmas, commit, and wait for
// them; at a step's end add the step into the running sum (the next step's
// first wgmma overwrites the accumulators: scale-d 0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmma_probe.so mma_probe.cu   (see ops/_build.py)

#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int PT = 128;                // output tile rows and columns per block
constexpr int PNT = 256;               // threads: two warpgroups, 64 rows each
constexpr int ATOM = PT * 128;         // 16 KB: a SW128 tile of 128 rows x 128 bytes
constexpr int STAGE_ATOMS = 2;         // bytes of depth a stage: 256
constexpr int STAGES = 3;              // A's ring
constexpr int A_STAGE = STAGE_ATOMS * ATOM;  // 32 KB
constexpr int MAX_DEPTH = 1024;        // bytes of depth (H times the type's size)
constexpr int SMEM_BYTES = 1024 + PT * MAX_DEPTH + STAGES * A_STAGE;  // 230,400
constexpr int PROBE_TARGET_BLOCKS = 132;  // one block on each SM

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_bf16_m64n128k16(d, da, db, acc);
}
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_s8_m64n128k32(d, da, db, acc);
}

// 16-byte chunk ch of row r of a SW128 tile at t
__device__ __forceinline__ unsigned char* sw128(unsigned char* t, int r, int ch) {
  return t + r * 128 + ((ch ^ (r & 7)) << 4);
}

// a: (reps T, Kb) bytes, row-major A; bt: (N, Kb) bytes, row n holding
// column n of B; Kb = depth in bytes (H bf16 values or H int8 values).
// Grid: x = output tile, y = split of the steps. partial[y]: (T, N).
template <typename Acc>
__global__ void __launch_bounds__(PNT, 1) mma_probe_kernel(
    const unsigned char* __restrict__ a, const unsigned char* __restrict__ bt, int T, int N,
    int Kb, int reps, int grid_steps, float* __restrict__ partial) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char smem_raw[];
#else
  alignas(1024) __shared__ unsigned char smem_raw[SMEM_BYTES];
  emu_poison_shared(smem_raw, sizeof smem_raw);
#endif
  // the swizzle acts on address bits 7-9: tiles start on 1024 bytes
  unsigned char* sb = smem_raw + ((1024 - (shared_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sa = sb + PT * Kb;  // [STAGES][STAGE_ATOMS][PT rows][128 bytes]
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_n = N / PT;
  const int m0 = (blockIdx.x / tiles_n) * PT;
  const int n0 = (blockIdx.x % tiles_n) * PT;
  const int splits = gridDim.y;
  const int step0 = (int)((long long)blockIdx.y * grid_steps / splits);
  const int step1 = (int)((long long)(blockIdx.y + 1) * grid_steps / splits);
  const int kc = Kb / (STAGE_ATOMS * 128);  // stages per rep
  const int per_step = reps * kc;
  const int stages = (step1 - step0) * per_step;

  // this warpgroup's rows of stage q: rep (q / kc) % reps, depth (q % kc)
  // 256 .. + 255, rows m0 + 64 wg .. + 63
  const int wt = tid & 127;
  auto load_a = [&](int q) {
    unsigned char* dst = sa + (q % STAGES) * A_STAGE + wg * 64 * 128;
    const unsigned char* src = a + ((long long)((q / kc) % reps) * T + m0 + wg * 64) * Kb +
                               (q % kc) * STAGE_ATOMS * 128;
    for (int i = wt; i < STAGE_ATOMS * 64 * 8; i += 128) {
      const int at = i >> 9, r = (i >> 3) & 63, ch = i & 7;
      cp_async16(sw128(dst + at * ATOM, r, ch), src + (long long)r * Kb + at * 128 + ch * 16,
                 true);
    }
  };
  // B's 128 columns, once: depth chunk c (128 bytes) is the SW128 tile at
  // sb + c ATOM
  for (int i = tid; i < PT * (Kb / 16); i += PNT) {
    const int r = i / (Kb / 16), ch = i % (Kb / 16);
    cp_async16(sw128(sb + (ch >> 3) * ATOM, r, ch & 7), bt + (long long)(n0 + r) * Kb + ch * 16,
               true);
  }
  for (int q = 0; q < STAGES - 1; ++q) {  // B travels in the first group
    if (q < stages) load_a(q);
    cp_async_commit();
  }

  const uint64_t da0 = wgmma_desc_sw128(sa + wg * 64 * 128);
  const uint64_t db0 = wgmma_desc_sw128(sb);
  Acc acc[64];
  float total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    total[i] = 0.f;
  }
  // the accumulators are pinned (wgmma_fence_operands) on both sides of
  // every batch, so that the compiler moves none of them while a wgmma that
  // writes them is in flight (it would wait for the wgmma first)
  int q = 0;  // stage
  for (int step = step0; step < step1; ++step) {
    for (int s = 0; s < per_step; ++s, ++q) {
      cp_async_wait<STAGES - 2>();  // stage q's copies of this thread are in
      fence_proxy_async();
      // ... and the warpgroup's (B: the block's); its wgmmas of stage q - 1 are done
      if (q == 0) {
        __syncthreads();
      } else {
        named_barrier_sync(1 + wg, 128);
      }
      if (q + STAGES - 1 < stages) load_a(q + STAGES - 1);  // into stage q - 1's slot
      cp_async_commit();
      const uint64_t da = da0 + (((q % STAGES) * A_STAGE) >> 4);
      const uint64_t db = db0 + (((s % kc) * A_STAGE) >> 4);
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int at = 0; at < STAGE_ATOMS; ++at)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma(acc, da + at * (ATOM >> 4) + 2 * j, db + at * (ATOM >> 4) + 2 * j,
                s > 0 || at > 0 || j > 0);
      wgmma_commit();
      wgmma_fence_operands(acc);
      wgmma_wait<0>();
    }
    // the step's sum is complete: add it
    wgmma_fence_operands(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += (float)acc[i];
  }

  // thread t of warpgroup wg: rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns
  // 8 i + 2 (t % 4) (+ 1)
  const int t = tid & 127;
  float* out = partial + (long long)blockIdx.y * T * N;
  const int row = m0 + wg * 64 + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = n0 + 8 * i + 2 * (t & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      out[(long long)(row + 8 * h) * N + col] = total[4 * i + 2 * h];
      out[(long long)(row + 8 * h) * N + col + 1] = total[4 * i + 2 * h + 1];
    }
  }
}

template <typename Acc>
int probe(const unsigned char* a, const unsigned char* bt, int T, int N, int Kb, int reps,
          int grid_steps, int splits, float* partial, float* out, cudaStream_t stream) {
  if (T % PT || N % PT || Kb % (STAGE_ATOMS * 128) || Kb > MAX_DEPTH || reps < 1 || grid_steps < 1 ||
      splits < 1)
    return -1;
  const dim3 grid((T / PT) * (N / PT), splits, 1);
  const int smem = 1024 + PT * Kb + STAGES * A_STAGE;
#ifdef __CUDACC__
  const cudaError_t e = cudaFuncSetAttribute(
      mma_probe_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
#endif
  LAUNCH_SMEM(mma_probe_kernel<Acc>, grid, PNT, smem, stream)(a, bt, T, N, Kb, reps,
                                                              grid_steps, partial);
  CHECK_LAUNCH();
  const long long count = (long long)T * N;
  LAUNCH(reduce_splits_kernel, cdiv(count, 256), 256, stream)(partial, splits, count, 1.f,
                                                               out);
  CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// Splits of the steps: enough blocks for one on each SM, at most one a step.
int mma_probe_splits(int T, int N, int grid_steps) {
  const int tiles = (T / PT) * (N / PT);
  int s = PROBE_TARGET_BLOCKS / (tiles > 0 ? tiles : 1);
  if (s < 1) s = 1;
  return s < grid_steps ? s : grid_steps;
}

// out (T, N) = sum over grid_steps of f32(sum_r A_r B): a (reps T, K) and
// bt (N, K) bf16 bits, row-major; partial: splits * T * N floats. Returns
// -1 for shapes the kernel does not take (T, N multiples of 128, K of 128
// up to 512).
int mma_probe_bf16(const uint16_t* a, const uint16_t* bt, int T, int N, int K, int reps,
                   int grid_steps, int splits, float* partial, float* out,
                   cudaStream_t stream) {
  return probe<float>(reinterpret_cast<const unsigned char*>(a),
                      reinterpret_cast<const unsigned char*>(bt), T, N, 2 * K, reps,
                      grid_steps, splits, partial, out, stream);
}

// The same with int8 operands, int32 sums within a step (K a multiple of
// 256 up to 1024).
int mma_probe_s8(const int8_t* a, const int8_t* bt, int T, int N, int K, int reps,
                 int grid_steps, int splits, float* partial, float* out,
                 cudaStream_t stream) {
  return probe<int>(reinterpret_cast<const unsigned char*>(a),
                    reinterpret_cast<const unsigned char*>(bt), T, N, K, reps, grid_steps,
                    splits, partial, out, stream);
}

}  // extern "C"
