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
// The product is mma.sync, warp-wide, from registers:
//   bf16 mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//   int8 mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// (mma_bf16 and mma_s8 of csrc/tensor_core.cuh). The mma is asm volatile:
// every step really runs, none is hoisted out of the loop or merged with
// another, though every step computes the same sum.
//
// What bounds it: operations. At T 384, H 512, REPS 8, GRID 512 a call is
// 2 * 384 * 512 * 512 * 8 * 512 = 824.6 GFLOP (or int8 operations) on
// 3.5 MB of inputs: 0.834 ms at the H100's 989 TFLOP/s of dense bf16 and
// 0.417 ms at its 1,979 TOP/s of int8. Those peaks are wgmma's: mma.sync
// on Hopper issues from one warp at a time and does not reach them, so this
// probe measures the rate mma.sync gives, an upper bound for a kernel built
// on it and a lower bound for the card. A wgmma probe is later work.
//
// Design: the (T, H) output is only 12 tiles of 128 x 128, 12 of the card's
// 132 SMs, so the GRID steps are spread over blocks as well: block (tile, z)
// runs steps [z GRID / S, (z + 1) GRID / S) of its tile, keeps its float32
// running sum in registers and writes it to its own slot of a workspace;
// a second pass adds the S slots in a fixed order (reduce_splits_kernel; no
// atomics, so a run repeats bit for bit). Per step, A and B stream through
// shared memory in chunks of 32 words of depth (64 bf16 or 128 int8), rows
// padded to 36 words so that the fragment reads hit 32 banks. Eight warps
// per block, each a 64 x 32 piece of the tile: 4 x 4 mma tiles, 64
// accumulators of the step and 64 of the running sum a thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmma_probe.so mma_probe.cu   (see ops/_build.py)

#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int PT = 128;   // output tile rows and columns per block
constexpr int PW = 32;    // 32-bit words of depth per shared-memory chunk
constexpr int PS = PW + 4;  // padded row stride (words)
constexpr int PNT = 256;  // threads: 8 warps, 2 along rows x 4 along columns
constexpr int PROBE_TARGET_BLOCKS = 132;  // one block on each SM

struct alignas(16) Words4 {
  unsigned x, y, z, w;
};

__device__ __forceinline__ void mma(float c[4], const unsigned a[4], const unsigned b[2]) {
  mma_bf16(c, a, b);
}
__device__ __forceinline__ void mma(int c[4], const unsigned a[4], const unsigned b[2]) {
  mma_s8(c, a, b);
}

// a: (reps T, Kw) words, row-major A; bt: (N, Kw) words, row n holding
// column n of B; Kw = depth in 32-bit words (H / 2 for bf16, H / 4 for
// int8). Grid: x = output tile, y = split of the steps. partial[y]: (T, N).
template <typename Acc>
__global__ void __launch_bounds__(PNT) mma_probe_kernel(
    const unsigned* __restrict__ a, const unsigned* __restrict__ bt, int T, int N, int Kw,
    int reps, int grid_steps, float* __restrict__ partial) {
  __shared__ __align__(16) unsigned As[PT * PS];
  __shared__ __align__(16) unsigned Bs[PT * PS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // groupID
  const int t = lane & 3;   // thread in group
  const int tiles_n = N / PT;
  const int m0 = (blockIdx.x / tiles_n) * PT;
  const int n0 = (blockIdx.x % tiles_n) * PT;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int splits = gridDim.y;
  const int step0 = (int)((long long)blockIdx.y * grid_steps / splits);
  const int step1 = (int)((long long)(blockIdx.y + 1) * grid_steps / splits);

  float total[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[i][j][q] = 0.f;

  for (int step = step0; step < step1; ++step) {
    Acc acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
    for (int r = 0; r < reps; ++r) {
      const unsigned* ar = a + ((long long)r * T + m0) * Kw;
      const unsigned* br = bt + (long long)n0 * Kw;
      for (int kc = 0; kc < Kw; kc += PW) {
        // 128 rows x 32 words of each operand: four 16-byte loads a thread
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = tid + i * PNT;
          const int row = idx >> 3;
          const int col = (idx & 7) * 4;
          const Words4 va = *reinterpret_cast<const Words4*>(ar + (long long)row * Kw + kc + col);
          const Words4 vb = *reinterpret_cast<const Words4*>(br + (long long)row * Kw + kc + col);
          unsigned* sa = As + row * PS + col;
          unsigned* sb = Bs + row * PS + col;
          sa[0] = va.x, sa[1] = va.y, sa[2] = va.z, sa[3] = va.w;
          sb[0] = vb.x, sb[1] = vb.y, sb[2] = vb.z, sb[3] = vb.w;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < PW; kk += 8) {
          unsigned af[4][4];
          unsigned bf[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const unsigned* p = As + (wm + i * 16 + g) * PS + kk + t;
            af[i][0] = p[0];
            af[i][1] = p[8 * PS];
            af[i][2] = p[4];
            af[i][3] = p[8 * PS + 4];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned* p = Bs + (wn + j * 8 + g) * PS + kk + t;
            bf[j][0] = p[0];
            bf[j][1] = p[4];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bf[j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) total[i][j][q] += (float)acc[i][j][q];
  }

  float* out = partial + (long long)blockIdx.y * T * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      out[(long long)row * N + col] = total[i][j][0];
      out[(long long)row * N + col + 1] = total[i][j][1];
      out[(long long)(row + 8) * N + col] = total[i][j][2];
      out[(long long)(row + 8) * N + col + 1] = total[i][j][3];
    }
  }
}

template <typename Acc>
int probe(const unsigned* a, const unsigned* bt, int T, int N, int Kw, int reps,
          int grid_steps, int splits, float* partial, float* out, cudaStream_t stream) {
  if (T % PT || N % PT || Kw % PW || reps < 1 || grid_steps < 1 || splits < 1) return -1;
  const dim3 grid((T / PT) * (N / PT), splits, 1);
  LAUNCH(mma_probe_kernel<Acc>, grid, PNT, stream)(a, bt, T, N, Kw, reps, grid_steps,
                                                   partial);
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
// -1 for shapes the kernel does not take (T, N multiples of 128, K of 64).
int mma_probe_bf16(const uint16_t* a, const uint16_t* bt, int T, int N, int K, int reps,
                   int grid_steps, int splits, float* partial, float* out,
                   cudaStream_t stream) {
  if (K % 2) return -1;
  return probe<float>(reinterpret_cast<const unsigned*>(a),
                      reinterpret_cast<const unsigned*>(bt), T, N, K / 2, reps, grid_steps,
                      splits, partial, out, stream);
}

// The same with int8 operands, int32 sums within a step (K a multiple of 128).
int mma_probe_s8(const int8_t* a, const int8_t* bt, int T, int N, int K, int reps,
                 int grid_steps, int splits, float* partial, float* out,
                 cudaStream_t stream) {
  if (K % 4) return -1;
  return probe<int>(reinterpret_cast<const unsigned*>(a),
                    reinterpret_cast<const unsigned*>(bt), T, N, K / 4, reps, grid_steps,
                    splits, partial, out, stream);
}

}  // extern "C"
