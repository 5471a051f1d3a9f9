// Building blocks shared by the hand-written Hopper kernels of csrc/*.cu:
// one tiled float32 SIMT GEMM with fused epilogues, a warp-per-row D -> 1
// layer with an optional masked (and optionally sample-weighted) MSE
// residual, ReLU and max |out|, split column sums, split reductions and the
// launch plans that size them.
//
// Everything here is float32, row-major and contiguous; every launch goes to
// the caller's stream; nothing allocates or synchronises. Each .cu includes
// this header once and is compiled on its own into its own library.

#pragma once

#include <cuda_runtime.h>

#include "launch.cuh"

#define CHECK_LAUNCH()                          \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

namespace {

constexpr int BM = 128;  // GEMM block tile: rows
constexpr int BN = 128;  // GEMM block tile: columns
constexpr int BK = 8;    // GEMM depth per shared-memory stage
constexpr int NT = 256;  // threads per GEMM block (16 x 16, 8 x 8 outputs each)
constexpr int SPLIT_TARGET_BLOCKS = 264;  // two waves of blocks on 132 SMs
constexpr int MAX_SPLITS = 64;
constexpr int ROWDOT_WARPS = 8;
constexpr int ROWDOT_MAX_BLOCKS = 1024;
constexpr int COLSUM_THREADS = 256;
constexpr int COLSUM_MAX_SPLITS = 1024;
constexpr int EW_THREADS = 256;         // elementwise kernels
constexpr int EW_MAX_BLOCKS = 132 * 16;

enum Epilogue { EPI_STORE = 0, EPI_SINE = 1, EPI_MUL = 2, EPI_BIAS = 3, EPI_RELU = 4 };

// C[m, n] = sum_k Aop[m, k] * Bop[k, n] over k in this block's split.
//   Aop[m, k] = TA ? A[k * lda + m] : A[m * lda + k]
//   Bop[k, n] = TB ? B[n * ldb + k] : B[k * ldb + n]
// gridDim.z splits K into chunks of k_split; split z writes its partial sum
// at C + z * split_stride (split_stride = 0 when gridDim.z == 1). Every load
// is bounds-checked, so any M, N and K >= 1 (K below the tile depth too).
// Epilogues: EPI_STORE writes C; EPI_BIAS writes C + bias[n]; EPI_SINE
// writes sin(omega (C + bias[n])) and, when F is given, F = omega cos(omega
// (C + bias[n])); EPI_RELU writes max(z, 0) with z = C + bias[n] and, when
// F is given, F = (z > 0 ? 1 : 0) (the step is 0 at z = 0); EPI_MUL writes
// C * F (F may alias nothing written by another thread).
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(NT, 2) gemm_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    int M, int N, int K, int k_split, float* __restrict__ C, int ldc,
    long long split_stride, const float* __restrict__ bias, float omega,
    float* F, int ldf) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  C += blockIdx.z * split_stride;

  // Each thread stages 4 elements of each operand tile per depth step: four
  // consecutive k of one row when the operand is k-contiguous in memory,
  // else four consecutive rows/columns of one k (coalesced either way).
  const int a_r = TA ? (tid & 31) * 4 : tid >> 1;
  const int a_k = TA ? tid >> 5 : (tid & 1) * 4;
  const int b_c = TB ? tid >> 1 : (tid & 31) * 4;
  const int b_k = TB ? (tid & 1) * 4 : tid >> 5;

  float ra[4];
  float rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = TA ? m0 + a_r + i : m0 + a_r;
      const int ka = TA ? k0 + a_k : k0 + a_k + i;
      ra[i] = (m < M && ka < ke)
                  ? (TA ? A[(long long)ka * lda + m] : A[(long long)m * lda + ka])
                  : 0.f;
      const int n = TB ? n0 + b_c : n0 + b_c + i;
      const int kk = TB ? k0 + b_k + i : k0 + b_k;
      rb[i] = (n < N && kk < ke)
                  ? (TB ? B[(long long)n * ldb + kk] : B[(long long)kk * ldb + n])
                  : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (TA) {
        As[a_k][a_r + i] = ra[i];
      } else {
        As[a_k + i][a_r] = ra[i];
      }
      if (TB) {
        Bs[b_k + i][b_c] = rb[i];
      } else {
        Bs[b_k][b_c + i] = rb[i];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  load(kb);
  store();
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += BK) {
    const bool more = k0 + BK < ke;  // uniform across the block
    if (more) load(k0 + BK);         // next stage's global loads in flight
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // rows ty*4..+3 and 64+ty*4..+3, columns tx*4..+3 and 64+tx*4..+3:
      // a quarter-warp's float4 reads cover 128 contiguous bytes
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= N) continue;
      const float v = acc[i][j];
      const long long off = (long long)m * ldc + n;
      if (EPI == EPI_SINE) {
        float s, c;
        sincosf(omega * (v + bias[n]), &s, &c);
        C[off] = s;
        if (F != nullptr) F[(long long)m * ldf + n] = omega * c;
      } else if (EPI == EPI_RELU) {
        const float z = v + bias[n];
        C[off] = z > 0.f ? z : 0.f;
        if (F != nullptr) F[(long long)m * ldf + n] = z > 0.f ? 1.f : 0.f;
      } else if (EPI == EPI_MUL) {
        C[off] = v * F[(long long)m * ldf + n];
      } else if (EPI == EPI_BIAS) {
        C[off] = v + bias[n];
      } else {
        C[off] = v;
      }
    }
  }
}

// What the last layer (D -> 1) writes per row, z = h . w + b and
// out = act(z) (ReLU when RELU, else z):
//   ROW_OUT  out;
//   ROW_LOSS delta = two_inv_n * s * r * act'(z) with r = out - target on
//            rows below n_rows and 0 beyond, s = sw[row] when WEIGHTED else
//            1; one partial sum of s * r^2 per block into loss_partial and,
//            when ABSMAX, one partial max of |out| over the rows below n_rows
//            (0 for a block without one) into absmax_partial;
//   ROW_GRAD delta = target[row] * act'(z) (target holds dL/d out).
enum RowdotMode { ROW_OUT = 0, ROW_LOSS = 1, ROW_GRAD = 2 };

// One warp per row; the body of rowdot_kernel and rowdot_act_kernel.
template <int MODE, bool RELU, bool WEIGHTED, bool ABSMAX>
__device__ __forceinline__ void rowdot_rows(
    const float* __restrict__ H, int P, int D, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out,
    const float* __restrict__ target, int n_rows, float two_inv_n,
    float* __restrict__ loss_partial, const float* __restrict__ sw,
    float* __restrict__ absmax_partial) {
  __shared__ float red[ROWDOT_WARPS];
  __shared__ float red_max[ROWDOT_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float sq = 0.f;
  float mx = 0.f;
  for (long long row = (long long)blockIdx.x * ROWDOT_WARPS + warp; row < P;
       row += (long long)gridDim.x * ROWDOT_WARPS) {
    const float* h = H + row * D;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s = fmaf(h[i], w[i], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float z = s + b[0];
      const float v = RELU ? (z > 0.f ? z : 0.f) : z;
      const float step = (!RELU || z > 0.f) ? 1.f : 0.f;
      if (MODE == ROW_LOSS) {
        const bool real = row < n_rows;
        const float r = real ? v - target[row] : 0.f;
        const float wr = WEIGHTED ? sw[row] * r : r;
        out[row] = RELU ? (two_inv_n * wr) * step : two_inv_n * wr;
        sq = fmaf(wr, r, sq);
        if (ABSMAX && real) {
          const float a = v < 0.f ? -v : v;
          mx = a > mx ? a : mx;
        }
      } else if (MODE == ROW_GRAD) {
        out[row] = target[row] * step;
      } else {
        out[row] = v;
      }
    }
  }
  if (MODE == ROW_LOSS) {
    if (lane == 0) {
      red[warp] = sq;
      if (ABSMAX) red_max[warp] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int i = 0; i < ROWDOT_WARPS; ++i) t += red[i];
      loss_partial[blockIdx.x] = t;
      if (ABSMAX) {
        float m = 0.f;
        for (int i = 0; i < ROWDOT_WARPS; ++i) m = red_max[i] > m ? red_max[i] : m;
        absmax_partial[blockIdx.x] = m;
      }
    }
  }
}

// Last layer (D -> 1), linear: LOSS = false writes the output (ROW_OUT);
// LOSS = true writes delta = two_inv_n * r and the per-block partial sums of
// r^2 (ROW_LOSS, unweighted).
template <bool LOSS>
__global__ void __launch_bounds__(ROWDOT_WARPS * 32) rowdot_kernel(
    const float* __restrict__ H, int P, int D, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out,
    const float* __restrict__ target, int n_rows, float two_inv_n,
    float* __restrict__ loss_partial) {
  rowdot_rows<LOSS ? ROW_LOSS : ROW_OUT, false, false, false>(
      H, P, D, w, b, out, target, n_rows, two_inv_n, loss_partial, nullptr, nullptr);
}

// Last layer (D -> 1) with the options of rowdot_rows.
template <int MODE, bool RELU, bool WEIGHTED, bool ABSMAX>
__global__ void __launch_bounds__(ROWDOT_WARPS * 32) rowdot_act_kernel(
    const float* __restrict__ H, int P, int D, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out,
    const float* __restrict__ target, int n_rows, float two_inv_n,
    float* __restrict__ loss_partial, const float* __restrict__ sw,
    float* __restrict__ absmax_partial) {
  rowdot_rows<MODE, RELU, WEIGHTED, ABSMAX>(H, P, D, w, b, out, target, n_rows, two_inv_n,
                                            loss_partial, sw, absmax_partial);
}

// partial[z, j] = sum over rows p of split z of X[p, j] * (w ? w[p] : 1).
__global__ void __launch_bounds__(COLSUM_THREADS) colsum_partial_kernel(
    const float* __restrict__ X, int P, int N, const float* __restrict__ w,
    int rows_per_split, float* __restrict__ partial) {
  const int j = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (j >= N) return;
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = min((long long)P, r0 + rows_per_split);
  float s = 0.f;
  if (w != nullptr) {
    for (long long p = r0; p < r1; ++p) s = fmaf(X[p * N + j], w[p], s);
  } else {
    for (long long p = r0; p < r1; ++p) s += X[p * N + j];
  }
  partial[(long long)blockIdx.y * N + j] = s;
}

// out[i] = scale * sum_z partial[z * count + i]
__global__ void reduce_splits_kernel(const float* __restrict__ partial, int splits,
                                     long long count, float scale,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * count + i];
  out[i] = s * scale;
}

// out[0] = scale * sum(x[0..n)), one block of 1024 threads.
__global__ void __launch_bounds__(1024) sum_kernel(const float* __restrict__ x,
                                                   long long n, float scale,
                                                   float* __restrict__ out) {
  __shared__ float red[32];
  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) s += x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = red[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) out[0] = s * scale;
  }
}

// out[0] = max(0, max(x[0..n))), one block of 1024 threads (the max is
// exact, so the result does not depend on the order).
__global__ void __launch_bounds__(1024) max_kernel(const float* __restrict__ x,
                                                   long long n, float* __restrict__ out) {
  __shared__ float red[32];
  float m = 0.f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) m = x[i] > m ? x[i] : m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, m, o);
    m = v > m ? v : m;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = red[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, m, o);
      m = v > m ? v : m;
    }
    if (threadIdx.x == 0) out[0] = m;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Blocks of a grid-stride elementwise pass over `total` elements.
inline int ew_blocks(long long total) {
  const int b = cdiv(total, EW_THREADS);
  return b < 1 ? 1 : (b > EW_MAX_BLOCKS ? EW_MAX_BLOCKS : b);
}

// Split-K plan of a dW GEMM with an M x N output and depth K.
struct SplitPlan {
  int splits;
  int k_split;
};

SplitPlan split_plan(int M, int N, int K) {
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  int splits = cdiv(SPLIT_TARGET_BLOCKS, tiles);
  if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  if (splits < 1) splits = 1;
  int k_split = cdiv(cdiv(K, splits), BK) * BK;
  if (k_split < BK) k_split = BK;
  return {cdiv(K, k_split), k_split};
}

struct ColsumPlan {
  int splits;
  int rows_per_split;
};

ColsumPlan colsum_plan(int P, int N) {
  const int gx = cdiv(N, COLSUM_THREADS);
  int splits = cdiv(2 * SPLIT_TARGET_BLOCKS, gx);
  if (splits > COLSUM_MAX_SPLITS) splits = COLSUM_MAX_SPLITS;
  if (splits > P) splits = P;
  if (splits < 1) splits = 1;
  const int rows = cdiv(P, splits);
  return {cdiv(P, rows), rows};
}

// Floats of split workspace that gemm_tn_reduced (M x N output, depth P)
// and colsum_reduced (P x M and P x N inputs) need.
long long reduced_partial_floats(int P, int M, int N) {
  const SplitPlan sp = split_plan(M, N, P);
  long long need = (long long)sp.splits * M * N;
  const ColsumPlan cm = colsum_plan(P, M);
  if ((long long)cm.splits * M > need) need = (long long)cm.splits * M;
  const ColsumPlan cn = colsum_plan(P, N);
  if ((long long)cn.splits * N > need) need = (long long)cn.splits * N;
  return need;
}

int rowdot_blocks(int P) {
  const int b = cdiv(P, ROWDOT_WARPS);
  return b < ROWDOT_MAX_BLOCKS ? (b < 1 ? 1 : b) : ROWDOT_MAX_BLOCKS;
}

template <bool TA, bool TB, int EPI>
int gemm(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
         float* C, int ldc, const float* bias, float omega, float* F, int ldf,
         cudaStream_t stream) {
  const dim3 grid(cdiv(N, BN), cdiv(M, BM), 1);
  const auto kernel = gemm_kernel<TA, TB, EPI>;
  LAUNCH(kernel, grid, NT, stream)(
      A, lda, B, ldb, M, N, K, K, C, ldc, 0LL, bias, omega, F, ldf);
  CHECK_LAUNCH();
  return 0;
}

// out (M x N) = A^T B with A (K, M) and B (K, N) row-major, reduced over K by
// split partials in `partial` and a second pass.
int gemm_tn_reduced(const float* A, int M, const float* B, int N, int K, float* out,
                    float* partial, cudaStream_t stream) {
  const SplitPlan sp = split_plan(M, N, K);
  const long long count = (long long)M * N;
  const dim3 grid(cdiv(N, BN), cdiv(M, BM), sp.splits);
  const auto kernel = gemm_kernel<true, false, EPI_STORE>;
  LAUNCH(kernel, grid, NT, stream)(
      A, M, B, N, M, N, K, sp.k_split, partial, N, count, nullptr, 0.f, nullptr, 0);
  CHECK_LAUNCH();
  LAUNCH(reduce_splits_kernel, cdiv(count, 256), 256, stream)(partial, sp.splits, count,
                                                               1.f, out);
  CHECK_LAUNCH();
  return 0;
}

// out[j] = sum_p X[p, j] * (w ? w[p] : 1) over the P rows of X (P, N).
int colsum_reduced(const float* X, int P, int N, const float* w, float* out,
                   float* partial, cudaStream_t stream) {
  const ColsumPlan cp = colsum_plan(P, N);
  const dim3 grid(cdiv(N, COLSUM_THREADS), cp.splits, 1);
  LAUNCH(colsum_partial_kernel, grid, COLSUM_THREADS, stream)(X, P, N, w,
                                                              cp.rows_per_split, partial);
  CHECK_LAUNCH();
  LAUNCH(reduce_splits_kernel, cdiv(N, 256), 256, stream)(partial, cp.splits, N, 1.f,
                                                          out);
  CHECK_LAUNCH();
  return 0;
}

}  // namespace
