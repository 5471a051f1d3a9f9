// Hand-written Hopper (sm_90a) kernels for the SIREN hot path.
//
// Replaces the three Pallas TPU kernels of
// mri_super_resolution_tpu/ops/pallas/siren_kernel.py that carry the 3-D
// volume pipeline:
//   K1 siren_loss_grads_f32 <- siren_loss_grads (one-pass forward + masked
//      MSE + backward; loss and dW/db, no dx, no network output)
//   K2 siren_fused_bwd_f32  <- _bwd of siren_fused (recompute the forward,
//      backprop an upstream g; dx and, when asked, dW/db)
//   K3 siren_forward_f32    <- siren_forward (fused MLP forward)
//
// Contract shared by the three entry points (the Python wrappers in
// ops/siren_kernel.py check it before calling):
//   * float32, row-major, contiguous; x is (P, d_0);
//   * layer l has W_l of shape (d_{l+1}, d_l) (torch nn.Linear layout) and
//     b_l of shape (d_{l+1},); layers 0..L-2 are sine layers
//     a_{l+1} = sin(omega_l * (a_l W_l^T + b_l)), layer L-1 is linear with
//     d_L == 1;
//   * every launch goes to the caller's stream; nothing here allocates or
//     synchronises; each entry point returns cudaGetLastError() of the first
//     launch that failed (0 on success).
//
// What bounds them on an H100: the products. K1 is 2 * 2,622,976 FLOP per
// row at the 256 -> 512x4 -> 1 flagship (367 GFLOP per step at P = 70,000)
// against about 0.2 GB of compulsory traffic, so at the card's 67 TFLOP/s of
// float32 FMA it is bound by operations (5.5 ms), not by bytes (under 0.1 ms).
// The design keeps the arithmetic in float32 (the TPU kernel's f32
// accumulation contract; no TF32, no bf16) and does it all in one tiled
// SIMT GEMM with fused epilogues:
//   forward    z = a W^T + b, sin(omega z) written, omega cos(omega z)
//              stashed (f32) when a backward follows;
//   chain      delta_{l-1} = (delta_l W_l) * stash_{l-1};
//   weights    dW_l = delta_l^T a_l, reduced over all P rows by split-K
//              partials and a second pass (deterministic: no atomics);
//   last layer (512 -> 1) is one warp per row with the masked residual and a
//              per-block loss partial fused in (K1).
// The TPU kernel kept every weight resident in VMEM per row tile; one
// 512 x 512 f32 layer is 1 MB, over four times a Hopper SM's shared memory,
// so here each layer is its own pass over the (P, width) activations, which
// stay in device memory (4 activations + 4 stashes = 1.15 GB at P = 70,000).
//
// Trigonometry: sincosf, the accurate CUDA math-library routine (the file is
// never built with --use_fast_math: __sinf/__cosf lose accuracy outside
// [-pi, pi], and |omega z| reaches about 1e2 here).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren.so siren.cu   (see ops/_build.py)

#include <cuda_runtime.h>

#include <vector>

#ifndef LAUNCH
#define LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif

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

enum Epilogue { EPI_STORE = 0, EPI_SINE = 1, EPI_MUL = 2 };

// C[m, n] = sum_k Aop[m, k] * Bop[k, n] over k in this block's split.
//   Aop[m, k] = TA ? A[k * lda + m] : A[m * lda + k]
//   Bop[k, n] = TB ? B[n * ldb + k] : B[k * ldb + n]
// gridDim.z splits K into chunks of k_split; split z writes its partial sum
// at C + z * split_stride (split_stride = 0 when gridDim.z == 1).
// Epilogues: EPI_STORE writes C; EPI_SINE writes sin(omega (C + bias[n]))
// and, when F is given, F = omega cos(omega (C + bias[n])); EPI_MUL writes
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
      } else if (EPI == EPI_MUL) {
        C[off] = v * F[(long long)m * ldf + n];
      } else {
        C[off] = v;
      }
    }
  }
}

// Last layer (D -> 1): one warp per row. LOSS = false writes the output;
// LOSS = true (K1) writes delta = two_inv_n * r with r = out - target on rows
// below n_rows and 0 beyond, and one partial sum of r^2 per block.
template <bool LOSS>
__global__ void __launch_bounds__(ROWDOT_WARPS * 32) rowdot_kernel(
    const float* __restrict__ H, int P, int D, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out,
    const float* __restrict__ target, int n_rows, float two_inv_n,
    float* __restrict__ loss_partial) {
  __shared__ float red[ROWDOT_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float sq = 0.f;
  for (long long row = (long long)blockIdx.x * ROWDOT_WARPS + warp; row < P;
       row += (long long)gridDim.x * ROWDOT_WARPS) {
    const float* h = H + row * D;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s = fmaf(h[i], w[i], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float v = s + b[0];
      if (LOSS) {
        const float r = row < n_rows ? v - target[row] : 0.f;
        out[row] = two_inv_n * r;
        sq = fmaf(r, r, sq);
      } else {
        out[row] = v;
      }
    }
  }
  if (LOSS) {
    if (lane == 0) red[warp] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int i = 0; i < ROWDOT_WARPS; ++i) t += red[i];
      loss_partial[blockIdx.x] = t;
    }
  }
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

// out[p, i] = (d[p] * w[i]) * F[p, i]: the chain step through the D -> 1 layer.
__global__ void outer_mul_kernel(const float* __restrict__ d, const float* __restrict__ w,
                                 const float* __restrict__ F, int P, int D,
                                 float* __restrict__ out) {
  const long long total = (long long)P * D;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long p = e / D;
    const int i = (int)(e - p * D);
    out[e] = (d[p] * w[i]) * F[e];
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

#define CHECK_LAUNCH()                          \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

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

// Forward through the sine layers 0..L-2, writing a_{l+1} to acts[l] and,
// unless facts == nullptr, omega cos(omega z_l) to facts[l].
int forward_sine_layers(const float* x, int P, const int* dims, int n_layers,
                        const float* const* W, const float* const* b,
                        const float* omegas, float* const* acts, float* const* facts,
                        cudaStream_t stream) {
  const float* h = x;
  for (int l = 0; l + 1 < n_layers; ++l) {
    float* dst = acts[l];
    int rc = gemm<false, true, EPI_SINE>(h, dims[l], W[l], dims[l], P, dims[l + 1],
                                         dims[l], dst, dims[l + 1], b[l], omegas[l],
                                         facts ? facts[l] : nullptr, dims[l + 1], stream);
    if (rc) return rc;
    h = dst;
  }
  return 0;
}

// Backward chain from delta_last = dL/dz_{L-1} (P, 1). dW/db == nullptr skips
// the weight gradients; dx == nullptr skips dx.
int backprop(const float* x, int P, const int* dims, int n_layers,
             const float* const* W, float* const* acts, float* const* facts,
             const float* delta_last, float* delta0, float* delta1, float* partial,
             float* const* dW, float* const* db, float* dx, cudaStream_t stream) {
  const int L = n_layers;
  const int d_last = dims[L - 1];
  const float* a_last = acts[L - 2];
  int rc;
  if (dW != nullptr) {
    rc = colsum_reduced(a_last, P, d_last, delta_last, dW[L - 1], partial, stream);
    if (rc) return rc;
    LAUNCH(sum_kernel, 1, 1024, stream)(delta_last, (long long)P, 1.f, db[L - 1]);
    CHECK_LAUNCH();
  }
  // delta_{L-2} = (delta_last w^T) * stash_{L-2}
  float* cur = (delta_last == delta0) ? delta1 : delta0;
  float* other = (cur == delta0) ? delta1 : delta0;
  {
    const long long total = (long long)P * d_last;
    int blocks = cdiv(total, 256);
    if (blocks > 132 * 16) blocks = 132 * 16;
    LAUNCH(outer_mul_kernel, blocks, 256, stream)(delta_last, W[L - 1], facts[L - 2], P,
                                                  d_last, cur);
    CHECK_LAUNCH();
  }
  for (int l = L - 2; l >= 0; --l) {
    const float* a_in = (l == 0) ? x : acts[l - 1];
    const int din = dims[l];
    const int dout = dims[l + 1];
    if (dW != nullptr) {
      // dW_l (dout, din) = delta_l^T a_l; db_l = column sums of delta_l
      rc = gemm_tn_reduced(cur, dout, a_in, din, P, dW[l], partial, stream);
      if (rc) return rc;
      rc = colsum_reduced(cur, P, dout, nullptr, db[l], partial, stream);
      if (rc) return rc;
    }
    if (l > 0) {
      rc = gemm<false, false, EPI_MUL>(cur, dout, W[l], din, P, din, dout, other, din,
                                       nullptr, 0.f, facts[l - 1], din, stream);
      if (rc) return rc;
      float* t = cur;
      cur = other;
      other = t;
    } else if (dx != nullptr) {
      rc = gemm<false, false, EPI_STORE>(cur, dout, W[0], din, P, din, dout, dx, din,
                                         nullptr, 0.f, nullptr, 0, stream);
      if (rc) return rc;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of split workspace the K1/K2 entry points need for these shapes.
long long siren_partial_floats(int P, const int* dims, int n_layers) {
  long long need = ROWDOT_MAX_BLOCKS;
  for (int l = 0; l < n_layers; ++l) {
    const int din = dims[l];
    const int dout = dims[l + 1];
    const SplitPlan sp = split_plan(dout, din, P);
    const long long g = (long long)sp.splits * dout * din;
    if (g > need) need = g;
    const ColsumPlan cb = colsum_plan(P, dout);
    const long long c = (long long)cb.splits * dout;
    if (c > need) need = c;
    const ColsumPlan ca = colsum_plan(P, din);
    const long long c2 = (long long)ca.splits * din;
    if (c2 > need) need = c2;
  }
  return need;
}

// K3: out (P, 1) = MLP(x). buf0/buf1: (P, max hidden width) scratch.
int siren_forward_f32(const float* x, int P, const int* dims, int n_layers,
                      const float* const* W, const float* const* b, const float* omegas,
                      float* out, float* buf0, float* buf1, cudaStream_t stream) {
  const int L = n_layers;
  std::vector<float*> ping(L - 1);  // layer outputs alternate between buffers
  for (int l = 0; l + 1 < L; ++l) ping[l] = (l % 2 == 0) ? buf0 : buf1;
  int rc = forward_sine_layers(x, P, dims, L, W, b, omegas, ping.data(), nullptr, stream);
  if (rc) return rc;
  const auto kernel = rowdot_kernel<false>;
  LAUNCH(kernel, rowdot_blocks(P), ROWDOT_WARPS * 32, stream)(
      ping[L - 2], P, dims[L - 1], W[L - 1], b[L - 1], out, nullptr, 0, 0.f, nullptr);
  CHECK_LAUNCH();
  return 0;
}

// K1: loss = inv_n * sum_{p < n_rows} (MLP(x)_p - target_p)^2 and its weight
// gradients dW/db. acts[l], facts[l] (l < L-1): (P, d_{l+1}) stash buffers;
// delta0/delta1: (P, max hidden width); partial: siren_partial_floats floats.
int siren_loss_grads_f32(const float* x, int P, int n_rows, const int* dims,
                         int n_layers, const float* const* W, const float* const* b,
                         const float* omegas, const float* target, float inv_n,
                         float* const* acts, float* const* facts, float* delta0,
                         float* delta1, float* partial, float* const* dW,
                         float* const* db, float* loss, cudaStream_t stream) {
  int rc = forward_sine_layers(x, P, dims, n_layers, W, b, omegas, acts, facts, stream);
  if (rc) return rc;
  const int L = n_layers;
  const int blocks = rowdot_blocks(P);
  const auto kernel = rowdot_kernel<true>;
  LAUNCH(kernel, blocks, ROWDOT_WARPS * 32, stream)(
      acts[L - 2], P, dims[L - 1], W[L - 1], b[L - 1], delta0, target, n_rows,
      2.f * inv_n, partial);
  CHECK_LAUNCH();
  LAUNCH(sum_kernel, 1, 1024, stream)(partial, (long long)blocks, inv_n, loss);
  CHECK_LAUNCH();
  return backprop(x, P, dims, n_layers, W, acts, facts, delta0, delta0, delta1, partial,
                  dW, db, nullptr, stream);
}

// K2: given g = dL/d out (P, 1), dx (P, d_0) and, when dW != nullptr, dW/db.
// Buffers as for K1.
int siren_fused_bwd_f32(const float* x, int P, const int* dims, int n_layers,
                        const float* const* W, const float* const* b,
                        const float* omegas, const float* g, float* const* acts,
                        float* const* facts, float* delta0, float* delta1,
                        float* partial, float* const* dW, float* const* db, float* dx,
                        cudaStream_t stream) {
  int rc = forward_sine_layers(x, P, dims, n_layers, W, b, omegas, acts, facts, stream);
  if (rc) return rc;
  return backprop(x, P, dims, n_layers, W, acts, facts, g, delta0, delta1, partial, dW,
                  db, dx, stream);
}

}  // extern "C"
