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
// The GEMM, the last-layer and reduction kernels are in common.cuh (shared
// with wire.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren.so siren.cu   (see ops/_build.py)

#include <vector>

#include "common.cuh"

namespace {

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
  LAUNCH(outer_mul_kernel, ew_blocks((long long)P * d_last), EW_THREADS, stream)(
      delta_last, W[L - 1], facts[L - 2], P, d_last, cur);
  CHECK_LAUNCH();
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
    const long long g = reduced_partial_floats(P, dims[l + 1], dims[l]);
    if (g > need) need = g;
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
