// Hand-written Hopper (sm_90a) kernels for the SIREN hot path.
//
// Replaces the three Pallas TPU kernels of
// mri_super_resolution_tpu/ops/pallas/siren_kernel.py that carry the INR
// pipelines:
//   K1 siren_loss_grads_f32 <- siren_loss_grads (one-pass forward + masked
//      MSE + backward; loss and dW/db, no dx, no network output)
//   K2 siren_fused_bwd_f32  <- _bwd of siren_fused (recompute the forward,
//      backprop an upstream g; dx and, when asked, dW/db)
//   K3 siren_forward_f32    <- siren_forward (fused MLP forward)
//
// Variants, chosen per call, that replace the JAX kernel's flags:
//   * per-layer activations (``acts``): ACT_SINE, ACT_RELU or ACT_NONE on
//     every hidden layer, ACT_RELU or ACT_NONE on the last; the JAX
//     ``acts`` tuple (plain Siren: sine..., none; SirenERD: sine..., relu,
//     relu). K1, K2 and K3 all take them. ReLU's derivative is the step
//     z > 0, 0 at z = 0, as the JAX kernel stashes it;
//   * K1 ``sw`` != nullptr: ``sample_weights``, the acceptance-weighted MSE
//     (sum of sw * r^2 over the real rows / (n_rows * out_dim), gradient
//     2 sw r / N) of the 2-D directional ensemble;
//   * K1 ``absmax`` != nullptr: ``with_out_absmax``, max |out| over the real
//     rows after the last activation, the collapse-restart signal of the
//     soft-ERD fit. The per-block maxima are reduced by a second pass; a
//     max does not depend on the order, so it is exact and repeats.
// The TPU kernel's ``row_split`` only re-schedules VLIW bundles inside a
// tile and computes the same result: it has no counterpart here.
//
// Contract shared by the three entry points (the Python wrappers in
// ops/siren_kernel.py check it before calling):
//   * float32, row-major, contiguous; x is (P, d_0);
//   * layer l has W_l of shape (d_{l+1}, d_l) (torch nn.Linear layout) and
//     b_l of shape (d_{l+1},); a_{l+1} = act_l(a_l W_l^T + b_l) with sine
//     meaning sin(omega_l z); d_L == 1;
//   * every launch goes to the caller's stream; nothing here allocates or
//     synchronises; each entry point returns cudaGetLastError() of the first
//     launch that failed (0 on success).
//
// What bounds them on an H100: the products. K1 is 2 * 2,622,976 FLOP per
// row at the 256 -> 512x4 -> 1 flagship (367 GFLOP per step at P = 70,000)
// against about 0.2 GB of compulsory traffic, so at the card's 67 TFLOP/s of
// float32 FMA it is bound by operations (5.5 ms), not by bytes (under 0.1 ms).
// At the 2-D ensemble's 2 -> 64x7 -> 1 on 3,600 rows a call is 0.54 GFLOP
// (8 us at that rate) in about 48 launches, so launch and host time bound
// it there, not the card.
// The design keeps the arithmetic in float32 (the TPU kernel's f32
// accumulation contract; no TF32, no bf16) and does it all in one tiled
// SIMT GEMM with fused epilogues:
//   forward    z = a W^T + b, act(z) written, act'(z) stashed (f32) when a
//              backward follows (omega cos(omega z) for sine, the step for
//              ReLU, nothing for none);
//   chain      delta_{l-1} = (delta_l W_l) * stash_{l-1};
//   weights    dW_l = delta_l^T a_l, reduced over all P rows by split-K
//              partials and a second pass (deterministic: no atomics);
//   last layer (D -> 1) is one warp per row with the activation, the masked
//              (weighted) residual, a per-block loss partial and the
//              per-block max |out| fused in (K1).
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

enum Act { ACT_NONE = 0, ACT_SINE = 1, ACT_RELU = 2 };

// out[p, i] = (d[p] * w[i]) * F[p, i] (F == nullptr: 1): the chain step
// through the D -> 1 layer.
__global__ void outer_mul_kernel(const float* __restrict__ d, const float* __restrict__ w,
                                 const float* __restrict__ F, int P, int D,
                                 float* __restrict__ out) {
  const long long total = (long long)P * D;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long p = e / D;
    const int i = (int)(e - p * D);
    out[e] = F ? (d[p] * w[i]) * F[e] : d[p] * w[i];
  }
}

// Forward through the hidden layers 0..L-2, writing a_{l+1} to acts[l] and,
// unless facts == nullptr, act_l'(z_l) to facts[l] (nothing for ACT_NONE).
int forward_hidden_layers(const float* x, int P, const int* dims, int n_layers,
                          const int* act, const float* const* W, const float* const* b,
                          const float* omegas, float* const* acts, float* const* facts,
                          cudaStream_t stream) {
  const float* h = x;
  for (int l = 0; l + 1 < n_layers; ++l) {
    float* dst = acts[l];
    float* f = facts ? facts[l] : nullptr;
    const int din = dims[l], dout = dims[l + 1];
    int rc;
    if (act[l] == ACT_SINE) {
      rc = gemm<false, true, EPI_SINE>(h, din, W[l], din, P, dout, din, dst, dout, b[l],
                                       omegas[l], f, dout, stream);
    } else if (act[l] == ACT_RELU) {
      rc = gemm<false, true, EPI_RELU>(h, din, W[l], din, P, dout, din, dst, dout, b[l],
                                       0.f, f, dout, stream);
    } else {
      rc = gemm<false, true, EPI_BIAS>(h, din, W[l], din, P, dout, din, dst, dout, b[l],
                                       0.f, nullptr, 0, stream);
    }
    if (rc) return rc;
    h = dst;
  }
  return 0;
}

// Backward chain from delta_last = dL/dz_{L-1} (P, 1). dW/db == nullptr skips
// the weight gradients; dx == nullptr skips dx.
int backprop(const float* x, int P, const int* dims, int n_layers, const int* act,
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
      delta_last, W[L - 1], act[L - 2] == ACT_NONE ? nullptr : facts[L - 2], P, d_last,
      cur);
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
      if (act[l - 1] == ACT_NONE) {
        rc = gemm<false, false, EPI_STORE>(cur, dout, W[l], din, P, din, dout, other, din,
                                           nullptr, 0.f, nullptr, 0, stream);
      } else {
        rc = gemm<false, false, EPI_MUL>(cur, dout, W[l], din, P, din, dout, other, din,
                                         nullptr, 0.f, facts[l - 1], din, stream);
      }
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

using RowdotFn = void (*)(const float*, int, int, const float*, const float*, float*,
                          const float*, int, float, float*, const float*, float*);

// The K1 last-layer kernel for a ReLU or linear output, with or without
// sample weights and the max |out| partials.
RowdotFn rowdot_loss_fn(bool relu, bool weighted, bool absmax) {
  const RowdotFn fns[8] = {
      rowdot_act_kernel<ROW_LOSS, false, false, false>,
      rowdot_act_kernel<ROW_LOSS, false, false, true>,
      rowdot_act_kernel<ROW_LOSS, false, true, false>,
      rowdot_act_kernel<ROW_LOSS, false, true, true>,
      rowdot_act_kernel<ROW_LOSS, true, false, false>,
      rowdot_act_kernel<ROW_LOSS, true, false, true>,
      rowdot_act_kernel<ROW_LOSS, true, true, false>,
      rowdot_act_kernel<ROW_LOSS, true, true, true>,
  };
  return fns[(relu ? 4 : 0) + (weighted ? 2 : 0) + (absmax ? 1 : 0)];
}

}  // namespace

extern "C" {

// Floats of split workspace the K1/K2 entry points need for these shapes
// (K1's loss partials, then its max |out| partials, fit in the first
// 2 * ROWDOT_MAX_BLOCKS).
long long siren_partial_floats(int P, const int* dims, int n_layers) {
  long long need = 2 * ROWDOT_MAX_BLOCKS;
  for (int l = 0; l < n_layers; ++l) {
    const long long g = reduced_partial_floats(P, dims[l + 1], dims[l]);
    if (g > need) need = g;
  }
  return need;
}

// K3: out (P, 1) = MLP(x). buf0/buf1: (P, max hidden width) scratch.
int siren_forward_f32(const float* x, int P, const int* dims, int n_layers, const int* act,
                      const float* const* W, const float* const* b, const float* omegas,
                      float* out, float* buf0, float* buf1, cudaStream_t stream) {
  const int L = n_layers;
  std::vector<float*> ping(L - 1);  // layer outputs alternate between buffers
  for (int l = 0; l + 1 < L; ++l) ping[l] = (l % 2 == 0) ? buf0 : buf1;
  int rc = forward_hidden_layers(x, P, dims, L, act, W, b, omegas, ping.data(), nullptr,
                                 stream);
  if (rc) return rc;
  const int blocks = rowdot_blocks(P);
  if (act[L - 1] == ACT_RELU) {
    const auto kernel = rowdot_act_kernel<ROW_OUT, true, false, false>;
    LAUNCH(kernel, blocks, ROWDOT_WARPS * 32, stream)(
        ping[L - 2], P, dims[L - 1], W[L - 1], b[L - 1], out, nullptr, 0, 0.f, nullptr,
        nullptr, nullptr);
  } else {
    const auto kernel = rowdot_kernel<false>;
    LAUNCH(kernel, blocks, ROWDOT_WARPS * 32, stream)(
        ping[L - 2], P, dims[L - 1], W[L - 1], b[L - 1], out, nullptr, 0, 0.f, nullptr);
  }
  CHECK_LAUNCH();
  return 0;
}

// K1: loss = inv_n * sum_{p < n_rows} s_p (MLP(x)_p - target_p)^2 (s_p =
// sw[p], or 1 when sw == nullptr) and its weight gradients dW/db; when
// absmax != nullptr also max_{p < n_rows} |MLP(x)_p|. acts[l], facts[l]
// (l < L-1): (P, d_{l+1}) stash buffers; delta0/delta1: (P, max hidden
// width); partial: siren_partial_floats floats.
int siren_loss_grads_f32(const float* x, int P, int n_rows, const int* dims,
                         int n_layers, const int* act, const float* const* W,
                         const float* const* b, const float* omegas, const float* target,
                         const float* sw, float inv_n, float* const* acts,
                         float* const* facts, float* delta0, float* delta1, float* partial,
                         float* const* dW, float* const* db, float* loss, float* absmax,
                         cudaStream_t stream) {
  int rc = forward_hidden_layers(x, P, dims, n_layers, act, W, b, omegas, acts, facts,
                                 stream);
  if (rc) return rc;
  const int L = n_layers;
  const int blocks = rowdot_blocks(P);
  float* absmax_partial = partial + ROWDOT_MAX_BLOCKS;
  const RowdotFn kernel = rowdot_loss_fn(act[L - 1] == ACT_RELU, sw != nullptr,
                                         absmax != nullptr);
  LAUNCH(kernel, blocks, ROWDOT_WARPS * 32, stream)(
      acts[L - 2], P, dims[L - 1], W[L - 1], b[L - 1], delta0, target, n_rows,
      2.f * inv_n, partial, sw, absmax_partial);
  CHECK_LAUNCH();
  LAUNCH(sum_kernel, 1, 1024, stream)(partial, (long long)blocks, inv_n, loss);
  CHECK_LAUNCH();
  if (absmax != nullptr) {
    LAUNCH(max_kernel, 1, 1024, stream)(absmax_partial, (long long)blocks, absmax);
    CHECK_LAUNCH();
  }
  return backprop(x, P, dims, n_layers, act, W, acts, facts, delta0, delta0, delta1,
                  partial, dW, db, nullptr, stream);
}

// K2: given g = dL/d out (P, 1), dx (P, d_0) and, when dW != nullptr, dW/db.
// Buffers as for K1; with a ReLU last layer delta0 first holds g * step.
int siren_fused_bwd_f32(const float* x, int P, const int* dims, int n_layers,
                        const int* act, const float* const* W, const float* const* b,
                        const float* omegas, const float* g, float* const* acts,
                        float* const* facts, float* delta0, float* delta1,
                        float* partial, float* const* dW, float* const* db, float* dx,
                        cudaStream_t stream) {
  int rc = forward_hidden_layers(x, P, dims, n_layers, act, W, b, omegas, acts, facts,
                                 stream);
  if (rc) return rc;
  const int L = n_layers;
  const float* delta_last = g;
  if (act[L - 1] == ACT_RELU) {
    const auto kernel = rowdot_act_kernel<ROW_GRAD, true, false, false>;
    LAUNCH(kernel, rowdot_blocks(P), ROWDOT_WARPS * 32, stream)(
        acts[L - 2], P, dims[L - 1], W[L - 1], b[L - 1], delta0, g, 0, 0.f, nullptr,
        nullptr, nullptr);
    CHECK_LAUNCH();
    delta_last = delta0;
  }
  return backprop(x, P, dims, n_layers, act, W, acts, facts, delta_last, delta0, delta1,
                  partial, dW, db, dx, stream);
}

}  // extern "C"
