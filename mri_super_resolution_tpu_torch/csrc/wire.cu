// Hand-written Hopper (sm_90a) kernels for the WIRE (complex Gabor) path.
//
// Replaces the two Pallas TPU kernels of
// mri_super_resolution_tpu/ops/pallas/wire_kernel.py:
//   K4 wire_loss_grads_f32 <- wire_loss_grads (one-pass forward, masked MSE
//      and hand-derived backward: loss and the gradient of every weight;
//      omega/sigma are read, never differentiated)
//   K5 wire_forward_f32    <- wire_forward (fused Gabor forward, real output)
//
// The network, paired-real (wire_kernel.py:13-26 of the JAX package):
//   first layer   s = x W^T + b, s2 = x Wo^T + bo           (real input)
//                 u = -sigma^2 (s^2 + s2^2)
//   hidden layer  s = h K + b, s2 = h K2 + b2                (complex linear)
//                 u = -omega si - sigma^2 (|s|^2 + |s2|^2)
//   activation    m = exp(u); h' = m (cos(omega sr) + i sin(omega sr))
//   final layer   out = hr Kr^T - hi Ki^T + br               (real part)
// with omega/sigma per layer from a device array oms (n_layers, 2), so a run
// reads trained values and never syncs with the host for them. The single
// exponential exp(-omega si - sigma^2 ...) is the kernels' contract (the
// model writes two; exp(-omega si) alone can overflow where the product
// cannot).
//
// Contract of the entry points (ops/wire_kernel.py checks it before calling):
//   * float32, row-major, contiguous; x is (P, d_in);
//   * weights w[] in the JAX kernel's flat order, torch (out, in) layout:
//       first  W (H, d_in), b (H), Wo (H, d_in), bo (H)
//       hidden Kr, Ki (H, H), br, bi (H), K2r, K2i (H, H), b2r, b2i (H)
//       final  Kr (1, H), Ki (1, H), br (1)
//   * every launch goes to the caller's stream; nothing here allocates or
//     synchronises; each entry point returns the cudaGetLastError() of the
//     first launch that failed (0 on success).
//
// Design. One complex layer is one real GEMM: [hr | hi] (P x 2H) times the
// block matrix [[Kr, -Ki], [Ki, Kr], [K2r, -K2i], [K2i, K2r]] (4H x 2H, rows
// = outputs) gives [sr | si | s2r | s2i] (P x 4H), bias in the epilogue; the
// first layer is [W; Wo] (2H x d_in) against x. pack_kernel assembles the
// block matrices from the weights on the device each call. A Gabor pass then
// reads the four panels and writes [hr | hi]. The backward is two GEMMs of
// the same block form per layer: dWblk = dS^T [hr | hi] (split-K partials
// and a second reduction pass: deterministic, no atomics), folded back into
// the eight weight gradients by unpack_kernel (dKr = blk(0,0) + blk(1,1),
// dKi = blk(1,0) - blk(0,1), ...), and dh = dS Wblk for the layer below.
// The masked residual is fused into the last layer (one warp per row); the
// first Gabor backward reads the residual and the final weights directly.
// The stash is the layer inputs [hr | hi] and the pre-activations S, in f32
// in device memory (16 panels of P x H at two hidden layers, plus 6 of
// scratch: 1.6 GB at P = 70,000, H = 256); m and the sine/cosine are
// recomputed in the backward instead of stashed.
//
// What bounds them on an H100: the products. K4 at 4 -> 256x2 -> 1 is
// 2 * 3,151,360 FLOP per row (441 GFLOP per step at P = 70,000) against a
// few MB of compulsory traffic, so at the card's 67 TFLOP/s of float32 FMA
// it is bound by operations (6.6 ms). All arithmetic is float32 (no TF32, no
// bf16). The TPU kernel kept every weight resident in VMEM per row tile; a
// 512-wide block matrix is 8 MB, far over an SM's shared memory, so here each
// layer is its own pass and the 16 MB scoped-VMEM gate of the TPU
// (wire_kernel_fits) has no counterpart: any width runs.
//
// Transcendentals: expf and sincosf, the accurate CUDA math-library routines
// (never --use_fast_math: -omega si is not bounded and omega sr reaches tens).

#include <vector>

#include "common.cuh"

namespace {

// Up to eight source blocks of pack_kernel, each with a sign.
struct Blocks {
  const float* src[8];
  float sign[8];
};

// dst ((rb h) x (cb w), row-major) = block matrix whose block (i, j) is
// sign[i cb + j] * src[i cb + j] (h x w, row-major).
__global__ void pack_kernel(Blocks blk, int rb, int cb, int h, int w,
                            float* __restrict__ dst) {
  const long long cols = (long long)cb * w;
  const long long total = (long long)rb * h * cols;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / cols;
    const int col = (int)(e - row * cols);
    const int bi = (int)(row / h);
    const int r = (int)(row - (long long)bi * h);
    const int bj = col / w;
    const int c = col - bj * w;
    const int k = bi * cb + bj;
    dst[e] = blk.sign[k] * blk.src[k][(long long)r * w + c];
  }
}

// Up to four outputs of unpack_kernel, each the signed sum of up to two
// blocks (block index i cb + j, -1 for none).
struct Terms {
  float* dst[4];
  int blk[4][2];
  float sign[4][2];
};

// dst[q] (h x w) = sum_t sign[q][t] * block blk[q][t] of src ((. h) x (cb w)).
__global__ void unpack_kernel(const float* __restrict__ src, int cb, int h, int w,
                              int n_out, Terms t) {
  const long long per = (long long)h * w;
  const long long total = per * n_out;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int q = (int)(e / per);
    const long long rc = e - q * per;
    const int r = (int)(rc / w);
    const int c = (int)(rc - (long long)r * w);
    float s = 0.f;
    for (int i = 0; i < 2; ++i) {
      const int k = t.blk[q][i];
      if (k < 0) continue;
      const int bi = k / cb;
      const int bj = k - bi * cb;
      s += t.sign[q][i] * src[((long long)bi * h + r) * ((long long)cb * w) + bj * w + c];
    }
    t.dst[q][rc] = s;
  }
}

// One Gabor activation. Rows of S hold the panels [sr | s2r] (FIRST, real
// input) or [sr | si | s2r | s2i], each H wide; rows of out are [hr | hi].
// om_sg points at this layer's (omega, sigma).
template <bool FIRST>
__global__ void gabor_fwd_kernel(const float* __restrict__ S, int P, int H,
                                 const float* __restrict__ om_sg,
                                 float* __restrict__ out) {
  const float om = om_sg[0];
  const float sg2 = om_sg[1] * om_sg[1];
  const long long total = (long long)P * H;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long p = e / H;
    const int j = (int)(e - p * H);
    const float* s = S + p * (FIRST ? 2 : 4) * H;
    const float sr = s[j];
    float u;
    if (FIRST) {
      const float s2r = s[H + j];
      u = -sg2 * (sr * sr + s2r * s2r);
    } else {
      const float si = s[H + j];
      const float s2r = s[2 * H + j];
      const float s2i = s[3 * H + j];
      u = -om * si - sg2 * (sr * sr + si * si + s2r * s2r + s2i * s2i);
    }
    const float m = expf(u);
    float sn, cs;
    sincosf(om * sr, &sn, &cs);
    float* o = out + p * 2 * H;
    o[j] = m * cs;
    o[H + j] = m * sn;
  }
}

// Backward of one Gabor activation: dS (same panels as S) from the upstream
// [dhr | dhi], read from dH (P x 2H) or, when dH == nullptr, formed from the
// final layer as delta[p] * wfin (wfin = [Kr | -Ki] of the final layer).
template <bool FIRST>
__global__ void gabor_bwd_kernel(const float* __restrict__ S, int P, int H,
                                 const float* __restrict__ om_sg,
                                 const float* __restrict__ dH,
                                 const float* __restrict__ delta,
                                 const float* __restrict__ wfin,
                                 float* __restrict__ dS) {
  const float om = om_sg[0];
  const float sg2 = om_sg[1] * om_sg[1];
  const long long total = (long long)P * H;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long p = e / H;
    const int j = (int)(e - p * H);
    float dhr, dhi;
    if (dH != nullptr) {
      dhr = dH[p * 2 * H + j];
      dhi = dH[p * 2 * H + H + j];
    } else {
      dhr = delta[p] * wfin[j];
      dhi = delta[p] * wfin[H + j];
    }
    const int ns = FIRST ? 2 : 4;
    const float* s = S + p * ns * H;
    float* ds = dS + p * ns * H;
    const float sr = s[j];
    float si = 0.f, s2r, s2i = 0.f, u;
    if (FIRST) {
      s2r = s[H + j];
      u = -sg2 * (sr * sr + s2r * s2r);
    } else {
      si = s[H + j];
      s2r = s[2 * H + j];
      s2i = s[3 * H + j];
      u = -om * si - sg2 * (sr * sr + si * si + s2r * s2r + s2i * s2i);
    }
    const float m = expf(u);
    float sn, cs;
    sincosf(om * sr, &sn, &cs);
    const float du = (dhr * cs + dhi * sn) * m;
    ds[j] = du * (-2.f * sg2 * sr) + om * m * (dhi * cs - dhr * sn);
    if (FIRST) {
      ds[H + j] = du * (-2.f * sg2 * s2r);
    } else {
      ds[H + j] = du * (-om - 2.f * sg2 * si);
      ds[2 * H + j] = du * (-2.f * sg2 * s2r);
      ds[3 * H + j] = du * (-2.f * sg2 * s2i);
    }
  }
}

// Offsets (floats) of the packed weights: [W; Wo], [b | bo], then per hidden
// layer the 4H x 2H block matrix and its 4H bias, then wfin = [Kr | -Ki].
struct Packed {
  long long w0, b0, hidden, hidden_stride, fin, total;
};

Packed packed_layout(int d, int H, int nh) {
  Packed L;
  L.w0 = 0;
  L.b0 = 2LL * H * d;
  L.hidden = L.b0 + 2LL * H;
  L.hidden_stride = 8LL * H * H + 4LL * H;
  L.fin = L.hidden + nh * L.hidden_stride;
  L.total = L.fin + 2LL * H;
  return L;
}

// Offsets (floats) of K4's workspace: the block gradient of one layer, its
// bias gradient, the residual delta (P) and the split partials.
struct Work {
  long long gblk, gbias, delta, partial, total;
};

Work work_layout(int P, int d, int H, int nh) {
  Work L;
  const long long blk = nh > 0 ? 8LL * H * H : 2LL * H * d;
  L.gblk = 0;
  L.gbias = blk > 2LL * H * d ? blk : 2LL * H * d;
  L.delta = L.gbias + 4LL * H;
  L.partial = L.delta + P;
  long long need = ROWDOT_MAX_BLOCKS;
  const long long first = reduced_partial_floats(P, 2 * H, d);
  if (first > need) need = first;
  if (nh > 0) {
    const long long hid = reduced_partial_floats(P, 4 * H, 2 * H);
    if (hid > need) need = hid;
  }
  L.total = L.partial + need;
  return L;
}

int pack(const Blocks& b, int rb, int cb, int h, int w, float* dst, cudaStream_t stream) {
  LAUNCH(pack_kernel, ew_blocks((long long)rb * cb * h * w), EW_THREADS, stream)(
      b, rb, cb, h, w, dst);
  CHECK_LAUNCH();
  return 0;
}

int pack_weights(const float* const* w, int d, int H, int nh, float* packed,
                 cudaStream_t stream) {
  const Packed L = packed_layout(d, H, nh);
  int rc = pack({{w[0], w[2]}, {1.f, 1.f}}, 2, 1, H, d, packed + L.w0, stream);
  if (rc) return rc;
  rc = pack({{w[1], w[3]}, {1.f, 1.f}}, 1, 2, 1, H, packed + L.b0, stream);
  if (rc) return rc;
  for (int l = 0; l < nh; ++l) {
    const float* const* k = w + 4 + 8 * l;  // Kr Ki br bi K2r K2i b2r b2i
    float* dst = packed + L.hidden + l * L.hidden_stride;
    rc = pack({{k[0], k[1], k[1], k[0], k[4], k[5], k[5], k[4]},
               {1.f, -1.f, 1.f, 1.f, 1.f, -1.f, 1.f, 1.f}},
              4, 2, H, H, dst, stream);
    if (rc) return rc;
    rc = pack({{k[2], k[3], k[6], k[7]}, {1.f, 1.f, 1.f, 1.f}}, 1, 4, 1, H,
              dst + 8LL * H * H, stream);
    if (rc) return rc;
  }
  const float* const* f = w + 4 + 8 * nh;
  return pack({{f[0], f[1]}, {1.f, -1.f}}, 1, 2, 1, H, packed + L.fin, stream);
}

int unpack(const float* src, int cb, int h, int w, int n_out, const Terms& t,
           cudaStream_t stream) {
  LAUNCH(unpack_kernel, ew_blocks((long long)n_out * h * w), EW_THREADS, stream)(
      src, cb, h, w, n_out, t);
  CHECK_LAUNCH();
  return 0;
}

// Forward through every Gabor layer: S[l] gets layer l's pre-activations,
// A[l] its output [hr | hi].
int forward_layers(const float* x, int P, int d, int H, int nh, const float* packed,
                   const float* oms, float* const* S, float* const* A,
                   cudaStream_t stream) {
  const Packed L = packed_layout(d, H, nh);
  int rc = gemm<false, true, EPI_BIAS>(x, d, packed + L.w0, d, P, 2 * H, d, S[0],
                                       2 * H, packed + L.b0, 0.f, nullptr, 0, stream);
  if (rc) return rc;
  const long long ew = (long long)P * H;
  LAUNCH(gabor_fwd_kernel<true>, ew_blocks(ew), EW_THREADS, stream)(S[0], P, H, oms,
                                                                     A[0]);
  CHECK_LAUNCH();
  for (int l = 1; l <= nh; ++l) {
    const float* blk = packed + L.hidden + (l - 1) * L.hidden_stride;
    rc = gemm<false, true, EPI_BIAS>(A[l - 1], 2 * H, blk, 2 * H, P, 4 * H, 2 * H, S[l],
                                     4 * H, blk + 8LL * H * H, 0.f, nullptr, 0, stream);
    if (rc) return rc;
    LAUNCH(gabor_fwd_kernel<false>, ew_blocks(ew), EW_THREADS, stream)(
        S[l], P, H, oms + 2 * l, A[l]);
    CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of the packed-weight buffer both entry points need.
long long wire_pack_floats(int d_in, int H, int n_hidden) {
  return packed_layout(d_in, H, n_hidden).total;
}

// Floats of K4's workspace for these shapes.
long long wire_work_floats(int P, int d_in, int H, int n_hidden) {
  return work_layout(P, d_in, H, n_hidden).total;
}

// K5: out (P, 1) = WIRE(x). packed: wire_pack_floats floats; S: (P, 4H)
// (P, 2H without hidden layers); buf0, buf1: (P, 2H).
int wire_forward_f32(const float* x, int P, int d_in, int H, int n_hidden,
                     const float* const* w, const float* oms, float* out,
                     float* packed, float* S, float* buf0, float* buf1,
                     cudaStream_t stream) {
  int rc = pack_weights(w, d_in, H, n_hidden, packed, stream);
  if (rc) return rc;
  std::vector<float*> s(n_hidden + 1, S);
  std::vector<float*> a(n_hidden + 1);
  for (int l = 0; l <= n_hidden; ++l) a[l] = (l % 2 == 0) ? buf0 : buf1;
  rc = forward_layers(x, P, d_in, H, n_hidden, packed, oms, s.data(), a.data(), stream);
  if (rc) return rc;
  const Packed L = packed_layout(d_in, H, n_hidden);
  const auto kernel = rowdot_kernel<false>;
  LAUNCH(kernel, rowdot_blocks(P), ROWDOT_WARPS * 32, stream)(
      a[n_hidden], P, 2 * H, packed + L.fin, w[4 + 8 * n_hidden + 2], out, nullptr, 0,
      0.f, nullptr);
  CHECK_LAUNCH();
  return 0;
}

// K4: loss = inv_n * sum_{p < n_rows} (WIRE(x)_p - target_p)^2 and the
// gradient of every weight into dw[] (same order and shapes as w[]).
// S[0]: (P, 2H); S[l], l = 1..n_hidden: (P, 4H); A[l], l = 0..n_hidden:
// (P, 2H); dS: (P, 4H) ((P, 2H) without hidden layers); dH: (P, 2H) (unused
// without hidden layers); packed: wire_pack_floats; work: wire_work_floats.
int wire_loss_grads_f32(const float* x, int P, int n_rows, int d_in, int H,
                        int n_hidden, const float* const* w, const float* oms,
                        const float* target, float inv_n, float* packed,
                        float* const* S, float* const* A, float* dS, float* dH,
                        float* work, float* const* dw, float* loss,
                        cudaStream_t stream) {
  const int nh = n_hidden;
  const Packed L = packed_layout(d_in, H, nh);
  const Work W = work_layout(P, d_in, H, nh);
  float* gblk = work + W.gblk;
  float* gbias = work + W.gbias;
  float* delta = work + W.delta;
  float* partial = work + W.partial;
  const float* wfin = packed + L.fin;
  const int fin = 4 + 8 * nh;
  const long long ew = (long long)P * H;

  int rc = pack_weights(w, d_in, H, nh, packed, stream);
  if (rc) return rc;
  rc = forward_layers(x, P, d_in, H, nh, packed, oms, S, A, stream);
  if (rc) return rc;

  // final layer: residual, loss, and the final weights' gradients
  const int blocks = rowdot_blocks(P);
  const auto rowdot = rowdot_kernel<true>;
  LAUNCH(rowdot, blocks, ROWDOT_WARPS * 32, stream)(
      A[nh], P, 2 * H, wfin, w[fin + 2], delta, target, n_rows, 2.f * inv_n, partial);
  CHECK_LAUNCH();
  LAUNCH(sum_kernel, 1, 1024, stream)(partial, (long long)blocks, inv_n, loss);
  CHECK_LAUNCH();
  rc = colsum_reduced(A[nh], P, 2 * H, delta, gbias, partial, stream);
  if (rc) return rc;
  rc = unpack(gbias, 2, 1, H, 2, {{dw[fin], dw[fin + 1]}, {{0, -1}, {1, -1}},
                                  {{1.f, 0.f}, {-1.f, 0.f}}}, stream);
  if (rc) return rc;
  LAUNCH(sum_kernel, 1, 1024, stream)(delta, (long long)P, 1.f, dw[fin + 2]);
  CHECK_LAUNCH();

  // hidden layers, top down
  const float* dh = nullptr;  // the first backward step reads delta and wfin
  for (int l = nh; l >= 1; --l) {
    const float* blk = packed + L.hidden + (l - 1) * L.hidden_stride;
    float* const* g = dw + 4 + 8 * (l - 1);  // Kr Ki br bi K2r K2i b2r b2i
    LAUNCH(gabor_bwd_kernel<false>, ew_blocks(ew), EW_THREADS, stream)(
        S[l], P, H, oms + 2 * l, dh, delta, wfin, dS);
    CHECK_LAUNCH();
    // block (i, j) of dWblk: i in [sr, si, s2r, s2i] rows, j in [hr, hi]
    rc = gemm_tn_reduced(dS, 4 * H, A[l - 1], 2 * H, P, gblk, partial, stream);
    if (rc) return rc;
    rc = unpack(gblk, 2, H, H, 4,
                {{g[0], g[1], g[4], g[5]},
                 {{0, 3}, {2, 1}, {4, 7}, {6, 5}},
                 {{1.f, 1.f}, {1.f, -1.f}, {1.f, 1.f}, {1.f, -1.f}}},
                stream);
    if (rc) return rc;
    rc = colsum_reduced(dS, P, 4 * H, nullptr, gbias, partial, stream);
    if (rc) return rc;
    rc = unpack(gbias, 4, 1, H, 4,
                {{g[2], g[3], g[6], g[7]},
                 {{0, -1}, {1, -1}, {2, -1}, {3, -1}},
                 {{1.f, 0.f}, {1.f, 0.f}, {1.f, 0.f}, {1.f, 0.f}}},
                stream);
    if (rc) return rc;
    // upstream gradient of the layer below: [dhr | dhi] = dS Wblk
    rc = gemm<false, false, EPI_STORE>(dS, 4 * H, blk, 2 * H, P, 2 * H, 4 * H, dH, 2 * H,
                                       nullptr, 0.f, nullptr, 0, stream);
    if (rc) return rc;
    dh = dH;
  }

  // first layer (real input): dS holds [dsr | ds2r]
  LAUNCH(gabor_bwd_kernel<true>, ew_blocks(ew), EW_THREADS, stream)(
      S[0], P, H, oms, dh, delta, wfin, dS);
  CHECK_LAUNCH();
  rc = gemm_tn_reduced(dS, 2 * H, x, d_in, P, gblk, partial, stream);
  if (rc) return rc;
  rc = unpack(gblk, 1, H, d_in, 2, {{dw[0], dw[2]}, {{0, -1}, {1, -1}},
                                    {{1.f, 0.f}, {1.f, 0.f}}}, stream);
  if (rc) return rc;
  rc = colsum_reduced(dS, P, 2 * H, nullptr, gbias, partial, stream);
  if (rc) return rc;
  return unpack(gbias, 2, 1, H, 2, {{dw[1], dw[3]}, {{0, -1}, {1, -1}},
                                    {{1.f, 0.f}, {1.f, 0.f}}}, stream);
}

}  // extern "C"
