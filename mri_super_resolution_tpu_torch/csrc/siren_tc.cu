// Hand-written Hopper (sm_90a) tensor-core route of the SIREN kernels K1
// (siren_loss_grads), K2 (siren_fused's backward) and K3 (siren_forward)
// for the plain Siren at the 3-D pipeline's widths.
//
// Replaces, for the calls whose widths fit its tiling, the Pallas TPU
// kernels of mri_super_resolution_tpu/ops/pallas/siren_kernel.py:
//   K1 siren_loss_grads (:518, pallas_call at :580): one-pass forward,
//      masked MSE and backward, giving the loss and every dW and db;
//   K2 siren_fused's _bwd (:377, pallas_call at :401): the forward again,
//      then an upstream g (P, 1) back to dx and, when asked, every dW, db;
//   K3 siren_forward (:240, pallas_call at :258): the MLP's output (P, 1).
// ops/siren_kernel.py chooses this route from the shapes alone: sine on
// every hidden layer, a linear last layer of one output, no sample weights,
// no max |out| (K1), and the input and every hidden width a multiple of
// 128. csrc/siren.cu's SIMT kernels keep every other call.
//
// Numerics. The TPU kernel's float32 dots run on the MXU as multi-pass
// bf16; the counterpart here is the bf16x3 split on the tensor cores. Each
// float32 operand x becomes hi = bf16(x) and lo = bf16(x - hi), both rounded
// to nearest even (|x - hi - lo| <= 2^-16 |x|), and each product is
// hi hi + hi lo + lo hi on mma.sync m16n8k16 with float32 accumulation (lo lo,
// below 2^-16 of the product, is dropped). Everything else stays float32:
// the bias, the sine and omega cos(omega z) (sincosf, never fast math), the
// warp-per-row last layer with the masked residual, the loss, db, and the
// fixed-order split-K reduction of dW (no atomics: a run repeats bit for
// bit). The activations and the chain's deltas live in device memory as hi
// and lo bf16 planes (4 bytes an element, as float32), written by the
// epilogue that makes them, so that the GEMMs read them with ldmatrix and
// split nothing in their main loops; the weights are split once a call. The
// last hidden activation is written in float32 instead, for the float32
// last layer; the factors omega cos(omega z) stay float32.
//
// What bounds it on an H100: the products. At the 256 -> 512x4 -> 1 flagship
// a row is 2,621,440 multiply-adds in K1's hidden layers (forward 917,504,
// chain 786,432, dW 917,504): at P = 70,000 that is 367 GFLOP, and the
// bf16x3 split makes it 1,101 GFLOP of tensor-core work, 1.114 ms at the
// card's 989 TFLOP/s of dense bf16 (the SIMT route's bound at 67 TFLOP/s of
// float32 FMA was 5.48 ms). K3 is the forward alone (385 GFLOP of products
// at P = 70,000, 0.390 ms); K2 as the PerturbNet step calls it, dx without
// dW, is the forward, the chain and dx = delta_0 W_0 (131,072 a row): 771
// GFLOP, 0.779 ms. The activation traffic, about 4-5 GB a K1 call, is under
// 1.5 ms at 3.35 TB/s and overlaps the GEMM passes; K3 writes no F and keeps
// two activation buffers, K2 without dW keeps no activation for a backward.
//
// Design: every hidden-layer product is one pass of gemm3_kernel, the main
// loop of csrc/gemm3.cuh (a 128 x 128 block tile of 8 warps, 64 float32
// sums a thread, at most 128 registers, two cp.async stages of 40 KB, so
// that two blocks share an SM and one's epilogue and first loads overlap
// the other's products; ldmatrix fragments, three mma a tile and k16 step)
// with these epilogues:
//   FWD   z = a W^T + b: a (P, din) and W (dout, din) planes, both read
//         depth-contiguous; epilogue sine, hi/lo planes (or float32 for the
//         last hidden layer) and, unless F is null (K3), the factor
//         F = omega cos(omega z);
//   CHAIN delta_{l-1} = (delta_l W_l) * F_{l-1}: W read row-contiguous
//         (ldmatrix.trans); epilogue the product with F, hi/lo planes;
//   DX    dx = delta_0 W_0 (K2): operands as CHAIN; epilogue the float32
//         product, no factor;
//   DW    dW_l = delta_l^T a_l over this block's split of the P rows, both
//         read row-contiguous (ldmatrix.trans); epilogue the split's
//         float32 partial, summed by reduce_splits_kernel in a fixed order.
// The last layer (D -> 1), the loss, dW and db of the last layer and the
// split reductions are common.cuh's kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren_tc.so siren_tc.cu   (see ops/_build.py)

#include <vector>

#include "gemm3.cuh"

namespace {

enum Mode { MODE_FWD = 0, MODE_CHAIN = 1, MODE_DW = 2, MODE_DX = 3 };

// what a pass writes, and what its epilogue reads besides the products
struct PassOut {
  const float* bias;  // FWD
  float omega;        // FWD
  uint16_t* out_hi;   // FWD (or null), CHAIN: (M, N) planes
  uint16_t* out_lo;
  float* out_f32;     // FWD (or null), DX: (M, N) float32; DW: split 0's partial
  float* F;           // FWD: written (or null); CHAIN: read; (M, N)
  long long split_stride;  // DW: floats between the splits' partials
};

// C (M x N) = sum over k of Aop[m, k] Bop[k, n] in bf16x3 (see the modes
// above): FWD's A and B and CHAIN's and DX's A depth-contiguous, CHAIN's and
// DX's B and DW's A and B row-contiguous (gemm3.cuh).
template <int MODE>
__global__ void __launch_bounds__(TC_NT, 2) gemm3_kernel(Planes A, int lda, Planes B, int ldb,
                                                         int M, int N, int K, int k_split,
                                                         PassOut epi) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) uint16_t smem3[];
#else
  alignas(16) __shared__ uint16_t smem3[TC_SMEM / 2];
  emu_poison_shared(smem3, sizeof smem3);
#endif
  float acc[4][4][4];
  gemm3_products<MODE != MODE_DW, MODE == MODE_FWD>(A, lda, B, ldb, M, N, K, k_split, smem3,
                                                    acc);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * TC_TILE;
  const int n0 = blockIdx.x * TC_TILE;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  // acc[i][j][2 h + e] is row wm + 16 i + lane / 4 + 8 h, column wn + 8 j +
  // 2 (lane % 4) + e of the tile
  float* part = MODE == MODE_DW ? epi.out_f32 + blockIdx.z * epi.split_stride : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + (lane >> 2) + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + 2 * (lane & 3);
        const long long off = (long long)row * N + col;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (MODE == MODE_FWD) {
          float s0, c0, s1, c1;
          sincosf(epi.omega * (v0 + epi.bias[col]), &s0, &c0);
          sincosf(epi.omega * (v1 + epi.bias[col + 1]), &s1, &c1);
          if (epi.out_hi != nullptr) store_planes(epi.out_hi, epi.out_lo, off, s0, s1);
          if (epi.out_f32 != nullptr) {
            epi.out_f32[off] = s0;
            epi.out_f32[off + 1] = s1;
          }
          if (epi.F != nullptr) {
            epi.F[off] = epi.omega * c0;
            epi.F[off + 1] = epi.omega * c1;
          }
        } else if (MODE == MODE_CHAIN) {
          store_planes(epi.out_hi, epi.out_lo, off, v0 * epi.F[off], v1 * epi.F[off + 1]);
        } else if (MODE == MODE_DX) {
          epi.out_f32[off] = v0;
          epi.out_f32[off + 1] = v1;
        } else {
          part[off] = v0;
          part[off + 1] = v1;
        }
      }
    }
}

// hi/lo planes of n floats
__global__ void split_kernel(const float* __restrict__ x, long long n, uint16_t* __restrict__ hi,
                             uint16_t* __restrict__ lo) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    unsigned h, l;
    split_bf16(x[e], h, l);
    hi[e] = (uint16_t)h;
    lo[e] = (uint16_t)l;
  }
}

// planes of out[p, i] = (d[p] * w[i]) * F[p, i]: the chain step through the
// D -> 1 layer; a block a row at a time, two columns a thread
__global__ void outer_mul_split_kernel(const float* __restrict__ d, const float* __restrict__ w,
                                       const float* __restrict__ F, int P, int D,
                                       uint16_t* __restrict__ hi, uint16_t* __restrict__ lo) {
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const float dp = d[p];
    const long long row = (long long)p * D;
    for (int i = 2 * threadIdx.x; i < D; i += 2 * blockDim.x)
      store_planes(hi, lo, row + i, (dp * w[i]) * F[row + i], (dp * w[i + 1]) * F[row + i + 1]);
  }
}

template <int MODE>
int gemm3(Planes A, int lda, Planes B, int ldb, int M, int N, int K, int splits, int k_split,
          const PassOut& epi, cudaStream_t stream) {
  const dim3 grid(N / TC_TILE, cdiv(M, TC_TILE), splits);
#ifdef __CUDACC__
  const cudaError_t e = cudaFuncSetAttribute(
      gemm3_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
#endif
  LAUNCH_SMEM(gemm3_kernel<MODE>, grid, TC_NT, TC_SMEM, stream)(A, lda, B, ldb, M, N, K,
                                                                k_split, epi);
  CHECK_LAUNCH();
  return 0;
}

bool supported(const int* dims, int n_layers) {
  if (n_layers < 2 || dims[n_layers] != 1) return false;
  for (int l = 0; l < n_layers; ++l)
    if (dims[l] < TC_TILE || dims[l] % TC_TILE) return false;
  return true;
}

// What a call keeps in its workspace.
enum Plan {
  PLAN_LOSS_GRADS,  // K1 and K2 with dW: every activation, F, both deltas, delta_last
                    // (K1's alone), partials
  PLAN_FORWARD,     // K3: two activation slots, the last hidden one float32 in its slot
  PLAN_BWD_DX,      // K2, dx only: F and both deltas; activations ping-pong in the deltas
};

// The workspace of one call, carved in order; every piece 256-byte aligned.
struct Work {
  Planes x;                        // (P, d_0)
  std::vector<Planes> w;           // W_l (d_{l+1}, d_l), l < L - 1
  std::vector<Planes> act;         // a_{l+1} (P, d_{l+1}), l < L - 2
  float* a_last = nullptr;         // a_{L-1} (P, d_{L-1}), float32 (null: K2, dx only)
  std::vector<float*> F;           // omega cos(omega z_l) (P, d_{l+1}), l < L - 1 (K3: none)
  Planes delta[2] = {};            // (P, widest hidden)
  float* delta_last = nullptr;     // (P): K1 (K2 with dW leaves it unused)
  float* partial = nullptr;        // K1, K2 with dW
  long long bytes = 0;
};

Work carve(char* base, int P, const int* dims, int L, Plan plan) {
  Work w;
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  auto planes = [&](long long n) {
    uint16_t* p = reinterpret_cast<uint16_t*>(take(4 * n));
    return Planes{p, p ? p + n : nullptr};
  };
  const bool keep = plan == PLAN_LOSS_GRADS;  // every activation
  int width = 0;
  long long part = 2 * ROWDOT_MAX_BLOCKS;
  for (int l = 1; l < L; ++l) width = dims[l] > width ? dims[l] : width;
  w.x = planes((long long)P * dims[0]);
  for (int l = 0; l + 1 < L; ++l) {
    w.w.push_back(planes((long long)dims[l + 1] * dims[l]));
    if (keep && l + 2 < L) w.act.push_back(planes((long long)P * dims[l + 1]));
    if (plan != PLAN_FORWARD)
      w.F.push_back(reinterpret_cast<float*>(take(4LL * P * dims[l + 1])));
    const SplitPlan sp = dw_plan(dims[l + 1], dims[l], P);
    const long long need = (long long)sp.splits * dims[l + 1] * dims[l];
    part = need > part ? need : part;
    const long long cs = reduced_partial_floats(P, dims[l + 1], dims[l]);
    part = cs > part ? cs : part;
  }
  if (keep) w.a_last = reinterpret_cast<float*>(take(4LL * P * dims[L - 1]));
  if (plan == PLAN_FORWARD) {
    // hidden layer l writes slot l % 2; the last one float32 (4 bytes an
    // element, as the planes) over its slot's two planes
    Planes slot[2] = {planes((long long)P * width), {}};
    if (L > 2) slot[1] = planes((long long)P * width);
    for (int l = 0; l + 2 < L; ++l) w.act.push_back(slot[l % 2]);
    w.a_last = reinterpret_cast<float*>(const_cast<uint16_t*>(slot[(L - 2) % 2].hi));
  } else {
    w.delta[0] = planes((long long)P * width);
    w.delta[1] = planes((long long)P * width);
    // dx only: the forward's activations are read by the next layer alone,
    // and the deltas are not written before the forward ends
    if (plan == PLAN_BWD_DX)
      for (int l = 0; l + 2 < L; ++l) w.act.push_back(w.delta[l % 2]);
  }
  if (plan == PLAN_LOSS_GRADS) w.delta_last = reinterpret_cast<float*>(take(4LL * P));
  if (keep) w.partial = reinterpret_cast<float*>(take(4 * part));
  w.bytes = at;
  return w;
}

int split(const float* x, long long n, Planes out, cudaStream_t stream) {
  LAUNCH(split_kernel, ew_blocks(n), EW_THREADS, stream)(x, n, const_cast<uint16_t*>(out.hi),
                                                         const_cast<uint16_t*>(out.lo));
  CHECK_LAUNCH();
  return 0;
}

// out[j] = sum_p (hi + lo)[p, j] over the P rows of X (P, N)
int colsum_planes_reduced(Planes X, int P, int N, float* out, float* partial,
                          cudaStream_t stream) {
  const ColsumPlan cp = colsum_plan(P, N);
  const dim3 grid(cdiv(N, COLSUM_THREADS), cp.splits, 1);
  LAUNCH(colsum_planes_kernel, grid, COLSUM_THREADS, stream)(X, P, N, cp.rows_per_split,
                                                             partial);
  CHECK_LAUNCH();
  LAUNCH(reduce_splits_kernel, cdiv(N, 256), 256, stream)(partial, cp.splits, N, 1.f, out);
  CHECK_LAUNCH();
  return 0;
}

// hi/lo planes of x and of every hidden layer's W, once a call
int split_operands(const Work& w, const float* x, int P, const int* dims, int L,
                   const float* const* W, cudaStream_t stream) {
  int rc = split(x, (long long)P * dims[0], w.x, stream);
  for (int l = 0; !rc && l + 1 < L; ++l)
    rc = split(W[l], (long long)dims[l + 1] * dims[l], w.w[l], stream);
  return rc;
}

// The FWD passes through the hidden layers: layer l reads x or act[l - 1]
// and writes act[l] as planes or, the last hidden layer, a_last in float32
// (nothing when a_last is null), and F[l] when the plan keeps F.
int forward_passes(const Work& w, int P, const int* dims, int L, const float* const* b,
                   const float* omegas, cudaStream_t stream) {
  for (int l = 0; l + 1 < L; ++l) {
    PassOut e{};
    e.bias = b[l];
    e.omega = omegas[l];
    if (l + 2 < L) {
      e.out_hi = const_cast<uint16_t*>(w.act[l].hi);
      e.out_lo = const_cast<uint16_t*>(w.act[l].lo);
    } else {
      e.out_f32 = w.a_last;
    }
    e.F = w.F.empty() ? nullptr : w.F[l];
    const int rc = gemm3<MODE_FWD>(l == 0 ? w.x : w.act[l - 1], dims[l], w.w[l], dims[l], P,
                                   dims[l + 1], dims[l], 1, dims[l], e, stream);
    if (rc) return rc;
  }
  return 0;
}

// The passes below the D -> 1 layer, from delta_{L-2} in w.delta[0]: for
// each hidden layer l from L - 2 down, with dW (dW != null) its DW pass,
// split sum and db's column sums; then the CHAIN pass to delta_{l-1} or, at
// l = 0 and with dx, the DX pass.
int backward_passes(const Work& w, int P, const int* dims, int L, float* const* dW,
                    float* const* db, float* dx, cudaStream_t stream) {
  int cur = 0, rc = 0;
  for (int l = L - 2; l >= 0; --l) {
    const int din = dims[l], dout = dims[l + 1];
    if (dW != nullptr) {
      const SplitPlan sp = dw_plan(dout, din, P);
      PassOut e{};
      e.out_f32 = w.partial;
      e.split_stride = (long long)dout * din;
      rc = gemm3<MODE_DW>(w.delta[cur], dout, l == 0 ? w.x : w.act[l - 1], din, dout, din, P,
                          sp.splits, sp.k_split, e, stream);
      if (rc) return rc;
      LAUNCH(reduce_splits_kernel, cdiv((long long)dout * din, 256), 256, stream)(
          w.partial, sp.splits, (long long)dout * din, 1.f, dW[l]);
      CHECK_LAUNCH();
      rc = colsum_planes_reduced(w.delta[cur], P, dout, db[l], w.partial, stream);
      if (rc) return rc;
    }
    if (l > 0) {
      PassOut c{};
      c.out_hi = const_cast<uint16_t*>(w.delta[1 - cur].hi);
      c.out_lo = const_cast<uint16_t*>(w.delta[1 - cur].lo);
      c.F = w.F[l - 1];
      rc = gemm3<MODE_CHAIN>(w.delta[cur], dout, w.w[l], din, P, din, dout, 1, dout, c,
                             stream);
      if (rc) return rc;
      cur = 1 - cur;
    } else if (dx != nullptr) {
      PassOut d{};
      d.out_f32 = dx;
      rc = gemm3<MODE_DX>(w.delta[cur], dout, w.w[0], din, P, din, dout, 1, dout, d, stream);
      if (rc) return rc;
    }
  }
  return 0;
}

long long workspace_bytes(int P, const int* dims, int n_layers, Plan plan) {
  if (!supported(dims, n_layers) || P < 1) return -1;
  return carve(nullptr, P, dims, n_layers, plan).bytes;
}

}  // namespace

extern "C" {

// Bytes of workspace siren_loss_grads_tc needs for these shapes, or -1 when
// the route does not take them (every width but the last a multiple of 128,
// at least one hidden layer, one output).
long long siren_tc_workspace_bytes(int P, const int* dims, int n_layers) {
  return workspace_bytes(P, dims, n_layers, PLAN_LOSS_GRADS);
}

// K1 on the tensor cores: loss = inv_n * sum_{p < n_rows} (MLP(x)_p -
// target_p)^2 and every dW/db, for sine hidden layers (omegas[l]) and a
// linear last layer; work: siren_tc_workspace_bytes bytes.
int siren_loss_grads_tc(const float* x, int P, int n_rows, const int* dims, int n_layers,
                        const float* const* W, const float* const* b, const float* omegas,
                        const float* target, float inv_n, void* work, float* const* dW,
                        float* const* db, float* loss, cudaStream_t stream) {
  if (!supported(dims, n_layers) || P < 1) return -1;
  const int L = n_layers;
  const Work w = carve(static_cast<char*>(work), P, dims, L, PLAN_LOSS_GRADS);
  int rc = split_operands(w, x, P, dims, L, W, stream);
  if (!rc) rc = forward_passes(w, P, dims, L, b, omegas, stream);
  if (rc) return rc;

  // last layer, loss, and its dW (float32 column sums weighted by delta) and db
  const int D = dims[L - 1];
  const int blocks = rowdot_blocks(P);
  const auto rowdot = rowdot_act_kernel<ROW_LOSS, false, false, false>;
  LAUNCH(rowdot, blocks, ROWDOT_WARPS * 32, stream)(
      w.a_last, P, D, W[L - 1], b[L - 1], w.delta_last, target, n_rows, 2.f * inv_n, w.partial,
      nullptr, nullptr);
  CHECK_LAUNCH();
  LAUNCH(sum_kernel, 1, 1024, stream)(w.partial, (long long)blocks, inv_n, loss);
  CHECK_LAUNCH();
  rc = colsum_reduced(w.a_last, P, D, w.delta_last, dW[L - 1], w.partial, stream);
  if (rc) return rc;
  LAUNCH(sum_kernel, 1, 1024, stream)(w.delta_last, (long long)P, 1.f, db[L - 1]);
  CHECK_LAUNCH();
  LAUNCH(outer_mul_split_kernel, EW_MAX_BLOCKS, EW_THREADS, stream)(
      w.delta_last, W[L - 1], w.F[L - 2], P, D, const_cast<uint16_t*>(w.delta[0].hi),
      const_cast<uint16_t*>(w.delta[0].lo));
  CHECK_LAUNCH();
  return backward_passes(w, P, dims, L, dW, db, nullptr, stream);
}

// Bytes of workspace siren_forward_tc needs, or -1 (as above).
long long siren_forward_tc_workspace_bytes(int P, const int* dims, int n_layers) {
  return workspace_bytes(P, dims, n_layers, PLAN_FORWARD);
}

// K3 on the tensor cores: out (P, 1) = MLP(x) for sine hidden layers
// (omegas[l]) and a linear last layer; work: siren_forward_tc_workspace_bytes.
int siren_forward_tc(const float* x, int P, const int* dims, int n_layers,
                     const float* const* W, const float* const* b, const float* omegas,
                     void* work, float* out, cudaStream_t stream) {
  if (!supported(dims, n_layers) || P < 1) return -1;
  const int L = n_layers;
  const Work w = carve(static_cast<char*>(work), P, dims, L, PLAN_FORWARD);
  int rc = split_operands(w, x, P, dims, L, W, stream);
  if (!rc) rc = forward_passes(w, P, dims, L, b, omegas, stream);
  if (rc) return rc;
  const auto rowdot = rowdot_kernel<false>;
  LAUNCH(rowdot, rowdot_blocks(P), ROWDOT_WARPS * 32, stream)(
      w.a_last, P, dims[L - 1], W[L - 1], b[L - 1], out, nullptr, 0, 0.f, nullptr);
  CHECK_LAUNCH();
  return 0;
}

// Bytes of workspace siren_fused_bwd_tc needs with dW (need_dw != 0) or
// without, or -1 (as above).
long long siren_fused_bwd_tc_workspace_bytes(int P, const int* dims, int n_layers,
                                             int need_dw) {
  return workspace_bytes(P, dims, n_layers, need_dw ? PLAN_LOSS_GRADS : PLAN_BWD_DX);
}

// K2 on the tensor cores: for g = dL/d out (P, 1), dx (P, d_0) unless dx is
// null and every dW/db unless dW is null; work:
// siren_fused_bwd_tc_workspace_bytes(..., dW != null) bytes.
int siren_fused_bwd_tc(const float* x, int P, const int* dims, int n_layers,
                       const float* const* W, const float* const* b, const float* omegas,
                       const float* g, void* work, float* const* dW, float* const* db,
                       float* dx, cudaStream_t stream) {
  if (!supported(dims, n_layers) || P < 1) return -1;
  const int L = n_layers;
  const Work w = carve(static_cast<char*>(work), P, dims, L,
                       dW != nullptr ? PLAN_LOSS_GRADS : PLAN_BWD_DX);
  int rc = split_operands(w, x, P, dims, L, W, stream);
  if (!rc) rc = forward_passes(w, P, dims, L, b, omegas, stream);
  if (rc) return rc;
  const int D = dims[L - 1];
  if (dW != nullptr) {  // the last layer's dW (column sums weighted by g) and db
    rc = colsum_reduced(w.a_last, P, D, g, dW[L - 1], w.partial, stream);
    if (rc) return rc;
    LAUNCH(sum_kernel, 1, 1024, stream)(g, (long long)P, 1.f, db[L - 1]);
    CHECK_LAUNCH();
  }
  LAUNCH(outer_mul_split_kernel, EW_MAX_BLOCKS, EW_THREADS, stream)(
      g, W[L - 1], w.F[L - 2], P, D, const_cast<uint16_t*>(w.delta[0].hi),
      const_cast<uint16_t*>(w.delta[0].lo));
  CHECK_LAUNCH();
  return backward_passes(w, P, dims, L, dW, db, dx, stream);
}

}  // extern "C"
