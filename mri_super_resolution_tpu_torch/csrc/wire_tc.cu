// Hand-written Hopper (sm_90a) tensor-core route of the WIRE kernel K4
// (wire_loss_grads) for hidden widths H that are multiples of 64.
//
// Replaces, for the calls whose widths fit its tiling (ops/wire_kernel.py's
// wire_tc_route, from the shapes alone), the Pallas TPU kernel of
// mri_super_resolution_tpu/ops/pallas/wire_kernel.py:
//   K4 wire_loss_grads (:302, pallas_call at :340): one-pass forward, masked
//      MSE and hand-derived backward, giving the loss and the gradient of
//      every weight (omega/sigma are read, never differentiated).
// It also runs K5 for the same widths:
//   K5 wire_forward (:146, pallas_call at :164): the network's output,
// with the forward passes below alone (wire_forward_tc): no pre-activation
// stash S, the activations in two alternating hi/lo slots, a forward-only
// last layer. csrc/wire.cu's SIMT kernels keep every other K4 and K5 call.
//
// The network and its contract are csrc/wire.cu's: paired-real complex
// Gabor layers, weights in the JAX kernel's flat order in torch (out, in)
// layout, omega/sigma per layer from the device array oms (n_layers, 2), and
// the single exponential m = exp(-omega si - sigma^2 (|s|^2 + |s2|^2)).
//
// What bounds it on an H100: the products. Each hidden layer is three
// products of its (4H x 2H) block matrix over the P rows: the forward
// [hr | hi] Wblk^T (P x 4H), the weight gradient dS^T [hr | hi] and the
// upstream gradient dS Wblk (P x 2H). At the reference's 4 -> 256x2 -> 1 on
// P = 70,000 that is 440.4 GFLOP a call (the first layer, K = 4, and the last,
// N = 1, are under 1% of it): 6.585 ms at the card's 67 TFLOP/s of float32
// FMA, the SIMT route's bound. Here the products run on the tensor cores in
// the bf16x3 split of the SIREN kernels (x = hi + lo, both bf16 rounded to
// nearest even; hi hi + hi lo + lo hi on mma.sync m16n8k16, float32 sums):
// 3 x 440.4 GFLOP of bf16 products, 1.336 ms at the 989 TFLOP/s bf16 peak.
// K5 at the inference chunk (262,144 rows) is 551 GFLOP of forward
// products: 8.225 ms at the float32 FMA peak, 1.67 ms as bf16x3.
//
// Design: each product is one pass of wire_gemm_kernel, the main loop of
// csrc/gemm3.cuh (128 x 128 block tiles of
// 8 warps, two cp.async stages of hi/lo planes, ldmatrix fragments, three
// mma a tile and k16 step; two blocks an SM), with WIRE's epilogues:
//   FWD  S = A Wblk^T + bias with the Gabor activation fused (S is not
//        written when null: K5): the block
//        matrix's output columns are ordered so that one thread's
//        accumulators hold all four pre-activations of a hidden unit u.
//        Column c = 16 (u / 4) + 8 t + 2 (u % 4) + e holds component
//        2 t + e of unit u (0 sr, 1 si, 2 s2r, 3 s2i): an m16n8 accumulator
//        gives a thread two adjacent columns, so (sr, si) sit in one n8 tile
//        and (s2r, s2i) in the next. The epilogue writes S (float32, this
//        column order) for the backward and the unit's (hr, hi) to columns
//        2u, 2u + 1 of the next layer's input as hi/lo planes (the last
//        hidden layer's in float32, for the float32 last layer); the next
//        block matrix's depth follows that interleaved order;
//   DX   dh = dS Wblk (P x 2H), with the Gabor backward of the layer below
//        fused: a thread holds (dhr, dhi) of a unit, reads that layer's S
//        and writes its dS as hi/lo planes in the column order above (the
//        first layer's as float32, for the SIMT first-layer gradient);
//   DW   dWblk = dS^T [hr | hi] over this block's split of the rows, float32
//        partials summed in a fixed order by the unpack kernel that folds
//        the block gradient back into dKr, dKi, dK2r, dK2i (no atomics: a
//        call repeats bit for bit).
// The first layer (K = d_in = 4) is one elementwise kernel (its 2 x 4
// products, S0 and the Gabor activation into the first planes); its weight
// gradient is common.cuh's SIMT split-K GEMM. The last layer (N = 1) is one
// warp a row: the residual, the loss partials and the top hidden layer's
// Gabor backward from delta Kr and -delta Ki. db of every layer is a column
// sum of dS in a fixed order. The block matrices are split into planes on
// the device each call. Transcendentals: expf and sincosf, never fast math.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwire_tc.so wire_tc.cu   (see ops/_build.py)

#include <vector>

#include "gemm3.cuh"

namespace {

constexpr int WIRE_H_STEP = 64;                 // H a multiple of it: 2H and 4H of 128

enum Mode { MODE_FWD = 0, MODE_DW = 2, MODE_DX = 3 };

// what a pass writes, and what its epilogue reads besides the products
struct WireEpi {
  int H;
  const float* bias;   // FWD: the packed bias (4H)
  const float* om_sg;  // FWD: this layer's (omega, sigma); DX: the layer below's
  float* S;            // FWD: written (M x 4H); DX: the layer below's, read
                       // (M x 4H, or M x 2H [sr | s2r] for the first layer)
  uint16_t* out_hi;    // FWD: the next input (M x 2H) or null; DX: dS below
  uint16_t* out_lo;    //   (M x 4H), null for the first layer
  float* out_f32;      // FWD: the last hidden output (M x 2H) or null; DX: the
                       // first layer's dS (M x 2H [dsr | ds2r]); DW: split 0's partial
  long long split_stride;  // DW: floats between the splits' partials
};

// column of component comp (0 sr, 1 si, 2 s2r, 3 s2i) of hidden unit u in
// the block matrix's output order
__device__ __forceinline__ int packed_col(int comp, int u) {
  return 16 * (u >> 2) + 8 * (comp >> 1) + 2 * (u & 3) + (comp & 1);
}

// (hr, hi) of a hidden Gabor unit
__device__ __forceinline__ void gabor(float om, float sg2, float sr, float si, float s2r,
                                      float s2i, float& hr, float& hi) {
  const float m = expf(-om * si - sg2 * (sr * sr + si * si + s2r * s2r + s2i * s2i));
  float sn, cs;
  sincosf(om * sr, &sn, &cs);
  hr = m * cs;
  hi = m * sn;
}

// dS of a hidden Gabor unit from (dhr, dhi); the first layer's (si = s2i =
// 0, no -omega si term) when FIRST, writing only dsr and ds2r
template <bool FIRST>
__device__ __forceinline__ void gabor_bwd(float om, float sg2, float sr, float si, float s2r,
                                          float s2i, float dhr, float dhi, float ds[4]) {
  const float u = FIRST ? -sg2 * (sr * sr + s2r * s2r)
                        : -om * si - sg2 * (sr * sr + si * si + s2r * s2r + s2i * s2i);
  const float m = expf(u);
  float sn, cs;
  sincosf(om * sr, &sn, &cs);
  const float du = (dhr * cs + dhi * sn) * m;
  ds[0] = du * (-2.f * sg2 * sr) + om * m * (dhi * cs - dhr * sn);
  ds[1] = FIRST ? 0.f : du * (-om - 2.f * sg2 * si);
  ds[2] = du * (-2.f * sg2 * s2r);
  ds[3] = FIRST ? 0.f : du * (-2.f * sg2 * s2i);
}

// C (M x N) = sum over k of Aop[m, k] Bop[k, n] in bf16x3 (gemm3.cuh) with
// WIRE's epilogues (see the modes above): FWD's A and B and DX's A
// depth-contiguous, DX's B and DW's A and B row-contiguous.
template <int MODE>
__global__ void __launch_bounds__(TC_NT, 2) wire_gemm_kernel(Planes A, int lda, Planes B,
                                                             int ldb, int M, int N, int K,
                                                             int k_split, WireEpi epi) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) uint16_t smem3[];
#else
  alignas(16) __shared__ uint16_t smem3[TC_SMEM / 2];
  emu_poison_shared(smem3, sizeof smem3);
#endif
  float acc[4][4][4];
  gemm3_products<MODE != MODE_DW, MODE == MODE_FWD>(A, lda, B, ldb, M, N, K, k_split,
                                                    blockIdx.z, smem3, acc);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * TC_TILE;
  const int n0 = blockIdx.x * TC_TILE;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  // acc[i][j][2 h + e] is row wm + 16 i + lane / 4 + 8 h, column wn + 8 j +
  // 2 (lane % 4) + e of the tile
  const int H = epi.H;
  float om = 0.f, sg2 = 0.f;
  if (MODE != MODE_DW) {
    om = epi.om_sg[0];
    sg2 = epi.om_sg[1] * epi.om_sg[1];
  }
  float* part = MODE == MODE_DW ? epi.out_f32 + blockIdx.z * epi.split_stride : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + (lane >> 2) + 8 * h;
      if (row >= M) continue;
      if (MODE == MODE_FWD) {
        // n8 tiles 2 jj and 2 jj + 1: (sr, si) and (s2r, s2i) of one unit
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = n0 + wn + 16 * jj + 2 * (lane & 3);
          const int u = c / 16 * 4 + (lane & 3);
          const float sr = acc[i][2 * jj][2 * h] + epi.bias[c];
          const float si = acc[i][2 * jj][2 * h + 1] + epi.bias[c + 1];
          const float s2r = acc[i][2 * jj + 1][2 * h] + epi.bias[c + 8];
          const float s2i = acc[i][2 * jj + 1][2 * h + 1] + epi.bias[c + 9];
          if (epi.S != nullptr) {
            float* s = epi.S + (long long)row * 4 * H + c;
            s[0] = sr;
            s[1] = si;
            s[8] = s2r;
            s[9] = s2i;
          }
          float hr, hi;
          gabor(om, sg2, sr, si, s2r, s2i, hr, hi);
          const long long off = (long long)row * 2 * H + 2 * u;
          if (epi.out_hi != nullptr) {
            store_planes(epi.out_hi, epi.out_lo, off, hr, hi);
          } else {
            epi.out_f32[off] = hr;
            epi.out_f32[off + 1] = hi;
          }
        }
      } else if (MODE == MODE_DX) {
        // n8 tile j: (dhr, dhi) of unit v of the layer below
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = (n0 + wn + 8 * j) / 2 + (lane & 3);
          const float dhr = acc[i][j][2 * h], dhi = acc[i][j][2 * h + 1];
          float ds[4];
          if (epi.out_hi == nullptr) {  // the first layer: S [sr | s2r], dS [dsr | ds2r]
            const float* s = epi.S + (long long)row * 2 * H + v;
            gabor_bwd<true>(om, sg2, s[0], 0.f, s[H], 0.f, dhr, dhi, ds);
            float* d = epi.out_f32 + (long long)row * 2 * H + v;
            d[0] = ds[0];
            d[H] = ds[2];
          } else {
            const long long off = (long long)row * 4 * H + packed_col(0, v);
            const float* s = epi.S + off;
            gabor_bwd<false>(om, sg2, s[0], s[1], s[8], s[9], dhr, dhi, ds);
            store_planes(epi.out_hi, epi.out_lo, off, ds[0], ds[1]);
            store_planes(epi.out_hi, epi.out_lo, off + 8, ds[2], ds[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long off = (long long)row * N + n0 + wn + j * 8 + 2 * (lane & 3);
          part[off] = acc[i][j][2 * h];
          part[off + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

// The first layer: S0 = [x W^T + b | x Wo^T + bo] (P x 2H; not written when
// null) and the Gabor activation of each unit into columns 2u, 2u + 1 of
// the first planes.
__global__ void first_forward_kernel(const float* __restrict__ x, int P, int d, int H,
                                     const float* __restrict__ W, const float* __restrict__ b,
                                     const float* __restrict__ Wo,
                                     const float* __restrict__ bo,
                                     const float* __restrict__ om_sg, float* __restrict__ S0,
                                     uint16_t* __restrict__ a_hi, uint16_t* __restrict__ a_lo) {
  const float om = om_sg[0], sg2 = om_sg[1] * om_sg[1];
  const long long total = (long long)P * H;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long p = e / H;
    const int u = (int)(e - p * H);
    float sr = 0.f, s2r = 0.f;
    for (int k = 0; k < d; ++k) {
      sr = fmaf(x[p * d + k], W[u * d + k], sr);
      s2r = fmaf(x[p * d + k], Wo[u * d + k], s2r);
    }
    sr += b[u];
    s2r += bo[u];
    if (S0 != nullptr) {
      S0[p * 2 * H + u] = sr;
      S0[p * 2 * H + H + u] = s2r;
    }
    const float m = expf(-sg2 * (sr * sr + s2r * s2r));
    float sn, cs;
    sincosf(om * sr, &sn, &cs);
    store_planes(a_hi, a_lo, p * 2 * H + 2 * u, m * cs, m * sn);
  }
}

// A hidden layer's weights: Kr Ki br bi K2r K2i b2r b2i
struct HiddenWeights {
  const float* w[8];
};

// The block matrix (4H x 2H: rows in packed_col order, columns 2v + e for
// input (hr_v, hi_v)) as hi/lo planes, and its bias (4H) in float32:
//   sr:  [Kr, -Ki]    si:  [Ki, Kr]    s2r: [K2r, -K2i]    s2i: [K2i, K2r]
__global__ void pack_block_kernel(HiddenWeights k, int H, uint16_t* __restrict__ hi,
                                  uint16_t* __restrict__ lo, float* __restrict__ bias) {
  const long long total = 8LL * H * H;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e / (2 * H)), col = (int)(e - (long long)c * 2 * H);
    const int comp = 2 * ((c & 15) >> 3) + (c & 1);
    const int u = 4 * (c >> 4) + ((c & 7) >> 1);
    const int v = col >> 1, imag_in = col & 1;
    const float* re = k.w[comp < 2 ? 0 : 4];  // Kr or K2r
    const float* im = k.w[comp < 2 ? 1 : 5];  // Ki or K2i
    const long long uv = (long long)u * H + v;
    float val;
    if (comp & 1) {  // si, s2i
      val = imag_in ? re[uv] : im[uv];
    } else {  // sr, s2r
      val = imag_in ? -im[uv] : re[uv];
    }
    unsigned h, l;
    split_bf16(val, h, l);
    hi[e] = (uint16_t)h;
    lo[e] = (uint16_t)l;
  }
  const int b_of[4] = {2, 3, 6, 7};
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < 4 * H; c += gridDim.x * blockDim.x) {
    const int comp = 2 * ((c & 15) >> 3) + (c & 1);
    bias[c] = k.w[b_of[comp]][4 * (c >> 4) + ((c & 7) >> 1)];
  }
}

// The last layer, one warp a row: out = hr Kr^T - hi Ki^T + br over the last
// hidden output A (P x 2H float32, interleaved), delta = two_inv_n r on the
// rows below n_rows (0 beyond), a per-block partial sum of r^2, then the top
// hidden layer's Gabor backward from (delta Kr, -delta Ki) into its dS planes.
__global__ void __launch_bounds__(ROWDOT_WARPS * 32) last_layer_kernel(
    const float* __restrict__ A, int P, int H, const float* __restrict__ Kr,
    const float* __restrict__ Ki, const float* __restrict__ br,
    const float* __restrict__ target, int n_rows, float two_inv_n, float* __restrict__ delta,
    float* __restrict__ loss_partial, const float* __restrict__ S,
    const float* __restrict__ om_sg, uint16_t* __restrict__ ds_hi,
    uint16_t* __restrict__ ds_lo) {
  __shared__ float red[ROWDOT_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float om = om_sg[0], sg2 = om_sg[1] * om_sg[1];
  float sq = 0.f;
  for (long long row = (long long)blockIdx.x * ROWDOT_WARPS + warp; row < P;
       row += (long long)gridDim.x * ROWDOT_WARPS) {
    const float* h = A + row * 2 * H;
    float s = 0.f;
    for (int k = lane; k < 2 * H; k += 32) s = fmaf(h[k], (k & 1) ? -Ki[k >> 1] : Kr[k >> 1], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float r = row < n_rows ? s + br[0] - target[row] : 0.f;
    const float d = two_inv_n * r;
    if (lane == 0) {
      delta[row] = d;
      sq = fmaf(r, r, sq);
    }
    for (int u = lane; u < H; u += 32) {
      const long long off = row * 4 * H + packed_col(0, u);
      const float* sp = S + off;
      float ds[4];
      gabor_bwd<false>(om, sg2, sp[0], sp[1], sp[8], sp[9], d * Kr[u], -d * Ki[u], ds);
      store_planes(ds_hi, ds_lo, off, ds[0], ds[1]);
      store_planes(ds_hi, ds_lo, off + 8, ds[2], ds[3]);
    }
  }
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < ROWDOT_WARPS; ++i) t += red[i];
    loss_partial[blockIdx.x] = t;
  }
}

// K5's last layer, one warp a row: out = hr Kr^T - hi Ki^T + br over the
// last hidden output A (P x 2H float32, interleaved).
__global__ void __launch_bounds__(ROWDOT_WARPS * 32) last_forward_kernel(
    const float* __restrict__ A, int P, int H, const float* __restrict__ Kr,
    const float* __restrict__ Ki, const float* __restrict__ br, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long row = (long long)blockIdx.x * ROWDOT_WARPS + warp; row < P;
       row += (long long)gridDim.x * ROWDOT_WARPS) {
    const float* h = A + row * 2 * H;
    float s = 0.f;
    for (int k = lane; k < 2 * H; k += 32) s = fmaf(h[k], (k & 1) ? -Ki[k >> 1] : Kr[k >> 1], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[row] = s + br[0];
  }
}

// A hidden layer's gradients: out.w[0, 1, 4, 5] (dKr, dKi, dK2r, dK2i, H x H)
// from the block gradient's split partials (4H x 2H each, split_stride
// apart), each block entry summed over the splits in order, then
//   dKr = G(sr, hr) + G(si, hi)      dKi = G(si, hr) - G(sr, hi)
// (and K2 from s2r, s2i); out.w[2, 3, 6, 7] (dbr, dbi, db2r, db2i) from the
// column sums' split partials (4H each).
struct HiddenGrads {
  float* w[8];
};

__global__ void unpack_hidden_kernel(const float* __restrict__ partial, int splits,
                                     long long split_stride, const float* __restrict__ cpart,
                                     int csplits, int H, HiddenGrads out) {
  const long long total = (long long)H * H;
  auto block_sum = [&](int comp, int u, int imag_in, int v) {
    const long long off = (long long)packed_col(comp, u) * 2 * H + 2 * v + imag_in;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * split_stride + off];
    return s;
  };
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int u = (int)(e / H), v = (int)(e - (long long)u * H);
    for (int pair = 0; pair < 2; ++pair) {
      const int cr = 2 * pair, ci = 2 * pair + 1;
      out.w[4 * pair][e] = block_sum(cr, u, 0, v) + block_sum(ci, u, 1, v);
      out.w[4 * pair + 1][e] = block_sum(ci, u, 0, v) - block_sum(cr, u, 1, v);
    }
  }
  const int b_of[4] = {2, 3, 6, 7};
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < 4 * H; c += gridDim.x * blockDim.x) {
    const int comp = 2 * ((c & 15) >> 3) + (c & 1);
    float s = 0.f;
    for (int z = 0; z < csplits; ++z) s += cpart[(long long)z * 4 * H + c];
    out.w[b_of[comp]][4 * (c >> 4) + ((c & 7) >> 1)] = s;
  }
}

// The first and last layers' gradients from their reductions: gfirst (2H x
// d, rows [W | Wo]) and gbias (2H, [b | bo]) into dW, db, dWo, dbo; gfin
// (2H interleaved) into dKr = gfin[2u], dKi = -gfin[2u + 1].
__global__ void unpack_ends_kernel(const float* __restrict__ gfirst,
                                   const float* __restrict__ gbias,
                                   const float* __restrict__ gfin, int d, int H,
                                   float* __restrict__ dW, float* __restrict__ db,
                                   float* __restrict__ dWo, float* __restrict__ dbo,
                                   float* __restrict__ dKr, float* __restrict__ dKi) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < H * d; i += gridDim.x * blockDim.x) {
    dW[i] = gfirst[i];
    dWo[i] = gfirst[H * d + i];
  }
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < H; u += gridDim.x * blockDim.x) {
    db[u] = gbias[u];
    dbo[u] = gbias[H + u];
    dKr[u] = gfin[2 * u];
    dKi[u] = -gfin[2 * u + 1];
  }
}

template <int MODE>
int wire_gemm(Planes A, int lda, Planes B, int ldb, int M, int N, int K, int splits,
              int k_split, const WireEpi& epi, cudaStream_t stream) {
  const dim3 grid(N / TC_TILE, cdiv(M, TC_TILE), splits);
#ifdef __CUDACC__
  const cudaError_t e = cudaFuncSetAttribute(
      wire_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
#endif
  LAUNCH_SMEM(wire_gemm_kernel<MODE>, grid, TC_NT, TC_SMEM, stream)(A, lda, B, ldb, M, N, K,
                                                                    k_split, epi);
  CHECK_LAUNCH();
  return 0;
}

bool supported(int P, int d, int H, int nh) {
  return P > 0 && d > 0 && nh > 0 && H > 0 && H % WIRE_H_STEP == 0;
}

// The workspace of one call, carved in order; every piece 256-byte aligned.
struct Work {
  std::vector<Planes> wblk;     // hidden layer l's block matrix (4H x 2H), l < nh
  std::vector<float*> bias;     // its packed bias (4H)
  float* S0 = nullptr;          // (P x 2H) [sr | s2r]
  std::vector<float*> S;        // hidden layer l's pre-activations (P x 4H), l < nh
  std::vector<Planes> act;      // the first nh layers' outputs (P x 2H planes)
  float* a_last = nullptr;      // the last hidden output (P x 2H float32)
  Planes ds[2] = {};            // (P x 4H); the first layer's dS (P x 2H float32) in one
  float* delta = nullptr;       // (P)
  float* gfirst = nullptr;      // (2H x d)
  float* gbias = nullptr;       // (2H)
  float* gfin = nullptr;        // (2H)
  float* partial = nullptr;
  long long bytes = 0;
};

Work carve(char* base, int P, int d, int H, int nh) {
  Work w;
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  auto floats = [&](long long n) { return reinterpret_cast<float*>(take(4 * n)); };
  auto planes = [&](long long n) {
    uint16_t* p = reinterpret_cast<uint16_t*>(take(4 * n));
    return Planes{p, p ? p + n : nullptr};
  };
  const long long rows = P;
  for (int l = 0; l < nh; ++l) {
    w.wblk.push_back(planes(8LL * H * H));
    w.bias.push_back(floats(4LL * H));
  }
  w.S0 = floats(rows * 2 * H);
  for (int l = 0; l < nh; ++l) w.S.push_back(floats(rows * 4 * H));
  for (int l = 0; l < nh; ++l) w.act.push_back(planes(rows * 2 * H));
  w.a_last = floats(rows * 2 * H);
  w.ds[0] = planes(rows * 4 * H);
  w.ds[1] = planes(rows * 4 * H);
  w.delta = floats(rows);
  w.gfirst = floats(2LL * H * d);
  w.gbias = floats(2LL * H);
  w.gfin = floats(2LL * H);
  // a hidden layer's block-gradient partials with its column sums' after
  // them; the loss partials; the first and last layers' SIMT reductions
  long long part = (long long)dw_plan(4 * H, 2 * H, P).splits * 8 * H * H +
                   (long long)colsum_plan(P, 4 * H).splits * 4 * H;
  const long long need[] = {ROWDOT_MAX_BLOCKS, reduced_partial_floats(P, 2 * H, d)};
  for (long long n : need) part = n > part ? n : part;
  w.partial = floats(part);
  w.bytes = at;
  return w;
}

// K5's workspace: the block matrices and biases, then two activation
// slots (P x 2H hi/lo planes; the last hidden layer's float32 output takes
// the slot it does not read), every piece 256-byte aligned.
struct FwdWork {
  std::vector<Planes> wblk;
  std::vector<float*> bias;
  Planes slot[2] = {};
  long long bytes = 0;
};

FwdWork carve_forward(char* base, int P, int H, int nh) {
  FwdWork w;
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
  for (int l = 0; l < nh; ++l) {
    w.wblk.push_back(planes(8LL * H * H));
    w.bias.push_back(reinterpret_cast<float*>(take(4 * 4LL * H)));
  }
  w.slot[0] = planes((long long)P * 2 * H);
  w.slot[1] = planes((long long)P * 2 * H);
  w.bytes = at;
  return w;
}

}  // namespace

extern "C" {

// Bytes of workspace wire_loss_grads_tc needs for these shapes, or -1 when
// the route does not take them (H a multiple of 64, at least one hidden
// layer).
long long wire_tc_workspace_bytes(int P, int d_in, int H, int n_hidden) {
  if (!supported(P, d_in, H, n_hidden)) return -1;
  return carve(nullptr, P, d_in, H, n_hidden).bytes;
}

// K4 on the tensor cores: loss = inv_n * sum_{p < n_rows} (WIRE(x)_p -
// target_p)^2 and the gradient of every weight into dw[] (the order and
// shapes of w[]); oms: (n_hidden + 1, 2) on the device; work:
// wire_tc_workspace_bytes bytes.
int wire_loss_grads_tc(const float* x, int P, int n_rows, int d_in, int H, int n_hidden,
                       const float* const* w, const float* oms, const float* target,
                       float inv_n, void* work, float* const* dw, float* loss,
                       cudaStream_t stream) {
  if (!supported(P, d_in, H, n_hidden)) return -1;
  const int nh = n_hidden, d = d_in;
  const Work W = carve(static_cast<char*>(work), P, d, H, nh);
  const int fin = 4 + 8 * nh;
  const long long ew = (long long)P * H;

  // the block matrices and biases, then the forward
  for (int l = 0; l < nh; ++l) {
    HiddenWeights k;
    for (int i = 0; i < 8; ++i) k.w[i] = w[4 + 8 * l + i];
    LAUNCH(pack_block_kernel, ew_blocks(8LL * H * H), EW_THREADS, stream)(
        k, H, const_cast<uint16_t*>(W.wblk[l].hi), const_cast<uint16_t*>(W.wblk[l].lo),
        W.bias[l]);
    CHECK_LAUNCH();
  }
  LAUNCH(first_forward_kernel, ew_blocks(ew), EW_THREADS, stream)(
      x, P, d, H, w[0], w[1], w[2], w[3], oms, W.S0, const_cast<uint16_t*>(W.act[0].hi),
      const_cast<uint16_t*>(W.act[0].lo));
  CHECK_LAUNCH();
  for (int l = 0; l < nh; ++l) {
    WireEpi e{};
    e.H = H;
    e.bias = W.bias[l];
    e.om_sg = oms + 2 * (l + 1);
    e.S = W.S[l];
    if (l + 1 < nh) {
      e.out_hi = const_cast<uint16_t*>(W.act[l + 1].hi);
      e.out_lo = const_cast<uint16_t*>(W.act[l + 1].lo);
    } else {
      e.out_f32 = W.a_last;
    }
    const int rc = wire_gemm<MODE_FWD>(W.act[l], 2 * H, W.wblk[l], 2 * H, P, 4 * H, 2 * H, 1,
                                       2 * H, e, stream);
    if (rc) return rc;
  }

  // the last layer: residual, loss, the top layer's dS; the last layer's grads
  const int blocks = rowdot_blocks(P);
  LAUNCH(last_layer_kernel, blocks, ROWDOT_WARPS * 32, stream)(
      W.a_last, P, H, w[fin], w[fin + 1], w[fin + 2], target, n_rows, 2.f * inv_n, W.delta,
      W.partial, W.S[nh - 1], oms + 2 * nh, const_cast<uint16_t*>(W.ds[0].hi),
      const_cast<uint16_t*>(W.ds[0].lo));
  CHECK_LAUNCH();
  LAUNCH(sum_kernel, 1, 1024, stream)(W.partial, (long long)blocks, inv_n, loss);
  CHECK_LAUNCH();
  int rc = colsum_reduced(W.a_last, P, 2 * H, W.delta, W.gfin, W.partial, stream);
  if (rc) return rc;
  LAUNCH(sum_kernel, 1, 1024, stream)(W.delta, (long long)P, 1.f, dw[fin + 2]);
  CHECK_LAUNCH();

  // hidden layers, top down: the block gradient and db, then dh through the
  // block matrix with the layer below's Gabor backward
  int cur = 0;
  for (int l = nh - 1; l >= 0; --l) {
    const SplitPlan sp = dw_plan(4 * H, 2 * H, P);
    WireEpi g{};
    g.H = H;
    g.out_f32 = W.partial;
    g.split_stride = 8LL * H * H;
    // the layer's input: the previous hidden output, or the first layer's
    const Planes in = W.act[l];
    rc = wire_gemm<MODE_DW>(W.ds[cur], 4 * H, in, 2 * H, 4 * H, 2 * H, P, sp.splits,
                            sp.k_split, g, stream);
    if (rc) return rc;
    const ColsumPlan cp = colsum_plan(P, 4 * H);
    float* cpart = W.partial + (long long)sp.splits * 8 * H * H;
    LAUNCH(colsum_planes_kernel, dim3(cdiv(4 * H, COLSUM_THREADS), cp.splits, 1),
           COLSUM_THREADS, stream)(W.ds[cur], P, 4 * H, cp.rows_per_split, cpart);
    CHECK_LAUNCH();
    HiddenGrads o;
    for (int i = 0; i < 8; ++i) o.w[i] = dw[4 + 8 * l + i];
    LAUNCH(unpack_hidden_kernel, ew_blocks((long long)H * H), EW_THREADS, stream)(
        W.partial, sp.splits, 8LL * H * H, cpart, cp.splits, H, o);
    CHECK_LAUNCH();
    WireEpi x_epi{};
    x_epi.H = H;
    x_epi.om_sg = oms + 2 * l;
    if (l > 0) {
      x_epi.S = W.S[l - 1];
      x_epi.out_hi = const_cast<uint16_t*>(W.ds[1 - cur].hi);
      x_epi.out_lo = const_cast<uint16_t*>(W.ds[1 - cur].lo);
    } else {
      x_epi.S = W.S0;
      x_epi.out_f32 = reinterpret_cast<float*>(const_cast<uint16_t*>(W.ds[1 - cur].hi));
    }
    rc = wire_gemm<MODE_DX>(W.ds[cur], 4 * H, W.wblk[l], 2 * H, P, 2 * H, 4 * H, 1, 4 * H,
                            x_epi, stream);
    if (rc) return rc;
    cur = 1 - cur;
  }

  // the first layer (real input): dS0 [dsr | ds2r] in float32
  const float* ds0 = reinterpret_cast<const float*>(W.ds[cur].hi);
  rc = gemm_tn_reduced(ds0, 2 * H, x, d, P, W.gfirst, W.partial, stream);
  if (!rc) rc = colsum_reduced(ds0, P, 2 * H, nullptr, W.gbias, W.partial, stream);
  if (rc) return rc;
  LAUNCH(unpack_ends_kernel, ew_blocks((long long)H * d), EW_THREADS, stream)(
      W.gfirst, W.gbias, W.gfin, d, H, dw[0], dw[1], dw[2], dw[3], dw[fin], dw[fin + 1]);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"

extern "C" {

// Bytes of workspace wire_forward_tc needs, or -1 when the route does not
// take the widths (those of wire_tc_workspace_bytes).
long long wire_forward_tc_workspace_bytes(int P, int d_in, int H, int n_hidden) {
  if (!supported(P, d_in, H, n_hidden)) return -1;
  return carve_forward(nullptr, P, H, n_hidden).bytes;
}

// K5 on the tensor cores: out (P) = WIRE(x) with K4's forward passes: the
// block matrices, the first layer, a wire_gemm<MODE_FWD> pass a hidden
// layer (no S), the last layer. oms: (n_hidden + 1, 2) on the device; work:
// wire_forward_tc_workspace_bytes bytes. 2 n_hidden + 2 launches.
int wire_forward_tc(const float* x, int P, int d_in, int H, int n_hidden,
                    const float* const* w, const float* oms, void* work, float* out,
                    cudaStream_t stream) {
  if (!supported(P, d_in, H, n_hidden)) return -1;
  const int nh = n_hidden;
  const FwdWork W = carve_forward(static_cast<char*>(work), P, H, nh);
  const int fin = 4 + 8 * nh;
  for (int l = 0; l < nh; ++l) {
    HiddenWeights k;
    for (int i = 0; i < 8; ++i) k.w[i] = w[4 + 8 * l + i];
    LAUNCH(pack_block_kernel, ew_blocks(8LL * H * H), EW_THREADS, stream)(
        k, H, const_cast<uint16_t*>(W.wblk[l].hi), const_cast<uint16_t*>(W.wblk[l].lo),
        W.bias[l]);
    CHECK_LAUNCH();
  }
  LAUNCH(first_forward_kernel, ew_blocks((long long)P * H), EW_THREADS, stream)(
      x, P, d_in, H, w[0], w[1], w[2], w[3], oms, nullptr,
      const_cast<uint16_t*>(W.slot[0].hi), const_cast<uint16_t*>(W.slot[0].lo));
  CHECK_LAUNCH();
  for (int l = 0; l < nh; ++l) {
    const Planes in = W.slot[l & 1], next = W.slot[(l + 1) & 1];
    WireEpi e{};
    e.H = H;
    e.bias = W.bias[l];
    e.om_sg = oms + 2 * (l + 1);
    if (l + 1 < nh) {
      e.out_hi = const_cast<uint16_t*>(next.hi);
      e.out_lo = const_cast<uint16_t*>(next.lo);
    } else {
      e.out_f32 = reinterpret_cast<float*>(const_cast<uint16_t*>(next.hi));
    }
    const int rc = wire_gemm<MODE_FWD>(in, 2 * H, W.wblk[l], 2 * H, P, 4 * H, 2 * H, 1, 2 * H,
                                       e, stream);
    if (rc) return rc;
  }
  LAUNCH(last_forward_kernel, rowdot_blocks(P), ROWDOT_WARPS * 32, stream)(
      reinterpret_cast<const float*>(W.slot[nh & 1].hi), P, H, w[fin], w[fin + 1],
      w[fin + 2], out);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
