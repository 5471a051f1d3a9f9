// Hand-written Hopper (sm_90a) streaming tensor-core route of the SIREN
// kernel K1 (siren_loss_grads) for MLPs of a narrow input, equal hidden
// widths H that are multiples of 64, and one output: the soft-ERD fit's
// SirenERD 2 -> 128x4 -> 128 (ReLU) -> 1 (ReLU) with max |out| (K1-a), and
// the 2-D ensemble's Siren 2 -> 64x7 -> 1 called unbatched.
//
// Replaces, for the calls off the tensor-core route whose plan fits
// (ops/siren_kernel.py's stream_route, from the widths alone), the Pallas
// TPU kernel of
// mri_super_resolution_tpu/ops/pallas/siren_kernel.py:
//   K1 siren_loss_grads (:518, pallas_call at :580): one-pass forward,
//      masked (sample-weighted) MSE and backward, giving the loss, every dW
//      and db and, when asked, max |out| over the real rows.
// It takes all of K1's options: sample weights, max |out|, and the per-layer
// activation codes (sine, ReLU or none on a hidden layer, ReLU or none on
// the last).
//
// What bounds it on an H100: the products. K1-a on 16,384 rows is 6.48
// GFLOP of float32 products (0.097 ms at the card's 67 TFLOP/s of FMA), 6.44
// of them in the four H x H layers' forward, chain and dW; as the bf16x3
// split below, 19.4 GFLOP: 0.020 ms at the 989 TFLOP/s bf16 peak.
// csrc/siren.cu spends it in 36 launches of one GEMM pass a layer, each
// with 128 row tiles, so its launches set its time. The four 128 x 128
// float32 layers (268 KB) do not fit one block's shared memory, so a
// design that keeps every weight resident in a block cannot take it. Here:
//   * each block owns one tile of ST_TM = 128 rows and runs all of K1 on it:
//     the forward, the (weighted, masked) residual, the loss and max |out|
//     partials and the backward chain; only dW, db, the loss and max |out|
//     cross blocks;
//   * the first layer (K = d_in) and the last (N = 1) run on the SIMT cores
//     inside the kernel; the hidden H x H layers on the tensor cores as
//     mma.sync m16n8k16 bf16x3 products (hi hi + hi lo + lo hi, float32
//     sums; the split of csrc/gemm3.cuh);
//   * the activations and deltas of the tile stay in shared memory as
//     hi/lo bf16 planes (two buffers that swap roles); each hidden layer's
//     z goes to the tile's own rows of a global stash; the backward reads it
//     once, puts act(z) into shared memory for dW and act'(z) back in place
//     of z for the chain's epilogue (sincosf, never fast math, in one
//     elementwise pass, cheaper on an H100 than computing act'(z) in the
//     chain's unrolled epilogue);
//   * the weights are split into hi/lo planes once a call (a small first
//     launch) and stream through a two-stage cp.async ring of 32-row slices
//     of W: the forward takes a slice as 32 output columns (ldmatrix), the
//     chain the same slice as 32 rows of depth (ldmatrix.trans); the next
//     slice loads while the current one multiplies;
//   * dW_l = delta_l^T a_{l-1} on the tensor cores over the tile's rows and
//     db_l, the loss and max |out| into the block's own slot of a
//     workspace; a third launch sums the slots in block order
//     (csrc/slots.cuh): no float atomics, a call repeats bit for bit.
// Three launches a call. ReLU is z > 0 ? z : 0 on the float32 sum, so a
// collapsed output gives max |out| exactly 0.
// Shared-memory plan (bytes; ops/siren_kernel.py's stream_smem_bytes is the
// same formula): a row of a plane holds S = H + 8 halves (16 bytes of pad,
// so the eight rows of an ldmatrix fall in distinct banks); two buffers of
// hi and lo planes of ST_TM rows (8 S ST_TM), ST_STAGES ring stages of hi
// and lo planes of ST_RING rows (4 ST_STAGES ST_RING S), three floats a row
// (the last layer's delta, squared residual and |out|). H = 128 needs
// 175,616 bytes, H = 192 more than a block has: the route takes H of 64
// and 128.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren_stream.so siren_stream.cu
//        (see ops/_build.py)

#include "gemm3.cuh"
#include "slots.cuh"

namespace {

constexpr int ST_TM = 128;   // rows a tile: one tile a block
constexpr int ST_NT = 4 * ST_TM;  // threads: four a row in the last layer
constexpr int ST_WARPS = ST_NT / 32;
constexpr int ST_MW = ST_TM / 16;  // warps along the rows of a forward slice (two along its 32 columns)
constexpr int ST_BLOCKS_PER_SM = 128 / ST_TM;
constexpr int ST_RING = 32;  // rows of W a ring stage
constexpr int ST_STAGES = 2;
constexpr int ST_H_STEP = 64;
constexpr int ST_MAX_LAYERS = 16;
constexpr int ST_SMEM_MAX = 232448;  // an H100 block's opt-in shared memory

struct StreamPlan {
  int L, d0, H, S;  // layers, input width, hidden width, halves a plane row
  int n_params;     // floats of every dW and db; a slot holds 2 more
  int w_out[ST_MAX_LAYERS], b_out[ST_MAX_LAYERS];  // dW_l, db_l in a slot
  long long smem;   // bytes; -1 when the route does not take the widths
};

// The plan of these widths: 3 to ST_MAX_LAYERS layers, one output, every
// hidden width H, a multiple of ST_H_STEP, and the shared memory within
// ST_SMEM_MAX.
StreamPlan stream_plan(const int* dims, int n_layers) {
  StreamPlan p{};
  p.smem = -1;
  if (n_layers < 3 || n_layers > ST_MAX_LAYERS || dims[0] < 1 || dims[n_layers] != 1)
    return p;
  const int H = dims[1];
  if (H < ST_H_STEP || H % ST_H_STEP) return p;
  for (int l = 2; l < n_layers; ++l)
    if (dims[l] != H) return p;
  p.L = n_layers;
  p.d0 = dims[0];
  p.H = H;
  p.S = H + 8;
  int out = 0;
  for (int l = 0; l < n_layers; ++l) {
    p.w_out[l] = out;
    out += dims[l + 1] * dims[l];
    p.b_out[l] = out;
    out += dims[l + 1];
  }
  p.n_params = out;
  const long long smem =
      8LL * p.S * ST_TM + 4LL * ST_STAGES * ST_RING * p.S + 3LL * 4 * ST_TM;
  if (smem <= ST_SMEM_MAX) p.smem = smem;
  return p;
}

// What a call reads and where it writes.
struct StreamArgs {
  const float* x;
  const float* target;
  const float* sw;  // sample weights, or null
  const float* W[ST_MAX_LAYERS];
  const float* b[ST_MAX_LAYERS];
  float omega[ST_MAX_LAYERS];
  int act[ST_MAX_LAYERS];
  int P, n_rows;
  float two_inv_n;
  uint16_t* wp;        // hidden layer l's W as hi then lo planes (H x H) at (l - 1) 2 H H
  float* zs;           // hidden layer l's z (rows_pad x H) at l rows_pad H, l < L - 1
  long long rows_pad;  // the tiles' rows
  float* partial;      // a slot of n_params + 2 floats a block
};

// ---- fragments (lane-wise addresses as in csrc/gemm3.cuh) ----------------------

// an m16 x k16 A fragment at (m, k) of a plane whose rows run along k
__device__ __forceinline__ void frag_a_kc(unsigned r[4], const uint16_t* plane, int ld, int m,
                                          int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, plane + (m + (lane & 15)) * ld + k + (lane >> 4) * 8);
}

// the same from a plane whose rows run along m
__device__ __forceinline__ void frag_a_rc(unsigned r[4], const uint16_t* plane, int ld, int m,
                                          int k) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  ldsm_x4_trans(r, plane + (k + (q >> 1) * 8 + (lane & 7)) * ld + m + (q & 1) * 8);
}

// two n8 x k16 B fragments (n .. n + 15) at depth k of a plane whose rows
// run along k (KC) or along n (RC)
__device__ __forceinline__ void frag_b_kc(unsigned (*b)[2], const uint16_t* plane, int ld, int n,
                                          int k) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  unsigned r[4];
  ldsm_x4(r, plane + (n + (q >> 1) * 8 + (lane & 7)) * ld + k + (q & 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

__device__ __forceinline__ void frag_b_rc(unsigned (*b)[2], const uint16_t* plane, int ld, int n,
                                          int k) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  unsigned r[4];
  ldsm_x4_trans(r, plane + (k + (q & 1) * 8 + (lane & 7)) * ld + n + (q >> 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// c += a b in bf16x3, the products in csrc/gemm3.cuh's order
__device__ __forceinline__ void mma3(float c[4], const unsigned ah[4], const unsigned al[4],
                                     const unsigned bh[2], const unsigned bl[2]) {
  mma_bf16(c, ah, bl);
  mma_bf16(c, al, bh);
  mma_bf16(c, ah, bh);
}

// ---- the kernels -------------------------------------------------------------------

// Every hidden W_l (l = 1 .. L - 2) as hi/lo bf16 planes.
__global__ void stream_pack_kernel(StreamArgs a, int L, int H) {
  const long long per = (long long)H * H, total = (L - 2) * per;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int l = 1 + (int)(e / per);
    const long long i = e - (l - 1) * per;
    unsigned h, lo;
    split_bf16(a.W[l][i], h, lo);
    a.wp[(l - 1) * 2 * per + i] = (uint16_t)h;
    a.wp[(l - 1) * 2 * per + per + i] = (uint16_t)lo;
  }
}

// K1 on row tile blockIdx.x: its share of the loss, max |out| and every dW,
// db into the block's slot.
__global__ void __launch_bounds__(ST_NT, ST_BLOCKS_PER_SM) siren_stream_kernel(StreamPlan pl, StreamArgs a) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) uint16_t sm[];
#else
  alignas(16) __shared__ uint16_t sm[ST_SMEM_MAX / 2];
  emu_poison_shared(sm, sizeof sm);
#endif
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = pl.L, H = pl.H, S = pl.S, d0 = pl.d0;
  const int r0 = blockIdx.x * ST_TM;
  const long long HH = (long long)H * H;
  const int PL = ST_TM * S;  // halves from a buffer's hi plane to its lo plane
  uint16_t* buf[2] = {sm, sm + 2 * PL};
  uint16_t* ring = sm + 4 * PL;
  const int RPL = ST_RING * S;  // the same for a ring stage
  float* dl = reinterpret_cast<float*>(ring + ST_STAGES * 2 * RPL);
  float* sq = dl + ST_TM;
  float* mx = sq + ST_TM;
  float* slot = a.partial + (long long)blockIdx.x * (pl.n_params + 2);
  auto zs = [&](int l) { return a.zs + l * a.rows_pad * H + (long long)r0 * H; };
  auto val = [&](const uint16_t* b, int r, int n) {
    return bf16_to_f32(b[r * S + n]) + bf16_to_f32(b[PL + r * S + n]);
  };
  auto put = [&](uint16_t* b, int r, int n, float v0, float v1) {
    store_planes(b, b + PL, (long long)r * S + n, v0, v1);
  };

  // The ring: slice s of W (ST_RING rows): the forward's slices of layers 1
  // .. L - 2, then the chain's of layers L - 2 .. 1, each layer's rows in
  // order.
  const int per_layer = H / ST_RING;
  const int n_fwd = (L - 2) * per_layer, n_slices = 2 * n_fwd;
  auto load_slice = [&](int s) {
    const int l = s < n_fwd ? 1 + s / per_layer : L - 2 - (s - n_fwd) / per_layer;
    const uint16_t* hi = a.wp + (l - 1) * 2 * HH + (long long)(s % per_layer) * ST_RING * H;
    uint16_t* d = ring + (s % ST_STAGES) * 2 * RPL;
    const int chunks = H / 8;
    for (int i = tid; i < ST_RING * chunks; i += ST_NT) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      cp_async16(d + r * S + c, hi + (long long)r * H + c, true);
      cp_async16(d + RPL + r * S + c, hi + HH + (long long)r * H + c, true);
    }
  };
  // slice s is in and every warp is done with slice s - 1, whose stage then
  // takes slice s + 1
  auto begin_slice = [&](int s) -> const uint16_t* {
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < n_slices) load_slice(s + 1);
    cp_async_commit();
    return ring + (s % ST_STAGES) * 2 * RPL;
  };
  load_slice(0);
  cp_async_commit();

  // ---- forward: the first layer (x is zero past P) ----
  {
    float* z_0 = zs(0);
    for (int i = tid; i < ST_TM * H / 2; i += ST_NT) {
      const int r = i / (H / 2), n = 2 * (i - r * (H / 2));
      const int row = r0 + r;
      float v[2], f;
      for (int e = 0; e < 2; ++e) {
        float z = 0.f;
        if (row < a.P)
          for (int k = 0; k < d0; ++k)
            z = fmaf(a.x[(long long)row * d0 + k], a.W[0][(n + e) * d0 + k], z);
        z += a.b[0][n + e];
        z_0[(long long)r * H + n + e] = z;
        act_and_factor(a.act[0], a.omega[0], z, v[e], f);
      }
      put(buf[0], r, n, v[0], v[1]);
    }
  }
  {
    const int fm = (warp % ST_MW) * 16, fn = (warp / ST_MW) * 16;  // this warp's 16 x 16 of a slice
    for (int l = 1; l <= L - 2; ++l) {
      const uint16_t* in = buf[(l - 1) & 1];
      uint16_t* out = buf[l & 1];
      float* z_l = zs(l);
      for (int j = 0; j < per_layer; ++j) {
        const uint16_t* w = begin_slice((l - 1) * per_layer + j);
        float acc[2][4] = {};
        for (int k = 0; k < H; k += 16) {
          unsigned ah[4], al[4], bh[2][2], bl[2][2];
          frag_a_kc(ah, in, S, fm, k);
          frag_a_kc(al, in + PL, S, fm, k);
          frag_b_kc(bh, w, S, fn, k);
          frag_b_kc(bl, w + RPL, S, fn, k);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) mma3(acc[jj], ah, al, bh[jj], bl[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = fm + (lane >> 2) + 8 * h;
            const int n = j * ST_RING + fn + 8 * jj + 2 * (lane & 3);
            float v[2], f;
            for (int e = 0; e < 2; ++e) {
              const float z = acc[jj][2 * h + e] + a.b[l][n + e];
              z_l[(long long)r * H + n + e] = z;
              act_and_factor(a.act[l], a.omega[l], z, v[e], f);
            }
            put(out, r, n, v[0], v[1]);
          }
      }
    }
  }
  __syncthreads();

  // ---- the last layer: four threads a row; residual, delta, loss, max |out| ----
  const int top = (L - 2) & 1;  // the buffer of a_{L-2}
  const uint16_t* h_top = buf[top];
  const float* w_last = a.W[L - 1];
  {
    const int r = tid >> 2, q = tid & 3, span = H / 4;
    float s = 0.f;
    for (int k = q * span; k < (q + 1) * span; ++k) s = fmaf(val(h_top, r, k), w_last[k], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) {
      const int row = r0 + r;
      const float z = s + a.b[L - 1][0];
      const bool relu = a.act[L - 1] == ACT_RELU;
      const float v = relu ? (z > 0.f ? z : 0.f) : z;
      const float step = (!relu || z > 0.f) ? 1.f : 0.f;
      const bool real = row < a.n_rows;
      const float res = real ? v - a.target[row] : 0.f;
      const float wr = (a.sw != nullptr && real) ? a.sw[row] * res : res;
      dl[r] = relu ? (a.two_inv_n * wr) * step : a.two_inv_n * wr;
      sq[r] = wr * res;
      mx[r] = real ? (v < 0.f ? -v : v) : 0.f;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float loss = 0.f, m = 0.f;
    for (int r = 0; r < ST_TM; ++r) {
      loss += sq[r];
      m = mx[r] > m ? mx[r] : m;
    }
    slot[pl.n_params] = loss;
    slot[pl.n_params + 1] = m;
  }
  for (int k = tid; k <= H; k += ST_NT) {  // the last layer's dW and db
    float s = 0.f;
    if (k < H) {
      for (int r = 0; r < ST_TM; ++r) s = fmaf(dl[r], val(h_top, r, k), s);
    } else {
      for (int r = 0; r < ST_TM; ++r) s += dl[r];
    }
    slot[k < H ? pl.w_out[L - 1] + k : pl.b_out[L - 1]] = s;
  }
  {  // delta_{L-2} = dl w_last act'(z_{L-2}) into the other buffer
    const float* z = zs(L - 2);
    for (int i = tid; i < ST_TM * H / 2; i += ST_NT) {
      const int r = i / (H / 2), n = 2 * (i - r * (H / 2));
      float d[2], av;
      for (int e = 0; e < 2; ++e) {
        act_and_factor(a.act[L - 2], a.omega[L - 2], z[(long long)r * H + n + e], av, d[e]);
        d[e] *= dl[r] * w_last[n + e];
      }
      put(buf[1 - top], r, n, d[0], d[1]);
    }
  }
  __syncthreads();

  // ---- backward through the hidden layers: delta_l in buf[dc] ----
  int dc = 1 - top;
  for (int l = L - 2; l >= 1; --l) {
    const uint16_t* D = buf[dc];
    uint16_t* A = buf[1 - dc];
    // a_{l-1} into A (over a_{L-2} or delta_{l+1}, both read already) and
    // act'(z_{l-1}) in place of z_{l-1}, a thread's own elements
    float* z_in = zs(l - 1);
    for (int i = tid; i < ST_TM * H / 2; i += ST_NT) {
      const int r = i / (H / 2), n = 2 * (i - r * (H / 2));
      float v[2], f[2];
      for (int e = 0; e < 2; ++e)
        act_and_factor(a.act[l - 1], a.omega[l - 1], z_in[(long long)r * H + n + e], v[e], f[e]);
      for (int e = 0; e < 2; ++e) z_in[(long long)r * H + n + e] = f[e];
      put(A, r, n, v[0], v[1]);
    }
    __syncthreads();
    // dW_l = delta_l^T a_{l-1} over the tile's rows (32 x 32 a warp), db_l
    const int wt = H / 32;
    for (int t = warp; t < wt * wt; t += ST_WARPS) {
      const int m = (t / wt) * 32, n = (t % wt) * 32;
      float acc[2][4][4] = {};
      for (int k = 0; k < ST_TM; k += 16) {
        unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          frag_a_rc(ah[i], D, S, m + 16 * i, k);
          frag_a_rc(al[i], D + PL, S, m + 16 * i, k);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          frag_b_rc(bh + 2 * jj, A, S, n + 16 * jj, k);
          frag_b_rc(bl + 2 * jj, A + PL, S, n + 16 * jj, k);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma3(acc[i][j], ah[i], al[i], bh[j], bl[j]);
      }
      float* dw = slot + pl.w_out[l];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int u = m + 16 * i + (lane >> 2) + 8 * h;
            const int v = n + 8 * j + 2 * (lane & 3);
            dw[u * H + v] = acc[i][j][2 * h];
            dw[u * H + v + 1] = acc[i][j][2 * h + 1];
          }
    }
    for (int n = tid; n < H; n += ST_NT) {
      float s = 0.f;
      for (int r = 0; r < ST_TM; ++r) s += val(D, r, n);
      slot[pl.b_out[l] + n] = s;
    }
    __syncthreads();
    // the chain: delta_{l-1} = (delta_l W_l) act'(z_{l-1}) into A (32 x 32 a
    // warp of the ST_TM x H output), W_l's rows streamed as the depth
    {
      const int t = warp;
      const bool mine = t < (ST_TM / 32) * wt;
      const int m = (t % (ST_TM / 32)) * 32, n = (t / (ST_TM / 32)) * 32;
      float acc[2][4][4] = {};
      for (int j = 0; j < per_layer; ++j) {
        const uint16_t* w = begin_slice(n_fwd + (L - 2 - l) * per_layer + j);
        if (!mine) continue;
#pragma unroll
        for (int ks = 0; ks < ST_RING; ks += 16) {
          unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            frag_a_kc(ah[i], D, S, m + 16 * i, j * ST_RING + ks);
            frag_a_kc(al[i], D + PL, S, m + 16 * i, j * ST_RING + ks);
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            frag_b_rc(bh + 2 * jj, w, S, n + 16 * jj, ks);
            frag_b_rc(bl + 2 * jj, w + RPL, S, n + 16 * jj, ks);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jx = 0; jx < 4; ++jx) mma3(acc[i][jx], ah[i], al[i], bh[jx], bl[jx]);
        }
      }
      if (mine) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m + 16 * i + (lane >> 2) + 8 * h;
              const int c = n + 8 * j + 2 * (lane & 3);
              const float* f = z_in + (long long)r * H + c;
              put(A, r, c, acc[i][j][2 * h] * f[0], acc[i][j][2 * h + 1] * f[1]);
            }
      }
    }
    __syncthreads();
    dc = 1 - dc;
  }

  // ---- the first layer's dW and db from delta_0 ----
  const uint16_t* D0 = buf[dc];
  for (int i = tid; i < H * (d0 + 1); i += ST_NT) {
    const int n = i / (d0 + 1), k = i - n * (d0 + 1);
    float s = 0.f;
    if (k < d0) {
      for (int r = 0; r < ST_TM && r0 + r < a.P; ++r)
        s = fmaf(val(D0, r, n), a.x[(long long)(r0 + r) * d0 + k], s);
    } else {
      for (int r = 0; r < ST_TM; ++r) s += val(D0, r, n);
    }
    slot[k < d0 ? pl.w_out[0] + n * d0 + k : pl.b_out[0] + n] = s;
  }
}

// The workspace of a call, carved in order (bytes; each piece 256-aligned).
struct StreamWork {
  uint16_t* wp;
  float* zs;
  float* partial;
  long long rows_pad, bytes;
};

StreamWork carve_stream(char* base, const StreamPlan& pl, int P) {
  StreamWork w{};
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  const int blocks = cdiv(P, ST_TM);
  w.rows_pad = (long long)blocks * ST_TM;
  w.wp = reinterpret_cast<uint16_t*>(take(2LL * 2 * (pl.L - 2) * pl.H * pl.H));
  w.zs = reinterpret_cast<float*>(take(4LL * (pl.L - 1) * w.rows_pad * pl.H));
  w.partial = reinterpret_cast<float*>(take(4LL * blocks * (pl.n_params + 2)));
  w.bytes = at;
  return w;
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of the route takes for these widths (dims:
// input, hidden widths..., 1), or -1 when the route does not take them.
long long siren_stream_smem_bytes(const int* dims, int n_layers) {
  return stream_plan(dims, n_layers).smem;
}

// Floats of workspace a call of P rows needs (the split weights, the z
// stash and a slot a block), or -1 when the route does not take the widths.
long long siren_stream_work_floats(int P, const int* dims, int n_layers) {
  const StreamPlan pl = stream_plan(dims, n_layers);
  if (pl.smem < 0 || P < 1) return -1;
  return carve_stream(nullptr, pl, P).bytes / 4;
}

// K1 on the streaming tensor-core route: out (n_params + 2 floats) gets
// every dW_l and db_l in the flat order W0, b0, W1, b1, ... (torch layouts),
// then the loss inv_n * sum_{p < n_rows} s_p (MLP(x)_p - target_p)^2 (s_p =
// sw[p], or 1 when sw is null), then max_{p < n_rows} |MLP(x)_p|. w: [W0,
// b0, ...]; act: the per-layer codes; omegas: one per hidden layer; work:
// siren_stream_work_floats floats. Three launches.
int siren_loss_grads_stream(const float* x, int P, int n_rows, const int* dims, int n_layers,
                            const int* act, const float* const* w, const float* omegas,
                            const float* target, const float* sw, float inv_n, float* work,
                            float* out, cudaStream_t stream) {
  const StreamPlan pl = stream_plan(dims, n_layers);
  if (pl.smem < 0 || P < 1) return -1;
#ifdef __CUDACC__
  // on every call: the attribute belongs to the current device's context
  const cudaError_t e = cudaFuncSetAttribute(
      siren_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
#endif
  const StreamWork wk = carve_stream(reinterpret_cast<char*>(work), pl, P);
  StreamArgs a{};
  a.x = x;
  a.target = target;
  a.sw = sw;
  for (int l = 0; l < n_layers; ++l) {
    a.W[l] = w[2 * l];
    a.b[l] = w[2 * l + 1];
    a.act[l] = act[l];
    a.omega[l] = l + 1 < n_layers ? omegas[l] : 1.f;
  }
  a.P = P;
  a.n_rows = n_rows;
  a.two_inv_n = 2.f * inv_n;
  a.wp = wk.wp;
  a.zs = wk.zs;
  a.rows_pad = wk.rows_pad;
  a.partial = wk.partial;
  const int blocks = cdiv(P, ST_TM);
  LAUNCH(stream_pack_kernel, ew_blocks((long long)(pl.L - 2) * pl.H * pl.H), EW_THREADS,
         stream)(a, pl.L, pl.H);
  CHECK_LAUNCH();
  LAUNCH_SMEM(siren_stream_kernel, blocks, ST_NT, pl.smem, stream)(pl, a);
  CHECK_LAUNCH();
  LAUNCH(slot_reduce_kernel, cdiv(pl.n_params + 2, 256), 256, stream)(
      wk.partial, blocks, pl.n_params, inv_n, out);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
