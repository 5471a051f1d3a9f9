// Hand-written Hopper (sm_90a) weight-resident route of the SIREN kernel K1
// (siren_loss_grads) for networks whose weights fit in one block's shared
// memory: the 2-D directional ensemble's Siren 2 -> 64x7 -> 1 (25,217
// float32 weights and biases, 100,868 bytes) and every other small MLP.
//
// Replaces, for the calls whose plan fits (ops/siren_kernel.py's
// resident_route, from the widths alone), the Pallas TPU kernel of
// mri_super_resolution_tpu/ops/pallas/siren_kernel.py:
//   K1 siren_loss_grads (:518, pallas_call at :580): one-pass forward,
//      masked (sample-weighted) MSE and backward, giving the loss, every dW
//      and db and, when asked, max |out| over the real rows.
// It takes all of K1's options: sample weights, max |out|, and the per-layer
// activation codes (sine, ReLU or none on a hidden layer, ReLU or none on
// the last), as csrc/siren.cu's SIMT kernels do.
//
// What bounds it on an H100: neither the products nor the bytes. One call at
// the ensemble's shape is 0.54 GFLOP (8 us at the card's 67 TFLOP/s of
// float32 FMA) and reads 0.1 MB; the SIMT route spends it in 47 launches of
// one tiled GEMM pass a layer, each with 29 row tiles for 132 SMs, so the
// host's launch rate sets its time. The TPU kernel keeps every weight in
// VMEM for each row tile (siren_kernel.py:424-598); at these widths that
// design fits a Hopper SM, and it is the design here:
//   * a block copies every W and b into shared memory once (zero-padded to
//     widths of a multiple of 4), then walks row tiles of 32 rows, one row a
//     lane: the forward pass, the last layer with the (weighted, masked)
//     residual, and the backward chain, all in shared memory;
//   * the stash is each hidden layer's z = a W^T + b (float32); the
//     backward recomputes sin(omega z) and omega cos(omega z) with sincosf
//     (never fast math), as the forward computed them;
//   * products are float32 FMA on the SIMT cores: forward and chain with a
//     lane's row against weights read by the whole warp at one address
//     (broadcast), dW_l = delta^T a as 4 x 4 register tiles over the 32 rows;
//   * each block adds its rows' share of every dW, db, the loss and max |out|
//     into its own slot of a workspace (one slot a block, the same thread
//     for the same value in every tile: no atomics), and a second launch
//     sums the slots in block order: a call repeats bit for bit;
//   * at most one block an SM (the caller gives the device's SM count, 132
//     on an H100, asked once; siren_resident_setup sets the kernel's
//     shared-memory attribute once a device); two launches a call.
// The batched form (jax.vmap over siren_loss_grads, the 2-D ensemble's three
// directions) is csrc/siren_resident_tc.cu.
// Shared-memory plan (floats; ops/siren_kernel.py's resident_smem_bytes is
// the same formula): the sum over layers of pad4(out) (pad4(in) + 1) for W and
// b; a row stride S = pad4(widest input or hidden width), plus 4 when S / 4
// is even (a lane's 16-byte row reads then fall in distinct banks); one
// z stash of 32 x S a hidden layer; three buffers of 32 x S (the forward's
// two activation slots, the backward's activation and two deltas); 32 for
// the last layer's delta. The ensemble's Siren needs 189,328 bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren_resident.so siren_resident.cu
//        (see ops/_build.py)

#include "slots.cuh"

namespace {

constexpr int RES_ROWS = 32;  // rows a tile: one a lane
constexpr int RES_NT = 256;   // threads: 8 warps
constexpr int RES_WARPS = RES_NT / 32;
constexpr int RES_TQ = 2;     // column quads a thread takes in the forward and chain
constexpr int RES_MAX_LAYERS = 16;
constexpr int RES_SMEM_MAX = 232448;  // the route's plans: an H100 block's opt-in shared memory

// Where everything lives, from the widths alone (floats; every offset a
// multiple of 4, so float4 accesses stay 16-byte aligned).
struct Plan {
  int L;
  int dims[RES_MAX_LAYERS + 1];
  int kp[RES_MAX_LAYERS];     // pad4(d_l): layer l's input width in shared memory
  int np[RES_MAX_LAYERS];     // pad4(d_{l+1}): its output width
  int w_sm[RES_MAX_LAYERS];   // W_l as np x kp
  int b_sm[RES_MAX_LAYERS];   // b_l as np
  int w_out[RES_MAX_LAYERS];  // dW_l in a slot (the flat order W0, b0, W1, b1, ...)
  int b_out[RES_MAX_LAYERS];  // db_l in a slot
  int stride;                 // S: a row of an activation, stash or delta buffer
  int z_sm;                   // L - 1 stashes of RES_ROWS x S
  int buf_sm;                 // three buffers of RES_ROWS x S
  int dl_sm;                  // the last layer's delta, RES_ROWS
  int n_params;               // floats of every dW and db; a slot holds 2 more
  int smem_floats;
};

inline int pad4(int n) { return (n + 3) / 4 * 4; }

// The plan of these widths; smem_floats = -1 when they do not make a K1
// network this route takes (1 to RES_MAX_LAYERS layers above one hidden
// layer, one output).
Plan make_plan(const int* dims, int n_layers) {
  Plan p{};
  p.smem_floats = -1;
  if (n_layers < 2 || n_layers > RES_MAX_LAYERS || dims[n_layers] != 1) return p;
  p.L = n_layers;
  int at = 0, out = 0, widest = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return p;
    p.dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    p.kp[l] = pad4(dims[l]);
    p.np[l] = pad4(dims[l + 1]);
    p.w_sm[l] = at;
    at += p.np[l] * p.kp[l];
    p.b_sm[l] = at;
    at += p.np[l];
    p.w_out[l] = out;
    out += dims[l + 1] * dims[l];
    p.b_out[l] = out;
    out += dims[l + 1];
    widest = dims[l] > widest ? dims[l] : widest;
  }
  p.stride = pad4(widest);
  if ((p.stride / 4) % 2 == 0) p.stride += 4;
  p.z_sm = at;
  at += (n_layers - 1) * RES_ROWS * p.stride;
  p.buf_sm = at;
  at += 3 * RES_ROWS * p.stride;
  p.dl_sm = at;
  at += RES_ROWS;
  p.n_params = out;
  p.smem_floats = at;
  return p;
}

// What a call reads and where each block adds its share.
struct Args {
  const float* x;
  const float* target;
  const float* sw;  // sample weights, or null
  const float* W[RES_MAX_LAYERS];
  const float* b[RES_MAX_LAYERS];
  float omega[RES_MAX_LAYERS];
  int act[RES_MAX_LAYERS];
  int P, n_rows;
  int bps;  // blocks a call: block i walks row tiles i, i + bps, ...
  float two_inv_n;
  float* partial;  // gridDim.x slots of n_params + 2 floats
};

__device__ __forceinline__ void quad(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void put_quad(float* p, const float v[4]) {
  float4 q;
  q.x = v[0];
  q.y = v[1];
  q.z = v[2];
  q.w = v[3];
  *reinterpret_cast<float4*>(p) = q;
}

// rows r0 .. r0 + 31 of x into buf (RES_ROWS x S), zero past P and past d_0
__device__ void load_x(const Plan& pl, const Args& a, int r0, float* buf) {
  const int d0 = pl.dims[0], kp = pl.kp[0];
  for (int i = threadIdx.x; i < RES_ROWS * kp; i += RES_NT) {
    const int r = i / kp, k = i - r * kp;
    buf[r * pl.stride + k] = (r0 + r < a.P && k < d0) ? a.x[(long long)(r0 + r) * d0 + k] : 0.f;
  }
}

// Forward of hidden layer l: z = in W_l^T + b_l into z, act(z) into out,
// a lane's row against the warp's column quads.
__device__ void forward_layer(const Plan& pl, const Args& a, const float* sm, int l,
                              const float* in, float* z, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = pl.stride, kp = pl.kp[l], nq = pl.np[l] / 4;
  const float* W = sm + pl.w_sm[l];
  const float* bias = sm + pl.b_sm[l];
  for (int q0 = warp * RES_TQ; q0 < nq; q0 += RES_WARPS * RES_TQ) {
    int qs[RES_TQ];
    float acc[RES_TQ][4];
#pragma unroll
    for (int j = 0; j < RES_TQ; ++j) {
      qs[j] = min(q0 + j, nq - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    for (int k = 0; k < kp; k += 4) {
      float x4[4];
      quad(in + lane * S + k, x4);
#pragma unroll
      for (int j = 0; j < RES_TQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float w4[4];
          quad(W + (4 * qs[j] + e) * kp + k, w4);
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[j][e] = fmaf(x4[t], w4[t], acc[j][e]);
        }
    }
#pragma unroll
    for (int j = 0; j < RES_TQ; ++j) {
      if (q0 + j >= nq) continue;
      const int n = 4 * (q0 + j);
      float zq[4], aq[4], f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        zq[e] = acc[j][e] + bias[n + e];
        act_and_factor(a.act[l], a.omega[l], zq[e], aq[e], f);
      }
      put_quad(z + lane * S + n, zq);
      put_quad(out + lane * S + n, aq);
    }
  }
}

// Hidden layer j's stash z (RES_ROWS x np[j]) -> act(z) into out (unless
// null) and act'(z) in place of z.
__device__ void factor_pass(const Plan& pl, const Args& a, int j, float* z, float* out) {
  const int S = pl.stride, nq = pl.np[j] / 4;
  for (int i = threadIdx.x; i < RES_ROWS * nq; i += RES_NT) {
    const int r = i / nq, n = 4 * (i - r * nq);
    float zq[4], aq[4], fq[4];
    quad(z + r * S + n, zq);
#pragma unroll
    for (int e = 0; e < 4; ++e) act_and_factor(a.act[j], a.omega[j], zq[e], aq[e], fq[e]);
    put_quad(z + r * S + n, fq);
    if (out != nullptr) put_quad(out + r * S + n, aq);
  }
}

// Chain through hidden layer l > 0: out = (delta W_l) * F, delta (RES_ROWS x
// np[l]), F and out (RES_ROWS x kp[l]).
__device__ void chain_layer(const Plan& pl, const float* sm, int l, const float* delta,
                            const float* F, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = pl.stride, kp = pl.kp[l], np = pl.np[l], nq = kp / 4;
  const float* W = sm + pl.w_sm[l];
  for (int q0 = warp * RES_TQ; q0 < nq; q0 += RES_WARPS * RES_TQ) {
    int qs[RES_TQ];
    float acc[RES_TQ][4];
#pragma unroll
    for (int j = 0; j < RES_TQ; ++j) {
      qs[j] = min(q0 + j, nq - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    for (int n = 0; n < np; n += 4) {
      float d4[4];
      quad(delta + lane * S + n, d4);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < RES_TQ; ++j) {
          float w4[4];
          quad(W + (n + t) * kp + 4 * qs[j], w4);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(d4[t], w4[e], acc[j][e]);
        }
    }
#pragma unroll
    for (int j = 0; j < RES_TQ; ++j) {
      if (q0 + j >= nq) continue;
      const int k = 4 * (q0 + j);
      float f4[4];
      quad(F + lane * S + k, f4);
#pragma unroll
      for (int e = 0; e < 4; ++e) f4[e] *= acc[j][e];
      put_quad(out + lane * S + k, f4);
    }
  }
}

// This tile's share of dW_l = delta^T in and db_l = column sums of delta,
// added into the block's slot (written on its first tile).
__device__ void weight_grads(const Plan& pl, int l, const float* delta, const float* in,
                             float* slot, bool first) {
  const int S = pl.stride, din = pl.dims[l], dout = pl.dims[l + 1];
  const int kt = pl.kp[l] / 4, tiles = (pl.np[l] / 4) * kt;
  for (int t = threadIdx.x; t < tiles; t += RES_NT) {
    const int n0 = 4 * (t / kt), k0 = 4 * (t - (t / kt) * kt);
    float acc[4][4], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < RES_ROWS; ++r) {
      float d4[4], a4[4];
      quad(delta + r * S + n0, d4);
      quad(in + r * S + k0, a4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        db[i] += d4[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(d4[i], a4[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + i;
      if (n >= dout) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + j >= din) continue;
        float* p = slot + pl.w_out[l] + n * din + k0 + j;
        *p = first ? acc[i][j] : *p + acc[i][j];
      }
      if (k0 == 0) {
        float* p = slot + pl.b_out[l] + n;
        *p = first ? db[i] : *p + db[i];
      }
    }
  }
}

// K1 over row tiles i, i + bps, ... (i = blockIdx.x): the block's share of
// the loss, max |out| and every dW, db into its workspace slot.
__global__ void __launch_bounds__(RES_NT, 1) siren_resident_kernel(Plan pl, Args a) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) float sm[];
#else
  alignas(16) __shared__ float sm[RES_SMEM_MAX / 4];
  emu_poison_shared(sm, sizeof sm);
#endif
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = pl.L, S = pl.stride;
  const int blk = blockIdx.x;
  const float* target = a.target;
  const float* sw = a.sw;
  for (int l = 0; l < L; ++l) {  // every W and b, zero-padded
    const int din = pl.dims[l], dout = pl.dims[l + 1], kp = pl.kp[l], np = pl.np[l];
    const float* W = a.W[l];
    const float* b = a.b[l];
    for (int i = tid; i < np * kp; i += RES_NT) {
      const int n = i / kp, k = i - n * kp;
      sm[pl.w_sm[l] + i] = (n < dout && k < din) ? W[n * din + k] : 0.f;
    }
    for (int i = tid; i < np; i += RES_NT) sm[pl.b_sm[l] + i] = i < dout ? b[i] : 0.f;
  }
  float* buf[3] = {sm + pl.buf_sm, sm + pl.buf_sm + RES_ROWS * S,
                   sm + pl.buf_sm + 2 * RES_ROWS * S};
  float* dl = sm + pl.dl_sm;
  auto stash = [&](int j) { return sm + pl.z_sm + j * RES_ROWS * S; };
  float* slot = a.partial + (long long)blockIdx.x * (pl.n_params + 2);
  const float* w_last = sm + pl.w_sm[L - 1];
  const int d_last = pl.dims[L - 1];
  float loss_acc = 0.f, max_acc = 0.f;  // warp 0's, over its tiles
  bool first = true;
  for (int tile = blk; tile * RES_ROWS < a.P; tile += a.bps, first = false) {
    const int r0 = tile * RES_ROWS;
    __syncthreads();  // the weights are in; the last tile's readers are done
    load_x(pl, a, r0, buf[0]);
    __syncthreads();
    for (int l = 0; l + 1 < L; ++l) {
      forward_layer(pl, a, sm, l, buf[l & 1], stash(l), buf[(l + 1) & 1]);
      __syncthreads();
    }
    const float* h = buf[(L - 1) & 1];  // a_{L-1}
    if (warp == 0) {  // the last layer, a lane's row: residual, delta, loss, max |out|
      const int row = r0 + lane;
      float s = 0.f;
      for (int k = 0; k < d_last; ++k) s = fmaf(h[lane * S + k], w_last[k], s);
      const float z = s + sm[pl.b_sm[L - 1]];
      const bool relu = a.act[L - 1] == ACT_RELU;
      const float v = relu ? (z > 0.f ? z : 0.f) : z;
      const float step = (!relu || z > 0.f) ? 1.f : 0.f;
      const bool real = row < a.n_rows;
      const float r = real ? v - target[row] : 0.f;
      const float wr = (sw != nullptr && real) ? sw[row] * r : r;
      dl[lane] = relu ? (a.two_inv_n * wr) * step : a.two_inv_n * wr;
      float sq = wr * r;
      float mx = real ? (v < 0.f ? -v : v) : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
        const float m = __shfl_xor_sync(0xffffffffu, mx, o);
        mx = m > mx ? m : mx;
      }
      loss_acc += sq;
      max_acc = mx > max_acc ? mx : max_acc;
    }
    __syncthreads();
    // the last layer's dW and db; delta_{L-2} = dl w_last * F_{L-2} into buf[2]
    for (int k = tid; k <= d_last; k += RES_NT) {
      float s = 0.f;
      if (k < d_last) {
        for (int r = 0; r < RES_ROWS; ++r) s = fmaf(dl[r], h[r * S + k], s);
      } else {
        for (int r = 0; r < RES_ROWS; ++r) s += dl[r];
      }
      float* p = slot + (k < d_last ? pl.w_out[L - 1] + k : pl.b_out[L - 1]);
      *p = first ? s : *p + s;
    }
    {
      float* z = stash(L - 2);
      const int nq = pl.np[L - 2] / 4;
      for (int i = tid; i < RES_ROWS * nq; i += RES_NT) {
        const int r = i / nq, k = 4 * (i - r * nq);
        float zq[4], dq[4], w4[4], av;
        quad(z + r * S + k, zq);
        quad(w_last + k, w4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          act_and_factor(a.act[L - 2], a.omega[L - 2], zq[e], av, dq[e]);
          dq[e] *= dl[r] * w4[e];
        }
        put_quad(buf[2] + r * S + k, dq);
      }
    }
    __syncthreads();
    float* cur = buf[2];
    float* other = buf[1];
    for (int l = L - 2; l >= 0; --l) {
      // layer l's input (x, or act of the stash below it, whose factor
      // replaces it for the chain)
      if (l == 0) {
        load_x(pl, a, r0, buf[0]);
      } else {
        factor_pass(pl, a, l - 1, stash(l - 1), buf[0]);
      }
      __syncthreads();
      weight_grads(pl, l, cur, buf[0], slot, first);
      if (l > 0) chain_layer(pl, sm, l, cur, stash(l - 1), other);
      __syncthreads();
      float* t = cur;
      cur = other;
      other = t;
    }
  }
  if (tid == 0) {
    slot[pl.n_params] = loss_acc;
    slot[pl.n_params + 1] = max_acc;
  }
}

// Blocks a call of P rows takes on sms SMs: one a row tile, at most one an SM.
int resident_blocks(int P, int sms) {
  const int tiles = cdiv(P, RES_ROWS);
  return tiles < sms ? tiles : sms;
}

}  // namespace

extern "C" {

// Once a device, before its first launch: the kernel's opt-in shared memory
// (a device with less than the route's RES_SMEM_MAX bytes refuses it).
int siren_resident_setup() {
#ifdef __CUDACC__
  return (int)cudaFuncSetAttribute(siren_resident_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, RES_SMEM_MAX);
#else
  return 0;
#endif
}

// Floats of workspace a call needs on sms SMs: one slot of every dW, db, the
// loss and max |out| for each block (-1: not a K1 network, or a plan over the
// route's RES_SMEM_MAX bytes of shared memory).
long long siren_resident_work_floats(int P, const int* dims, int n_layers, int sms) {
  const Plan p = make_plan(dims, n_layers);
  if (p.smem_floats < 0 || 4LL * p.smem_floats > RES_SMEM_MAX || P < 1 || sms < 1) return -1;
  return (long long)resident_blocks(P, sms) * (p.n_params + 2);
}

// K1 on the weight-resident route: out (n_params + 2 floats) gets every dW_l
// and db_l in the flat order W0, b0, W1, b1, ... (torch layouts), then the
// loss inv_n * sum_{p < n_rows} s_p (MLP(x)_p - target_p)^2 (s_p = sw[p], or
// 1 when sw is null), then max_{p < n_rows} |MLP(x)_p|. w: [W0, b0, ...];
// act: the per-layer codes; omegas: one per hidden layer; sms: the device's
// SMs; work: siren_resident_work_floats floats. Two launches.
int siren_loss_grads_resident(const float* x, int P, int n_rows, const int* dims, int n_layers,
                              const int* act, const float* const* w, const float* omegas,
                              const float* target, const float* sw, float inv_n, int sms,
                              float* work, float* out, cudaStream_t stream) {
  const Plan pl = make_plan(dims, n_layers);
  if (pl.smem_floats < 0 || P < 1 || sms < 1) return -1;
  const long long smem = 4LL * pl.smem_floats;
  if (smem > RES_SMEM_MAX) return -1;
  const int bps = resident_blocks(P, sms);
  Args a{};
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
  a.bps = bps;
  a.two_inv_n = 2.f * inv_n;
  a.partial = work;
  LAUNCH_SMEM(siren_resident_kernel, bps, RES_NT, smem, stream)(pl, a);
  CHECK_LAUNCH();
  LAUNCH(slot_reduce_kernel, cdiv(pl.n_params + 2, 256), 256, stream)(
      work, bps, pl.n_params, inv_n, out);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
