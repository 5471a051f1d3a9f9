// Hand-written Hopper (sm_90a) batched K1-w: the 2-D directional ensemble's
// update, D stacked Sirens d0 -> 64 x NH -> 1 (sine hidden layers, one omega,
// a linear head) on one shared x, with sample weights, in one launch.
//
// Replaces the Pallas TPU kernel of
// mri_super_resolution_tpu/ops/pallas/siren_kernel.py under jax.vmap:
//   K1 siren_loss_grads (:518, pallas_call at :580) with sample_weights (the
//      weighted residual at :489-490), vmapped over the ensemble's three
//      gradient directions at pipelines/master2d.py:157: per slot, the loss
//      inv_n sum_{p < n_rows} s_p (MLP(x)_p - target_p)^2 and every dW, db.
// The route takes d0 of 1 to 4, every hidden width 64, 2 to 7 hidden layers
// (ops/siren_kernel.py's resident_tc_route); the ensemble's Siren is 2 ->
// 64x7 -> 1 (25,217 parameters), D = 3, P = 3,600 rows.
//
// What bounds it on an H100: neither the products nor the bytes. A call is
// 4.8 G bf16 products (the bf16x3 split of 1.6 GFLOP), 4.9 us on the tensor
// cores, and moves 0.7 MB. It is latency: a 32-row tile runs 14 dependent
// phases, and the slot's blocks have to be summed. The design:
//   1. Products on the tensor cores: forward, chain and dW as mma.sync
//      m16n8k16 bf16 with the bf16x3 split (hi hi + hi lo + lo hi, float32
//      sums; csrc/gemm3.cuh's order), the float32-faithful products of the
//      other tensor-core routes. Not wgmma: its M is 64 rows a warpgroup, and
//      a 64-row tile's stash (below) does not fit beside the weights; a
//      32-row tile is two m16 halves, which mma.sync takes, its fragments
//      staying in registers from the products through the epilogues. The
//      first layer (K = d0) is float32 FMA.
//   2. A block's weights arrive once, by cp.async.bulk on one mbarrier (each
//      of the 2L tensors' 16-byte aligned span, slots any stride apart),
//      into the part of shared memory the stash takes later; the block then
//      splits each 64 x 64 W into hi and lo bf16 planes in the swizzled
//      layout ldmatrix reads (16-byte chunk c of row r at c ^ (r % 8), every
//      ldmatrix conflict-free), the rest kept float32.
//   3. The stash keeps each hidden layer's input to the next layer as hi/lo
//      planes (the A operand of the forward and the B operand of dW) and its
//      factor F = omega cos(omega z) in float32, from one precise sincosf in
//      the forward (never fast math); the last hidden layer's activation and
//      factor stay in the registers of the warp that made them, through the
//      head. The backward calls no sincosf.
//   4. dW and db stay on chip: every 64 x 64 dW is split among the 8 warps
//      (16 outputs x 32 inputs each, 16 float32 a thread a layer, 96 at
//      NH = 7), accumulated in registers over the block's tiles; db, the
//      first and last layer's dW and the loss are summed over a warp's 16
//      rows from the float32 epilogue values by shuffles and kept in
//      registers too. A block writes them once, after its last tile.
//   5. One launch a call: a cooperative launch (every block resident), each
//      block's partial written once, a grid barrier (an integer arrival
//      counter, __threadfence, the counter reset and a generation bumped by
//      the last block to arrive), then every block sums its share of the
//      outputs over its slot's blocks in block order. No float atomics: a
//      call repeats bit for bit, a CUDA graph replay too. The counter is
//      left at 0 by every call: calls that share it run in stream order.
//   6. 32 rows in flight an SM, 8 warps on one tile: the forward and chain
//      as two m16 halves of 4 warps (16 columns each), dW as the whole tile.
//      Two 16-row tiles in separate warpgroups would each need their own dW
//      accumulators (192 registers a thread), so the tile is shared. The
//      grid covers D x tiles: 132 / D blocks a slot (44 at D = 3) walk its
//      113 tiles of 32 rows, 2.57 a block, at most 3 in turn.
// Shared-memory plan (bytes, ops/siren_kernel.py's resident_tc_smem_bytes;
// nhh = NH - 1 hidden-to-hidden layers): W hi/lo planes 16,384 a hidden W
// (nhh of them); W0 as 64 x 4 float32 (1,024); NH biases of 64 float32; the
// head's w and b (272); the stash, 16,384 a hidden layer but the last (hi/lo
// planes of 32 x 64, F as 32 x 64 float32); two delta buffers of hi/lo
// planes (16,384); the head's partial sums (512); the mbarrier (16). The
// ensemble's Siren (nhh = 6) needs 216,608 bytes: one block an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren_resident_tc.so siren_resident_tc.cu
//        (see ops/_build.py)

#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int RT_H = 64;       // every hidden width
constexpr int RT_ROWS = 32;    // rows a tile: two m16 halves
constexpr int RT_NT = 256;     // threads: 8 warps
constexpr int RT_MAX_HH = 6;   // hidden-to-hidden layers at most (7 hidden layers)
constexpr int RT_MAX_D0 = 4;   // input width at most
constexpr int RT_PLANE = RT_H * RT_H * 2;     // bytes of a 64 x 64 bf16 plane
constexpr int RT_TPLANE = RT_ROWS * RT_H * 2;  // bytes of a 32 x 64 bf16 plane
constexpr int RT_TF32 = RT_ROWS * RT_H * 4;    // bytes of a 32 x 64 float32 array
constexpr int RT_SMEM_MAX = 232448;            // an H100 block's opt-in shared memory
constexpr int RT_SCR = 4 * RT_H + 2 * RT_H * (RT_MAX_HH + 1);  // final-combine floats

// Where everything lives (bytes from the base of shared memory) and where
// each grad goes in a slot's output row, from nhh and d0 alone.
struct RtPlan {
  int nhh, d0;
  int w_pl;     // W_j hi plane at w_pl + (j - 1) * 2 * RT_PLANE, lo plane RT_PLANE on
  int w0;       // W0 as 64 x 4 float32
  int bias;     // b_j as 64 float32 at bias + 256 j, j = 0 .. nhh
  int wl, bl;   // the head's w (64) and b
  int stash;    // hidden layer j < nhh: hi plane, lo plane, F at stash + j * 16,384
  int delta;    // two delta buffers: hi plane, lo plane
  int headp;    // the head's partial sums: 4 x 32 float32
  int mbar;
  int smem;     // bytes
  // in a slot's output row (floats): W0, b0, W_1, b_1, ..., W_head, b_head, loss
  int o_b0, o_w1, o_wl, o_bl, n_params, n_out;
};

inline RtPlan rt_plan(int nhh, int d0) {
  RtPlan p{};
  p.nhh = nhh;
  p.d0 = d0;
  int at = 0;
  p.w_pl = at;
  at += nhh * 2 * RT_PLANE;
  p.w0 = at;
  at += RT_H * 4 * 4;
  p.bias = at;
  at += (nhh + 1) * RT_H * 4;
  p.wl = at;
  at += RT_H * 4;
  p.bl = at;
  at += 16;
  p.stash = at;
  at += nhh * (2 * RT_TPLANE + RT_TF32);
  p.delta = at;
  at += 2 * 2 * RT_TPLANE;
  p.headp = at;
  at += 4 * RT_ROWS * 4;
  p.mbar = at;
  at += 16;
  p.smem = at;
  p.o_b0 = RT_H * d0;
  p.o_w1 = p.o_b0 + RT_H;
  p.o_wl = p.o_w1 + nhh * (RT_H * RT_H + RT_H);
  p.o_bl = p.o_wl + RT_H;
  p.n_params = p.o_bl + 1;
  p.n_out = p.n_params + 1;
  return p;
}

// The widths this kernel takes: dims = (d0, 64 x (nhh + 1), 1); -1 if not.
inline int rt_nhh(const int* dims, int n_layers) {
  if (n_layers < 3 || n_layers > RT_MAX_HH + 2 || dims[0] < 1 || dims[0] > RT_MAX_D0 ||
      dims[n_layers] != 1)
    return -1;
  for (int l = 1; l < n_layers; ++l)
    if (dims[l] != RT_H) return -1;
  return n_layers - 2;
}

// What a launch reads and writes.
struct RtArgs {
  const float* x;
  const float* target;  // (slots, P): this launch's first slot
  const float* sw;      // the same, or null
  const float* w[2 * (RT_MAX_HH + 2)];  // [W0, b0, ..., W_head, b_head] of this launch's slot 0
  long long w_slot[2 * (RT_MAX_HH + 2)];  // floats between two slots' copies
  float omega, two_inv_n, inv_n;
  int P, n_rows, bps;  // bps: blocks a slot; block i works for slot i / bps
  float* partial;      // gridDim.x rows of n_out floats
  float* out;          // this launch's slot 0's output row
  long long out_stride;
  unsigned* sync;      // the grid barrier's counter and generation (left 0, g)
};

// byte offset of bf16 element (r, c) of a swizzled plane of 64-wide rows
__device__ __forceinline__ int pl_at(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}
// byte offset of the 16-byte chunk ch of row r of such a plane (ldmatrix rows)
__device__ __forceinline__ int pl_row(int r, int ch) { return r * 128 + (((ch ^ r) & 7) << 4); }
// byte offset of float32 element (r, c) of a swizzled 32 x 64 array (chunks of 4)
__device__ __forceinline__ int f_at(int r, int c) {
  return r * 256 + ((((c >> 2) ^ r) & 7) | ((c >> 2) & 8)) * 16 + (c & 3) * 4;
}

__device__ __forceinline__ void st_split(unsigned char* hi, unsigned char* lo, int off, float v0,
                                         float v1) {
  const unsigned h = bf16x2_rn(v0, v1);
  const unsigned l = bf16x2_rn(v0 - bf16_to_f32(h & 0xffffu), v1 - bf16_to_f32(h >> 16));
  *reinterpret_cast<unsigned*>(hi + off) = h;
  *reinterpret_cast<unsigned*>(lo + off) = l;
}

// acc (16 rows x 16 columns, two m16n8 tiles) += A B with bf16x3 products:
// A 16 x 64 rows ar0 .. of planes (ahi, alo), depth along the row; B's 16
// columns as rows bc0 .. of planes (bhi, blo) (trans = 0: depth along the
// row, as W for the forward) or as columns bc0 .. of depth-rows (trans = 1,
// as W for the chain)
template <int TRANS_B>
__device__ __forceinline__ void mma_16x16x64(float (&acc)[2][4], const unsigned char* ahi,
                                             const unsigned char* alo, int ar0,
                                             const unsigned char* bhi, const unsigned char* blo,
                                             int bc0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    unsigned ah[4], al[4], bh[4], bl[4];
    const int ao = pl_row(ar0 + (lane & 15), 2 * ks + (lane >> 4));
    ldsm_x4(ah, ahi + ao);
    ldsm_x4(al, alo + ao);
    if (TRANS_B) {
      const int bo = pl_row(16 * ks + (q & 1) * 8 + (lane & 7), (bc0 >> 3) + (q >> 1));
      ldsm_x4_trans(bh, bhi + bo);
      ldsm_x4_trans(bl, blo + bo);
    } else {
      const int bo = pl_row(bc0 + (q >> 1) * 8 + (lane & 7), 2 * ks + (q & 1));
      ldsm_x4(bh, bhi + bo);
      ldsm_x4(bl, blo + bo);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const unsigned b_h[2] = {bh[2 * nt], bh[2 * nt + 1]};
      const unsigned b_l[2] = {bl[2 * nt], bl[2 * nt + 1]};
      mma_bf16(acc[nt], ah, b_l);
      mma_bf16(acc[nt], al, b_h);
      mma_bf16(acc[nt], ah, b_h);
    }
  }
}

// v[i] summed over the warp's 8 row groups (lane / 4); lane (g < 4, t)
// returns v[g]: the column 8 (g / 2) + 2 t + g % 2 of the warp's 16
__device__ __forceinline__ float keep_col_sum(float (&v)[4]) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  const int g = (threadIdx.x & 31) >> 2;
  return g == 0 ? v[0] : g == 1 ? v[1] : g == 2 ? v[2] : g == 3 ? v[3] : 0.f;
}

// The grid barrier of a cooperative launch: sync[0] counts arrivals, sync[1]
// is the generation; the last block to arrive resets the count and bumps
// the generation, the others poll it.
__device__ __forceinline__ void grid_barrier(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g0 = *gen;
    __threadfence();  // this block's partial before its arrival
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicExch(sync + 1, g0 + 1u);
    } else {
      while (*gen == g0) spin_pause();
    }
    __threadfence();  // the others' partials after the barrier
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RT_NT, 1) siren_rtc_kernel(RtPlan pl, RtArgs a) {
#ifdef __CUDACC__
  extern __shared__ __align__(128) unsigned char sm[];
#else
  unsigned char* sm = static_cast<unsigned char*>(emu_block_shared(RT_SMEM_MAX));
#endif
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nhh = pl.nhh, d0 = pl.d0, L = nhh + 2;
  const int slot = blockIdx.x / a.bps, blk = blockIdx.x - slot * a.bps;
  const float* target = a.target + (long long)slot * a.P;
  const float* sw = a.sw != nullptr ? a.sw + (long long)slot * a.P : nullptr;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + pl.mbar);

  // ---- the slot's weights: one bulk copy a tensor into the stash's room ----
  // tensor i (W_l at i = 2 l, b_l at 2 l + 1) is copied as its 16-byte
  // aligned span to the next 16-byte aligned offset; returns where its first
  // float landed, advancing at
  auto staged = [&](int i, int& at, const char*& src, unsigned& bytes) {
    const int l = i >> 1;
    const bool head = l == L - 1;
    const int n = (i & 1) ? (head ? 1 : RT_H) : head ? RT_H : l == 0 ? RT_H * d0 : RT_H * RT_H;
    const uintptr_t p = reinterpret_cast<uintptr_t>(a.w[i] + slot * a.w_slot[i]);
    const uintptr_t p0 = p & ~uintptr_t(15), p1 = (p + 4u * n + 15) & ~uintptr_t(15);
    src = reinterpret_cast<const char*>(p0);
    bytes = (unsigned)(p1 - p0);
    const int data = at + (int)(p - p0);
    at += (int)bytes;
    return data;
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    int at = pl.stash;
    const char* src;
    unsigned bytes, total = 0;
    for (int i = 0; i < 2 * L; ++i) {
      staged(i, at, src, bytes);
      total += bytes;
    }
    mbar_arrive_expect_tx(bar, total);
    at = pl.stash;
    for (int i = 0; i < 2 * L; ++i) {
      const int to = at;
      staged(i, at, src, bytes);
      bulk_load(sm + to, src, bytes, bar);
    }
  }
  mbar_wait(bar, 0);
  {  // out of the staging room: W_1 .. W_nhh as hi/lo planes, the rest float32
    int at = pl.stash;
    const char* src;
    unsigned bytes;
    for (int i = 0; i < 2 * L; ++i) {
      const float* v = reinterpret_cast<const float*>(sm + staged(i, at, src, bytes));
      const int l = i >> 1;
      if (i & 1) {  // b_l: 64 floats, or the head's one
        float* dst = reinterpret_cast<float*>(sm + (l == L - 1 ? pl.bl : pl.bias + 4 * RT_H * l));
        for (int e = tid; e < (l == L - 1 ? 1 : RT_H); e += RT_NT) dst[e] = v[e];
      } else if (l == 0) {  // W0 (64 x d0) as 64 x 4, zero-padded
        for (int e = tid; e < RT_H * 4; e += RT_NT) {
          const int k = e & 3;
          reinterpret_cast<float*>(sm + pl.w0)[e] = k < d0 ? v[(e >> 2) * d0 + k] : 0.f;
        }
      } else if (l == L - 1) {  // the head's w
        for (int e = tid; e < RT_H; e += RT_NT) reinterpret_cast<float*>(sm + pl.wl)[e] = v[e];
      } else {
        unsigned char* hi = sm + pl.w_pl + (l - 1) * 2 * RT_PLANE;
        for (int e = tid; e < RT_H * RT_H / 2; e += RT_NT) {
          const int r = e >> 5, c = 2 * (e & 31);
          st_split(hi, hi + RT_PLANE, pl_at(r, c), v[r * RT_H + c], v[r * RT_H + c + 1]);
        }
      }
    }
  }
  __syncthreads();  // the planes are in; the staging room is the stash's again

  const float* W0 = reinterpret_cast<const float*>(sm + pl.w0);
  const float* bias = reinterpret_cast<const float*>(sm + pl.bias);
  const float* wl = reinterpret_cast<const float*>(sm + pl.wl);
  const float bl = *reinterpret_cast<const float*>(sm + pl.bl);
  float* headp = reinterpret_cast<float*>(sm + pl.headp);
  auto whi = [&](int j) { return sm + pl.w_pl + (j - 1) * 2 * RT_PLANE; };
  auto ahi = [&](int j) { return sm + pl.stash + j * (2 * RT_TPLANE + RT_TF32); };
  auto fst = [&](int j) { return ahi(j) + 2 * RT_TPLANE; };
  auto dhi = [&](int j) { return sm + pl.delta + (j & 1) * 2 * RT_TPLANE; };

  // forward/chain: warp (h, cq) takes rows 16 h .. of the tile and columns
  // 16 cq ..; this thread rows ra = 16 h + g, ra + 8, columns c0 + 8 nt + e
  const int h = warp >> 2, cq = warp & 3, ra = 16 * h + g, c0 = 16 * cq + 2 * t;
  // dW: warp w takes outputs 16 (w / 2) .. and inputs 32 (w % 2) ..
  const int mt = warp >> 1, nh = warp & 1;

  float dw[RT_MAX_HH][4][4];
#pragma unroll
  for (int j = 0; j < RT_MAX_HH; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[j][i][e] = 0.f;
  float db[RT_MAX_HH + 1], dw0[2] = {0.f, 0.f}, dwl = 0.f, dbl = 0.f, loss = 0.f;
#pragma unroll
  for (int j = 0; j <= RT_MAX_HH; ++j) db[j] = 0.f;

  const int n_tiles = (a.P + RT_ROWS - 1) / RT_ROWS;
  for (int tile = blk; tile < n_tiles; tile += a.bps) {
    const int r0 = tile * RT_ROWS;
    float xa[RT_MAX_D0], xb[RT_MAX_D0];
#pragma unroll
    for (int k = 0; k < RT_MAX_D0; ++k) {
      xa[k] = k < d0 && r0 + ra < a.P ? a.x[(long long)(r0 + ra) * d0 + k] : 0.f;
      xb[k] = k < d0 && r0 + ra + 8 < a.P ? a.x[(long long)(r0 + ra + 8) * d0 + k] : 0.f;
    }
    // the last hidden layer's activation and factor, this thread's 8 values
    float al[2][4], fl[2][4];
    // layer 0: float32 FMA over d0
    {
      float z[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * nt + e;
          float sa = bias[c], sb = bias[c];
#pragma unroll
          for (int k = 0; k < RT_MAX_D0; ++k) {
            sa = fmaf(xa[k], W0[4 * c + k], sa);
            sb = fmaf(xb[k], W0[4 * c + k], sb);
          }
          z[nt][e] = sa;
          z[nt][2 + e] = sb;
        }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float s[4], f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float cs;
          sincosf(a.omega * z[nt][i], &s[i], &cs);
          f[i] = a.omega * cs;
        }
        const int c = c0 + 8 * nt;
        st_split(ahi(0), ahi(0) + RT_TPLANE, pl_at(ra, c), s[0], s[1]);
        st_split(ahi(0), ahi(0) + RT_TPLANE, pl_at(ra + 8, c), s[2], s[3]);
        *reinterpret_cast<float2*>(fst(0) + f_at(ra, c)) = make_float2(f[0], f[1]);
        *reinterpret_cast<float2*>(fst(0) + f_at(ra + 8, c)) = make_float2(f[2], f[3]);
      }
    }
    __syncthreads();
    // hidden layers 1 .. nhh on the tensor cores
#pragma unroll
    for (int j = 1; j <= RT_MAX_HH; ++j) {
      if (j > nhh) break;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      mma_16x16x64<0>(acc, ahi(j - 1), ahi(j - 1) + RT_TPLANE, 16 * h, whi(j),
                      whi(j) + RT_PLANE, 16 * cq);
      float s[2][4], f[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float cs;
          sincosf(a.omega * (acc[nt][i] + bias[RT_H * j + c0 + 8 * nt + (i & 1)]), &s[nt][i], &cs);
          f[nt][i] = a.omega * cs;
        }
      if (j < nhh) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = c0 + 8 * nt;
          st_split(ahi(j), ahi(j) + RT_TPLANE, pl_at(ra, c), s[nt][0], s[nt][1]);
          st_split(ahi(j), ahi(j) + RT_TPLANE, pl_at(ra + 8, c), s[nt][2], s[nt][3]);
          *reinterpret_cast<float2*>(fst(j) + f_at(ra, c)) = make_float2(f[nt][0], f[nt][1]);
          *reinterpret_cast<float2*>(fst(j) + f_at(ra + 8, c)) = make_float2(f[nt][2], f[nt][3]);
        }
      } else {  // the last hidden layer: kept, and the head's partial sums
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            al[nt][i] = s[nt][i];
            fl[nt][i] = f[nt][i];
            const float w = wl[c0 + 8 * nt + (i & 1)];
            if (i < 2) {
              pa = fmaf(s[nt][i], w, pa);
            } else {
              pb = fmaf(s[nt][i], w, pb);
            }
          }
        pa += __shfl_xor_sync(0xffffffffu, pa, 1);
        pb += __shfl_xor_sync(0xffffffffu, pb, 1);
        pa += __shfl_xor_sync(0xffffffffu, pa, 2);
        pb += __shfl_xor_sync(0xffffffffu, pb, 2);
        if (t == 0) {
          headp[cq * RT_ROWS + ra] = pa;
          headp[cq * RT_ROWS + ra + 8] = pb;
        }
      }
      __syncthreads();
    }
    // the head: out, the (weighted, masked) residual, its delta; the last
    // layer's dW and db, the last hidden layer's delta and db
    {
      float dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = ra + 8 * hh, row = r0 + r;
        const float out =
            ((headp[r] + headp[RT_ROWS + r]) + (headp[2 * RT_ROWS + r] + headp[3 * RT_ROWS + r])) +
            bl;
        const bool real = row < a.n_rows;
        const float res = real ? out - target[row] : 0.f;
        const float wr = (sw != nullptr && real) ? sw[row] * res : res;
        dl[hh] = a.two_inv_n * wr;
        if (cq == 0 && t == 0) loss += wr * res;
      }
      if (cq == 0) {
        float s = dl[0] + dl[1];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) dbl += s;
      }
      float v[4], u[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[2 * nt + e] = fmaf(dl[1], al[nt][2 + e], dl[0] * al[nt][e]);
          const float w = wl[c0 + 8 * nt + e];
          const float d_a = dl[0] * w * fl[nt][e], d_b = dl[1] * w * fl[nt][2 + e];
          al[nt][e] = d_a;  // al now holds the last hidden layer's delta
          al[nt][2 + e] = d_b;
          u[2 * nt + e] = d_a + d_b;
        }
      dwl += keep_col_sum(v);
      const float dbs = keep_col_sum(u);
#pragma unroll
      for (int j = 1; j <= RT_MAX_HH; ++j)
        if (j == nhh) db[j] += dbs;
      unsigned char* d = dhi(nhh);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = c0 + 8 * nt;
        st_split(d, d + RT_TPLANE, pl_at(ra, c), al[nt][0], al[nt][1]);
        st_split(d, d + RT_TPLANE, pl_at(ra + 8, c), al[nt][2], al[nt][3]);
      }
    }
    __syncthreads();
    // the backward through hidden layers nhh .. 1: dW_j += delta_j^T a_{j-1},
    // delta_{j-1} = (delta_j W_j) * F_{j-1}
#pragma unroll
    for (int j = RT_MAX_HH; j >= 1; --j) {
      if (j > nhh) continue;
      const unsigned char* d = dhi(j);
      const unsigned char* ain = ahi(j - 1);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int q = lane >> 3;
        unsigned ah[4], alo[4];
        const int ao = pl_row(16 * ks + (q >> 1) * 8 + (lane & 7), 2 * mt + (q & 1));
        ldsm_x4_trans(ah, d + ao);
        ldsm_x4_trans(alo, d + RT_TPLANE + ao);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          unsigned bh[4], bl4[4];
          const int bo = pl_row(16 * ks + (q & 1) * 8 + (lane & 7), 4 * nh + 2 * jj + (q >> 1));
          ldsm_x4_trans(bh, ain + bo);
          ldsm_x4_trans(bl4, ain + RT_TPLANE + bo);
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            const unsigned b_h[2] = {bh[2 * n2], bh[2 * n2 + 1]};
            const unsigned b_l[2] = {bl4[2 * n2], bl4[2 * n2 + 1]};
            float* c = dw[j - 1][2 * jj + n2];
            mma_bf16(c, ah, b_l);
            mma_bf16(c, alo, b_h);
            mma_bf16(c, ah, b_h);
          }
        }
      }
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      mma_16x16x64<1>(acc, d, d + RT_TPLANE, 16 * h, whi(j), whi(j) + RT_PLANE, 16 * cq);
      float u[4];
      unsigned char* dn = dhi(j - 1);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = c0 + 8 * nt;
        const float2 fa = *reinterpret_cast<const float2*>(fst(j - 1) + f_at(ra, c));
        const float2 fb = *reinterpret_cast<const float2*>(fst(j - 1) + f_at(ra + 8, c));
        acc[nt][0] *= fa.x;
        acc[nt][1] *= fa.y;
        acc[nt][2] *= fb.x;
        acc[nt][3] *= fb.y;
        st_split(dn, dn + RT_TPLANE, pl_at(ra, c), acc[nt][0], acc[nt][1]);
        st_split(dn, dn + RT_TPLANE, pl_at(ra + 8, c), acc[nt][2], acc[nt][3]);
        u[2 * nt] = acc[nt][0] + acc[nt][2];
        u[2 * nt + 1] = acc[nt][1] + acc[nt][3];
      }
      if (j == 1) {  // the first layer's dW over d0 inputs, from delta_0
        float v[4][RT_MAX_D0];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < RT_MAX_D0; ++k)
            v[i][k] = fmaf(acc[i >> 1][2 + (i & 1)], xb[k], acc[i >> 1][i & 1] * xa[k]);
        // summed over the 8 row groups; lane g keeps v[(2g) / 4][(2g) % 4] and the next
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < RT_MAX_D0; ++k) v[i][k] += __shfl_xor_sync(0xffffffffu, v[i][k], o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((g >> 1) == i) {
            dw0[0] += (g & 1) ? v[i][2] : v[i][0];
            dw0[1] += (g & 1) ? v[i][3] : v[i][1];
          }
      }
      db[j - 1] += keep_col_sum(u);
      __syncthreads();
    }
  }

  // ---- this block's partial, written once --------------------------------
  float* part = a.partial + (long long)blockIdx.x * pl.n_out;
#pragma unroll
  for (int j = 1; j <= RT_MAX_HH; ++j) {
    if (j > nhh) break;
    float* W = part + pl.o_w1 + (j - 1) * (RT_H * RT_H + RT_H);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 16 * mt + g + 8 * (e >> 1), in = 32 * nh + 8 * i + 2 * t + (e & 1);
        W[o * RT_H + in] = dw[j - 1][i][e];
      }
  }
  // the values split over the two halves: half 1 through shared memory
  // (the stash's room), then half 0 adds its own, in that order
  float* scr = reinterpret_cast<float*>(sm + pl.stash);
  const int ck = 16 * cq + 8 * (g >> 1) + 2 * t + (g & 1);  // this lane's kept column (g < 4)
  auto each_kept = [&](auto put) {
    if (g < 4) {
#pragma unroll
      for (int j = 0; j <= RT_MAX_HH; ++j) {
        const int o_b = j == 0 ? pl.o_b0 : pl.o_w1 + (j - 1) * (RT_H * RT_H + RT_H) + RT_H * RT_H;
        if (j <= nhh) put(j * RT_H + ck, o_b + ck, db[j]);
      }
      put((RT_MAX_HH + 1) * RT_H + ck, pl.o_wl + ck, dwl);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {  // dW0: column c, input 2 (g % 2) + m
      const int c = 16 * cq + 8 * (g >> 2) + 2 * t + ((g >> 1) & 1), k = 2 * (g & 1) + m;
      if (k < d0) put((RT_MAX_HH + 2) * RT_H + 4 * c + k, c * d0 + k, dw0[m]);
    }
    if (cq == 0 && lane == 0) {
      put(RT_SCR - 2, pl.o_bl, dbl);
      put(RT_SCR - 1, pl.n_params, loss);
    }
  };
  // the loss over the warp's 16 rows (lanes t = 0 hold it)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) loss += __shfl_xor_sync(0xffffffffu, loss, o);
  if (h == 1) each_kept([&](int s, int, float v) { scr[s] = v; });
  __syncthreads();
  if (h == 0) each_kept([&](int s, int o, float v) { part[o] = v + scr[s]; });

  // ---- every block's partial in: sum each slot's blocks in block order -----
  grid_barrier(a.sync);
  const long long total = (long long)(gridDim.x / a.bps) * pl.n_out;
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  const long long e1 = min(total, per * (blockIdx.x + 1));
  for (long long e = per * blockIdx.x + tid; e < e1; e += RT_NT) {
    const int s = (int)(e / pl.n_out), i = (int)(e - (long long)s * pl.n_out);
    const float* p = a.partial + (long long)s * a.bps * pl.n_out + i;
    float v = 0.f;
    for (int b = 0; b < a.bps; ++b) v += p[(long long)b * pl.n_out];
    a.out[s * a.out_stride + i] = i == pl.n_params ? v * a.inv_n : v;
  }
}

}  // namespace

extern "C" {

// Shared memory a block takes at these widths (dims: n_layers + 1 widths),
// or -1 when the kernel does not take them.
long long siren_rtc_smem_bytes(const int* dims, int n_layers) {
  const int nhh = rt_nhh(dims, n_layers);
  return nhh < 0 ? -1 : rt_plan(nhh, dims[0]).smem;
}

// Once a device, before its first launch: the kernel's opt-in shared memory.
int siren_rtc_setup() {
#ifdef __CUDACC__
  return (int)cudaFuncSetAttribute(siren_rtc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   RT_SMEM_MAX);
#else
  return 0;
#endif
}

// Blocks a slot for D slots of P rows on sms SMs (a launch takes at most sms
// slots, each sms / slots blocks, at most a slot's tiles), and the floats of
// partial workspace a call needs (one launch's blocks' rows); -1 if the
// kernel does not take the widths.
long long siren_rtc_work_floats(int P, const int* dims, int n_layers, int D, int sms) {
  const int nhh = rt_nhh(dims, n_layers);
  if (nhh < 0 || P < 1 || D < 1 || sms < 1) return -1;
  const int slots = D < sms ? D : sms;
  const int tiles = cdiv(P, RT_ROWS);
  const int bps = sms / slots < tiles ? sms / slots : tiles;
  return (long long)slots * bps * rt_plan(nhh, dims[0]).n_out;
}

// The batched K1-w over D stacked MLPs that share x (P, d0): slot s's
// tensors are w[i] + s w_slot[i] (floats; w: [W0, b0, ..., W_head, b_head]
// of slot 0, each slot's copy contiguous), its targets and sample weights
// (D, P, 1) rows s (sw may be null); out (D rows, out_stride floats apart)
// gets slot s's dW and db in the flat order W0, b0, W1, b1, ... (torch
// layouts), then its loss. sync: two unsigned, 0 before the first call (each
// call leaves the count 0). One cooperative launch a sms slots; nothing
// else runs. Returns a cudaError_t, or -1 for widths the kernel does not
// take.
int siren_loss_grads_rtc(const float* x, int P, int n_rows, const int* dims, int n_layers, int D,
                         const float* const* w, const long long* w_slot, float omega,
                         const float* target, const float* sw, float inv_n, int sms,
                         float* work, unsigned* sync, float* out, long long out_stride,
                         cudaStream_t stream) {
  const int nhh = rt_nhh(dims, n_layers);
  if (nhh < 0 || P < 1 || D < 1 || sms < 1 || n_rows < 1 || n_rows > P) return -1;
  const RtPlan pl = rt_plan(nhh, dims[0]);
  const int tiles = cdiv(P, RT_ROWS);
  for (int s0 = 0; s0 < D; s0 += sms) {
    const int slots = D - s0 < sms ? D - s0 : sms;
    RtArgs a{};
    a.x = x;
    a.target = target + (long long)s0 * P;
    a.sw = sw != nullptr ? sw + (long long)s0 * P : nullptr;
    for (int i = 0; i < 2 * n_layers; ++i) {
      a.w[i] = w[i] + s0 * w_slot[i];
      a.w_slot[i] = w_slot[i];
    }
    a.omega = omega;
    a.two_inv_n = 2.f * inv_n;
    a.inv_n = inv_n;
    a.P = P;
    a.n_rows = n_rows;
    a.bps = sms / slots < tiles ? sms / slots : tiles;
    a.partial = work;
    a.out = out + s0 * out_stride;
    a.out_stride = out_stride;
    a.sync = sync;
    const int e = (int)LAUNCH_COOP(siren_rtc_kernel, slots * a.bps, RT_NT, pl.smem, stream, pl, a);
    if (e != 0) return e;
  }
  return 0;
}

}  // extern "C"
