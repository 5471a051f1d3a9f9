// Hand-written Hopper (sm_90a) kernels K6 and K7 for the RAMS convolutions.
//
// K6 replaces conv3d_rfab of mri_super_resolution_tpu/ops/pallas/conv3d_kernel.py
// (def :109, pallas_call :133, body :74-104): a 3x3x3 convolution plus bias on
// channels-last (B, H, W, T, C) activations, SAME (zero padding of 1 in H, W
// and T) or VALID, with the kernel (3, 3, 3, C, Cout) in spatial order
// (H, W, T). K7 replaces conv3d_rfab_bwd of the same file (def :234,
// pallas_call :259, body :169-229): given the cotangent g of K6's output it
// returns dx (in x's type), dW (3, 3, 3, C, Cout) and db (Cout,) in float32.
//
// Contract of the entry points (the wrapper in ops/conv3d_kernel.py checks
// it before calling):
//   * x, w, g, out and dx share one type, bfloat16 (as its 16-bit patterns)
//     or float32; bias is float32 (Cout,); all row-major and contiguous, x,
//     w, g, out and dx 16-byte aligned;
//   * C and Cout are multiples of 8 (the gate of models/rams.py:123-128); in
//     bfloat16 the channels that the convolution sums over (C forward, Cout
//     for K7's dx) are at most 64, so that the whole kernel stays in shared
//     memory;
//   * each product is formed in float32 from the stored values and summed in
//     float32; the float32 bias is added last and the result rounded once
//     to the output type (to nearest even for bfloat16);
//   * one launch sequence on the caller's stream; nothing allocates or
//     synchronises; each entry point returns cudaGetLastError() (0 on
//     success), -1 for a call it does not take.
//
// What bounds them on an H100: operations. The RAMS serving call (25 x 130 x
// 130 x 9 outputs, C = Cout = 32) is 210 GFLOP against 0.49 GB of
// compulsory traffic in bfloat16: 0.21 ms at the 989 TFLOP/s bf16
// tensor-core rate, 0.15 ms at 3.35 TB/s. K7 at the training path's main
// call (32 x 34 x 34 x 9, C = Cout = 32): dx and dW each repeat the
// forward's 18.4 GFLOP, 0.037 ms for the two at 989 TFLOP/s.
//
// bfloat16 (every main path: RAMSConfig.compute_dtype is "bfloat16") runs on
// the tensor cores as an implicit GEMM, M = output pixels. The forward at C
// = Cout = 32 (every RAMS call, serving and training: ops/conv3d_kernel.py's
// wg_route) runs conv3d_wg_kernel on wgmma; other widths and K7's dx run
// conv3d_tc_kernel on mma.sync m16n8k16 (N = Cout, K = 27 C), float32
// accumulators in both (csrc/tensor_core.cuh).
//   * K6 on wgmma (conv3d_wg_kernel): the three temporal taps side by side,
//     N = 3 Cout = 96: for each input t-plane and spatial tap (dy, dx), B is
//     [W(dy, dx, 0) | W(dy, dx, 1) | W(dy, dx, 2)] and A the plane's
//     flat-plane rows (below) shifted by dy wq + dx, so each input plane is
//     read from shared memory once, not three times. Per m64 x k16 step A is
//     2 KB and B 3 KB of shared-memory reads (40 clocks at 128 B/clock)
//     against 48 clocks of tensor work: the tensor cores bound the products.
//     The accumulator's three 32-column blocks hold t_out, t_out - 1 and
//     t_out - 2; after each plane the finished one is stored and the other
//     two move up a block (32 register moves a thread a plane). A persistent
//     block an SM walks units of (b, strip of at most 44 columns, tile of 256
//     rows) with all To outputs of a unit; a producer thread keeps a ring of
//     plane halos in flight with TMA (per 8-channel chunk, the whole padded
//     image rows the halo spans, each chunk a run of rows 16 bytes apart, so
//     that the unswizzled wgmma descriptor can start at any row; zero fill
//     at the SAME border), four consumer warpgroups each run one m64 tile as
//     one commit group of 18 m64n96k16 a plane and store the block the plane
//     before finished (float32 bias, one round-to-nearest bf16, 4-byte
//     stores) while it runs. The kernel (55,296 B, 64-byte swizzled K-major)
//     is staged once a block. The sums run in conv3d_tc_kernel's order (for
//     each output dz 0, 1, 2; in a plane tap by tap, then k16 by k16), and on
//     an H100 the
//     two kernels' outputs are equal bit for bit. What bounds it there: the
//     halo loads (the products alone, loads cut, ran at 1.38x the bound, the
//     kernel at about 1.8x): narrower strips cut the halo rows a unit loads
//     (522 for 256 outputs at 130 columns, 350 at 44), TMA cut them further.
//   * Flat-plane tiles (the TPU kernel's idea, :10-22): the output plane is
//     cut into strips of sw columns (all of Wo when the strip's halo fits in
//     shared memory, as at every path shape) and each strip flattened with
//     row r = y * wq + x over its padded width wq = sw + 2. Tap (dy, dx) of
//     output row r is input row r + dy wq + dx, so a tile of TM = 256 rows
//     reads one contiguous run of TM + 2 wq + 2 input rows of each t-plane;
//     the 2 columns past sw of each image row are computed and not stored.
//     Computed rows per output pixel: 130 x 132 rows in 68 tiles for 130 x
//     130 (1.03x) at serving, 34 x 36 in 5 tiles for 34 x 34 (1.11x) at
//     training.
//   * K6 on mma.sync (conv3d_tc_kernel): a block owns one (b, strip, tile,
//     32 output channels) and
//     walks a run of t_out (all of To at serving; runs of 3 at training,
//     toward three waves of blocks). The whole kernel, transposed to rows of
//     27 Cp values per output channel (Cp = C rounded up to 16,
//     zero-padded), is staged once per block while the first planes are in
//     flight, 16 bytes a load (2-byte loads made K6 1.5x slower at the
//     training shape on an H100); a ring of three input t-planes (the tile's halo
//     rows, 16-byte cp.async with zero fill for the SAME border and the K
//     padding) holds planes t, t+1, t+2, and plane t+3 is copied into t's
//     slot while the products of planes t+1 and t+2 run. Absent planes (the
//     SAME border in t) are neither copied nor multiplied. 8 warps, each 32
//     rows x 32 output channels (2 x 4 mma tiles, 32 float32 sums a
//     thread); A and B fragments come from ldmatrix, one k16 step ahead of
//     its mma (Cp is a template argument, so every loop over taps and
//     channels is unrolled); shared rows are padded by 16 bytes so that
//     each 8-row matrix hits all 32 banks. Shared memory at C = 32: 55,808 B
//     of weights + 3 x 42,080 B of planes (wq 132) = 182,048 B, one block per
//     SM; 106 registers at Cp 32 and 64, 110 at 48, 112 at 16, no spill
//     (ptxas -v, CUDA 12.8). The epilogue adds the float32 bias and rounds
//     once to bfloat16 by hand; the accumulator layout gives each thread two
//     adjacent output channels, stored as one 4-byte word.
//   * K7's dx is K6's kernel on g with the flipped, in/out-transposed kernel
//     (W'[tap][c][co] = W[26 - tap][co][c], staged so), padded by 1 for a
//     SAME forward and by 2 for a VALID one, with no bias.
//   * K7's dW: dW[tap][c][co] = sum over output pixels p of x[p + off(tap)]
//     [c] g[p][co], a product whose depth is pixels. A block owns one dz, 32
//     input and 32 output channels and a run of work items, each one (b,
//     t_out, strip, tile of 256 rows); it double-buffers the item's input
//     halo (one t-plane) and g rows in shared memory by cp.async, in the
//     global layout [pixel][channel]. A tap's shift dy wq + dx is odd for
//     half the taps, so a pixel pair of a fragment register is not a
//     4-byte word of shared memory: both fragments are read with
//     ldmatrix.trans, whose rows are pixels (16-byte aligned for any shift)
//     and which transposes on the way. 9 warps, one per (dy, dx), each 32 x
//     32 (c, co) of its tap: 32 float32 sums a thread, 96 registers, no
//     spill; two stages of (halo + 256) rows of 80 B, 93,760 B at the
//     training shape (wq 36), so two blocks per SM. The
//     g rows of the cropped columns and of the ragged last tile are
//     zero-filled, so they add nothing. db (the block with dz 1 and the
//     first input channels) is summed in float32 by all threads from the g
//     rows in shared memory, in a fixed order. Each block writes its sums to
//     its own slot of a workspace; a second pass adds the slots up in slot
//     order: no float atomics, so the results repeat bit for bit.
// float32 keeps the SIMT kernels (a tensor-core product has no float32
// operands): K6 a direct convolution, a block per (b, t_out, 16 x 32 tile,
// 32 output channels) with 8 x 8 float32 sums a thread (128 registers, 16
// bytes spilled); K7's dx that kernel flipped, its dW 72 float32 sums a
// thread over runs of 8 x 16 work items, reduced by slots as above. No main
// path runs float32.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv3d.so conv3d.cu   (see ops/_build.py)

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "launch.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

__host__ __device__ __forceinline__ int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// ---- float32: K6 and K7's dx on the SIMT cores ------------------------------

constexpr int TH = 16;   // output tile rows (8 per thread, 2 threads)
constexpr int TW = 32;   // output tile columns (one per lane)
constexpr int CK = 8;    // input channels per shared-memory chunk
constexpr int CO = 32;   // output channels per block (4 groups of 8)
constexpr int NT = 256;  // threads: 4 channel groups x 2 row halves x 32 columns
constexpr int HR = TH + 2;  // halo rows
constexpr int HC = TW + 2;  // halo columns
constexpr int HALO = 3 * HR * HC;        // halo pixels of one channel
constexpr int IN_FLOATS = CK * HALO;     // 14,688
constexpr int W_FLOATS = 27 * CK * CO;   // 6,912
constexpr int SMEM_BYTES = (IN_FLOATS + W_FLOATS) * 4;  // 86,400

struct alignas(16) Bits128 {
  unsigned a, b, c, d;
};

// eight consecutive float32 values (32 bytes, 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const Bits128 lo = reinterpret_cast<const Bits128*>(p)[0];
  const Bits128 hi = reinterpret_cast<const Bits128*>(p)[1];
  v[0] = u2f(lo.a), v[1] = u2f(lo.b), v[2] = u2f(lo.c), v[3] = u2f(lo.d);
  v[4] = u2f(hi.a), v[5] = u2f(hi.b), v[6] = u2f(hi.c), v[7] = u2f(hi.d);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<Bits128*>(p)[0] = {f2u(v[0]), f2u(v[1]), f2u(v[2]), f2u(v[3])};
  reinterpret_cast<Bits128*>(p)[1] = {f2u(v[4]), f2u(v[5]), f2u(v[6]), f2u(v[7])};
}

// Grid: x = output-channel block x tile row x tile column, y = t_out, z = b.
// flip = 0: w is (3, 3, 3, C, Cout). flip = 1 (K7's dx): w is a forward
// kernel (3, 3, 3, Cout, C), read as W'[tap][c][co] = w[26 - tap][co][c].
// bias may be null (no bias).
__global__ void __launch_bounds__(NT, 2) conv3d_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int Tin, int C, int Cout, int pad, int Ho,
    int Wo, int To, int tiles_w, int tiles_hw, int flip) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) float smem[];
#else
  alignas(16) __shared__ float smem[IN_FLOATS + W_FLOATS];
#endif
  float* s_in = smem;              // [CK][3][HR][HC]
  float* s_w = smem + IN_FLOATS;   // [27 taps][CK][CO]

  const int tid = threadIdx.x;
  const int grp = tid >> 6;         // output channels grp*8 .. grp*8+7 of the block
  const int ty = (tid >> 5) & 1;    // tile rows ty*8 .. ty*8+7
  const int tx = tid & 31;          // tile column
  int cell = blockIdx.x;
  const int co_blk = cell / tiles_hw;
  cell -= co_blk * tiles_hw;
  const int y0 = (cell / tiles_w) * TH;
  const int x0 = (cell % tiles_w) * TW;
  const int t = blockIdx.y;
  const long long b = blockIdx.z;
  const int co0 = co_blk * CO + grp * 8;
  const bool active = co0 < Cout;

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // every read of the previous chunk is done
    for (int i = tid; i < HALO; i += NT) {
      const int dz = i / (HR * HC);
      const int r = (i / HC) % HR;
      const int s = i % HC;
      const int ti = t + dz - pad;
      const int yi = y0 + r - pad;
      const int xi = x0 + s - pad;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ti >= 0 && ti < Tin && yi >= 0 && yi < H && xi >= 0 && xi < W)
        load8(x + (((b * H + yi) * W + xi) * Tin + ti) * C + c0, v);
#pragma unroll
      for (int k = 0; k < CK; ++k) s_in[k * HALO + i] = v[k];
    }
    for (int i = tid; i < W_FLOATS; i += NT) {
      const int col = i % CO;
      const int cl = (i / CO) % CK;
      const int tap = i / (CO * CK);
      const int co = co_blk * CO + col;
      const long long wi = flip ? ((long long)(26 - tap) * Cout + co) * C + c0 + cl
                                : ((long long)tap * C + c0 + cl) * Cout + co;
      s_w[i] = co < Cout ? w[wi] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int cl = 0; cl < CK; ++cl) {
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* ip = s_in + ((cl * 3 + dz) * HR + ty * 8) * HC + tx + dx;
            float col[10];
#pragma unroll
            for (int i = 0; i < 10; ++i) col[i] = ip[i * HC];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              // kernel tap (dy, dx, dz): w[dy][dx][dz][c][co]
              const float* wp = s_w + (((dy * 3 + dx) * 3 + dz) * CK + cl) * CO + grp * 8;
              float wv[8];
              load8(wp, wv);  // the same address across the warp: a broadcast
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int k = 0; k < 8; ++k) acc[j][k] += col[j + dy] * wv[k];
            }
          }
        }
      }
    }
  }
  if (!active) return;

  float bv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bv[k] = bias ? bias[co0 + k] : 0.f;
  const int ox = x0 + tx;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int oy = y0 + ty * 8 + j;
    if (oy < Ho && ox < Wo) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = acc[j][k] + bv[k];
      store8(out + (((b * Ho + oy) * Wo + ox) * To + t) * Cout + co0, v);
    }
  }
}

int launch_f32(const float* x, int B, int H, int W, int Tin, int C, const float* w,
               const float* bias, int Cout, int pad, int flip, float* out,
               cudaStream_t stream) {
  const int Ho = H + 2 * pad - 2;
  const int Wo = W + 2 * pad - 2;
  const int To = Tin + 2 * pad - 2;
  const int tiles_w = (Wo + TW - 1) / TW;
  const int tiles_hw = tiles_w * ((Ho + TH - 1) / TH);
  const dim3 grid(tiles_hw * ((Cout + CO - 1) / CO), To, B);
#ifdef __CUDACC__
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
#endif
  LAUNCH_SMEM(conv3d_kernel, grid, NT, SMEM_BYTES, stream)(
      x, w, bias, out, H, W, Tin, C, Cout, pad, Ho, Wo, To, tiles_w, tiles_hw, flip);
  return (int)cudaGetLastError();
}

// ---- float32: K7 dW and db on the SIMT cores ---------------------------------

constexpr int GH = 8;     // work-item rows of output pixels
constexpr int GW = 16;    // work-item columns
constexpr int GC = 32;    // input channels per block (one per lane)
constexpr int GCO = 32;   // output channels per block (4 groups of 8)
constexpr int GNT = 384;  // threads: 3 dz x 4 output groups x 32 input channels
constexpr int GHR = GH + 2;
constexpr int GHC = GW + 2;
constexpr int GX_FLOATS = 3 * GHR * GHC * GC;  // 17,280: the halo, channel-minor
constexpr int GG_FLOATS = GH * GW * GCO;       // 4,096: the g tile
constexpr int GSMEM_BYTES = (GX_FLOATS + GG_FLOATS) * 4;  // 85,504
constexpr int MAX_SPLITS = 264;  // workspace slots: two waves of 132 SMs

// Work items: (b, t_out, tile row, tile column) in that order; block x of
// the grid takes items [x * per_split, (x + 1) * per_split) and writes its
// sums to slot x of part: dW as (27, C, Cout) in (dy, dx, dz) tap order,
// then db (Cout,). Grid y = input-channel block x output-channel block.
__global__ void __launch_bounds__(GNT, 1) conv3d_wgrad_kernel(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ part, int H,
    int W, int Tin, int C, int Cout, int pad, int Ho, int Wo, int To, int tiles_w,
    int tiles_hw, int n_items, int per_split, int co_blocks) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) float smem[];
#else
  alignas(16) __shared__ float smem[GX_FLOATS + GG_FLOATS];
#endif
  float* s_x = smem;              // [3 dz][GHR][GHC][GC]
  float* s_g = smem + GX_FLOATS;  // [GH * GW pixels][GCO]

  const int tid = threadIdx.x;
  const int lane = tid & 31;       // input channel c0 + lane
  const int grp = (tid >> 5) & 3;  // output channels co0 .. co0 + 7
  const int dz = tid >> 7;         // the thread's temporal tap
  const int cb = blockIdx.y / co_blocks;
  const int cob = blockIdx.y - cb * co_blocks;
  const int c0 = cb * GC;
  const int ci = c0 + lane;
  const int co0 = cob * GCO + grp * 8;
  const bool active = ci < C && co0 < Cout;
  const bool db_lane = active && cb == 0 && lane == 0 && dz == 0;

  float acc[9][8];
  float dbacc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dbacc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[j][k] = 0.f;
  }

  const int first = blockIdx.x * per_split;
  const int last = min(first + per_split, n_items);
  for (int item = first; item < last; ++item) {
    const long long b = item / (To * tiles_hw);
    const int rem = item - (int)b * To * tiles_hw;
    const int t = rem / tiles_hw;
    const int cell = rem - t * tiles_hw;
    const int y0 = (cell / tiles_w) * GH;
    const int x0 = (cell % tiles_w) * GW;
    const int rows = min(GH, Ho - y0);
    const int cols = min(GW, Wo - x0);
    __syncthreads();  // every read of the previous item is done
    for (int i = tid; i < 3 * GHR * GHC * (GC / 8); i += GNT) {
      const int q = i % (GC / 8);
      const int pix = i / (GC / 8);
      const int zz = pix / (GHR * GHC);
      const int r = (pix / GHC) % GHR;
      const int s = pix % GHC;
      const int ti = t + zz - pad;
      const int yi = y0 + r - pad;
      const int xi = x0 + s - pad;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c0 + q * 8 < C && ti >= 0 && ti < Tin && yi >= 0 && yi < H && xi >= 0 && xi < W)
        load8(x + (((b * H + yi) * W + xi) * Tin + ti) * C + c0 + q * 8, v);
      store8(s_x + pix * GC + q * 8, v);
    }
    for (int i = tid; i < GH * GW * (GCO / 8); i += GNT) {
      const int q = i % (GCO / 8);
      const int p = i / (GCO / 8);
      const int oy = y0 + p / GW;
      const int ox = x0 + p % GW;
      const int co = cob * GCO + q * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (co < Cout && oy < Ho && ox < Wo)
        load8(g + (((b * Ho + oy) * Wo + ox) * To + t) * Cout + co, v);
      store8(s_g + p * GCO + q * 8, v);
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {
      for (int s = 0; s < cols; ++s) {
        float gv[8];
        load8(s_g + (r * GW + s) * GCO + grp * 8, gv);  // a broadcast
        // input pixel (y0 + r + dy - pad, x0 + s + dx - pad, t + dz - pad)
        const float* xp = s_x + ((dz * GHR + r) * GHC + s) * GC + lane;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float xv = xp[(dy * GHC + dx) * GC];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[dy * 3 + dx][k] += xv * gv[k];
          }
        }
        if (db_lane) {
#pragma unroll
          for (int k = 0; k < 8; ++k) dbacc[k] += gv[k];
        }
      }
    }
  }
  if (!active) return;
  float* slot = part + (long long)blockIdx.x * (27LL * C * Cout + Cout);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      store8(slot + ((long long)((dy * 3 + dx) * 3 + dz) * C + ci) * Cout + co0,
             acc[dy * 3 + dx]);
  if (db_lane) store8(slot + 27LL * C * Cout + co0, dbacc);
}

// dW and db = the sum of the n_slots workspace slots, in slot order.
__global__ void conv3d_wgrad_reduce(const float* __restrict__ part, int n_slots, int n_w,
                                    int Cout, float* __restrict__ dw,
                                    float* __restrict__ db) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int n = n_w + Cout;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_slots; ++k) s += part[(long long)k * n + i];
  if (i < n_w)
    dw[i] = s;
  else
    db[i - n_w] = s;
}

int reduce_slots(const float* work, int n_slots, int C, int Cout, float* dw, float* db,
                 cudaStream_t stream) {
  const int n_w = 27 * C * Cout;
  LAUNCH(conv3d_wgrad_reduce, cdiv(n_w + Cout, 256), 256, stream)(work, n_slots, n_w, Cout,
                                                                  dw, db);
  return (int)cudaGetLastError();
}

int wgrad_items(int B, int H, int W, int T, int pad, int* tiles_w, int* tiles_hw) {
  const int Ho = H + 2 * pad - 2;
  const int Wo = W + 2 * pad - 2;
  const int To = T + 2 * pad - 2;
  *tiles_w = (Wo + GW - 1) / GW;
  *tiles_hw = *tiles_w * ((Ho + GH - 1) / GH);
  return B * To * *tiles_hw;
}

int splits(int n_items) {
  const int per = (n_items + MAX_SPLITS - 1) / MAX_SPLITS;
  return (n_items + per - 1) / per;
}

int launch_bwd_f32(const float* x, int B, int H, int W, int Tin, int C, const float* w,
                   const float* g, int Cout, int pad, float* dx, float* dw, float* db,
                   float* work, int n_slots, cudaStream_t stream) {
  int tiles_w, tiles_hw;
  const int n_items = wgrad_items(B, H, W, Tin, pad, &tiles_w, &tiles_hw);
  if (n_slots != splits(n_items)) return -1;  // the workspace was sized for another call
  const int per_split = (n_items + n_slots - 1) / n_slots;

  // dx: the convolution of g (B, Ho, Wo, To, Cout) with the flipped kernel
  int e = launch_f32(g, B, H + 2 * pad - 2, W + 2 * pad - 2, Tin + 2 * pad - 2, Cout, w,
                     nullptr, C, 2 - pad, 1, dx, stream);
  if (e != 0) return e;

  const int co_blocks = (Cout + GCO - 1) / GCO;
  const dim3 grid(n_slots, ((C + GC - 1) / GC) * co_blocks);
#ifdef __CUDACC__
  const cudaError_t a = cudaFuncSetAttribute(
      conv3d_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
#endif
  LAUNCH_SMEM(conv3d_wgrad_kernel, grid, GNT, GSMEM_BYTES, stream)(
      x, g, work, H, W, Tin, C, Cout, pad, H + 2 * pad - 2, W + 2 * pad - 2,
      Tin + 2 * pad - 2, tiles_w, tiles_hw, n_items, per_split, co_blocks);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce_slots(work, n_slots, C, Cout, dw, db, stream);
}

// ---- bfloat16: K6 and K7's dx on the tensor cores ----------------------------

constexpr int TM = 256;        // flat-plane rows (output pixels) per tile
constexpr int TC_NT = 256;     // threads: 8 warps, each 32 rows x 32 output channels
constexpr int TC_CO = 32;      // output channels per block (four n8 tiles)
constexpr int RING = 3;        // input t-planes in shared memory
constexpr int TC_TARGET_BLOCKS = 3 * 132;  // split t_out toward three waves of blocks

// Strips and tiles of an output plane (Ho, Wo): strips of sw columns, each
// flattened over its padded width wq = sw + 2 and cut into tiles of TM rows,
// whose input halo is halo = TM + 2 wq + 2 rows.
struct Strips {
  int sw, wq, strips, tiles, halo;
};

Strips strips_of(int Ho, int Wo, int sw) {
  Strips s;
  s.sw = std::min(Wo, sw);
  s.wq = s.sw + 2;
  s.strips = cdiv(Wo, s.sw);
  s.tiles = cdiv((long long)Ho * s.wq, TM);
  s.halo = TM + 2 * s.wq + 2;
  return s;
}

struct TcPlan {
  int Ho, Wo, To;
  int cp;  // C rounded up to 16 (the K padding)
  int rs;  // words per shared row of a plane: cp / 2 + 4
  int sk;  // words per shared row of the kernel: 27 cp / 2 + 4
  Strips st;
  int t_len, t_chunks;  // t_out per block, blocks along t_out
  int smem;
};

int tc_plan(TcPlan* p, int B, int H, int W, int T, int C, int Cout, int pad) {
  p->Ho = H + 2 * pad - 2;
  p->Wo = W + 2 * pad - 2;
  p->To = T + 2 * pad - 2;
  p->cp = (C + 15) / 16 * 16;
  p->rs = p->cp / 2 + 4;
  p->sk = 27 * p->cp / 2 + 4;
  const int w_bytes = TC_CO * p->sk * 4;
  const int rows = (SMEM_LIMIT - w_bytes) / (RING * p->rs * 4);  // halo rows that fit
  const int sw_max = (rows - TM - 6) / 2;
  if (rows < TM + 8 || sw_max < 1) return -1;  // C too large for the kernel to stay resident
  p->st = strips_of(p->Ho, p->Wo, sw_max);
  p->smem = w_bytes + RING * p->st.halo * p->rs * 4;
  // t_out runs of at least three, so that every block reuses its ring
  const int units = B * p->st.strips * p->st.tiles * cdiv(Cout, TC_CO);
  const int chunks = std::max(1, cdiv(TC_TARGET_BLOCKS, units));
  p->t_len = std::max(std::min(p->To, 3), cdiv(p->To, chunks));
  p->t_chunks = cdiv(p->To, p->t_len);
  return 0;
}

// Grid: x = output-channel block x strip x tile, y = run of t_out, z = b.
// flip as conv3d_kernel; bias may be null. CP is p.cp: every loop over the
// taps and the channels has a trip count the compiler knows, and it loads
// each k16 step's fragments while the mma of the step before runs.
template <int CP>
__global__ void __launch_bounds__(TC_NT, 1) conv3d_tc_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    const float* __restrict__ bias, uint16_t* __restrict__ out, int H, int W, int Tin, int C,
    int Cout, int pad, int flip, TcPlan p) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned smem_tc[];
#else
  alignas(16) __shared__ unsigned smem_tc[SMEM_LIMIT / 4];
  emu_poison_shared(smem_tc, sizeof smem_tc);
#endif
  constexpr int KW = CP / 2;         // words per tap
  constexpr int RS = KW + 4;         // words per shared row of a plane
  constexpr int SK = 27 * KW + 4;    // words per shared row of the kernel
  constexpr int KC = CP / 16;        // k16 steps per tap
  unsigned* s_w = smem_tc;               // [TC_CO][SK]: W'[tap][c][co] at row co, word (tap CP + c) / 2
  unsigned* s_x = smem_tc + TC_CO * SK;  // [RING][halo][RS]: plane rows, two channels a word
  const Strips st = p.st;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int cell = blockIdx.x;
  const int tile = cell % st.tiles;
  cell /= st.tiles;
  const int strip = cell % st.strips;
  const int co0 = cell / st.strips * TC_CO;
  const int r0 = tile * TM;
  const int xs0 = strip * st.sw;
  const long long b = blockIdx.z;
  const int t0 = blockIdx.y * p.t_len;
  const int t1 = min(t0 + p.t_len, p.To);
  const int n_tiles = min(4, (Cout - co0) / 8);  // n8 tiles holding output channels

  // input t-plane pt (padded index; input ti = pt - pad) of this tile into
  // its ring slot: halo rows, CP / 8 chunks of 8 channels, zero outside
  constexpr int chunks = CP / 8;
  auto present = [&](int pt) { return pt - pad >= 0 && pt - pad < Tin; };
  auto load_plane = [&](int pt) {
    const int ti = pt - pad;
    unsigned* dst = s_x + (pt % RING) * st.halo * RS;
    for (int i = tid; i < st.halo * chunks; i += TC_NT) {
      const int q = i / chunks;
      const int ch = i - q * chunks;
      const int fr = r0 + q;
      const int yq = fr / st.wq;
      const int yi = yq - pad;
      const int xi = xs0 + (fr - yq * st.wq) - pad;
      const bool ok = ch * 8 < C && yi >= 0 && yi < H && xi >= 0 && xi < W;
      const uint16_t* src = ok ? x + (((b * H + yi) * W + xi) * Tin + ti) * C + ch * 8 : x;
      cp_async16(dst + q * RS + ch * 4, src, ok);
    }
  };

  // ldmatrix rows of this lane: A (rows of the plane, channels) and B (rows
  // of the kernel, one per output channel), each as four 8 x 8 matrices
  const int a_row = warp * 32 + (lane & 15);
  const int a_word = (lane >> 4) * 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);
  const int b_word = ((lane >> 3) & 1) * 4;

  float acc[2][4][4];
  // the 9 KC k16 steps of plane pt (temporal tap dz): step s is tap
  // (dy, dx) = (s / KC / 3, s / KC % 3), channels (s % KC) 16 ..
  auto mma_plane = [&](int pt, int dz) {
    const unsigned* ap = s_x + ((pt % RING) * st.halo + a_row) * RS + a_word;
    const unsigned* bp = s_w + b_row * SK + dz * KW + b_word;
    unsigned a[2][2][4], bf[2][2][4];  // two steps' fragments
    auto fragments = [&](int s, unsigned (&fa)[2][4], unsigned (&fb)[2][4]) {
      const int tap9 = s / KC;
      const int kc = s % KC * 8;
      const unsigned* a0 = ap + ((tap9 / 3) * st.wq + tap9 % 3) * RS + kc;
      const unsigned* b0 = bp + tap9 * 3 * KW + kc;  // tap (dy, dx, dz) = 3 tap9 + dz
      ldsm_x4(fa[0], a0);
      ldsm_x4(fa[1], a0 + 16 * RS);
      ldsm_x4(fb[0], b0);
      if (n_tiles > 2) ldsm_x4(fb[1], b0 + 16 * SK);
    };
    fragments(0, a[0], bf[0]);
#pragma unroll
    for (int s = 0; s < 9 * KC; ++s) {
      if (s + 1 < 9 * KC) fragments(s + 1, a[(s + 1) & 1], bf[(s + 1) & 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n_tiles) mma_bf16(acc[mt][j], a[s & 1][mt], &bf[s & 1][j >> 1][(j & 1) * 2]);
    }
  };

  // this lane's output channels and their bias
  float bv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + j * 8 + (lane & 3) * 2 + h;
      bv[j][h] = bias && j < n_tiles ? bias[co] : 0.f;
    }

  for (int pt = t0; pt <= t0 + 2; ++pt)
    if (present(pt)) load_plane(pt);
  // the kernel, once, zero past C and past Cout, while the first planes
  // are in flight. flip: row co of W' holds, per tap, a run of C channels
  // of w, copied 16 bytes at a time. Otherwise two 16-byte loads of w
  // (channels c and c + 1 of 8 output channels) give 8 words of 8 rows.
  if (flip) {
    for (int i = tid; i < TC_CO * 27 * chunks; i += TC_NT) {
      const int ch = i % chunks;
      const int tap = i / chunks % 27;
      const int n = i / (chunks * 27);
      const bool ok = co0 + n < Cout && ch * 8 < C;
      const uint16_t* src = ok ? w + ((long long)(26 - tap) * Cout + co0 + n) * C + ch * 8 : w;
      cp_async16(s_w + n * SK + tap * KW + ch * 4, src, ok);
    }
  } else {
    constexpr int UNITS = 27 * KW * (TC_CO / 8);  // (tap, channel pair, 8 outputs)
    for (int i0 = 0; i0 < UNITS; i0 += 4 * TC_NT) {
      Bits128 lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * TC_NT + tid;
        const int k = i >> 2;  // tap KW + channel pair
        const int tap = k / KW;
        const int c = (k - tap * KW) * 2;
        const int co = co0 + (i & 3) * 8;
        lo[u] = hi[u] = Bits128{0, 0, 0, 0};
        if (i < UNITS && c < C && co < Cout) {
          const Bits128* src =
              reinterpret_cast<const Bits128*>(w + ((long long)tap * C + c) * Cout + co);
          lo[u] = src[0];
          hi[u] = src[Cout / 8];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * TC_NT + tid;
        if (i >= UNITS) break;
        unsigned* dst = s_w + (i & 3) * 8 * SK + (i >> 2);
        const unsigned a[4] = {lo[u].a, lo[u].b, lo[u].c, lo[u].d};
        const unsigned h[4] = {hi[u].a, hi[u].b, hi[u].c, hi[u].d};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[2 * e * SK] = (a[e] & 0xffffu) | (h[e] << 16);
          dst[(2 * e + 1) * SK] = (a[e] >> 16) | (h[e] & 0xffff0000u);
        }
      }
    }
  }
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
    cp_async_wait<0>();
    __syncthreads();  // planes t, t + 1, t + 2 (and the kernel) are in
    if (present(t)) mma_plane(t, 0);
    __syncthreads();  // plane t's slot is free
    if (t + 3 <= t1 + 1 && present(t + 3)) load_plane(t + 3);
    cp_async_commit();
    if (present(t + 1)) mma_plane(t + 1, 1);
    if (present(t + 2)) mma_plane(t + 2, 2);

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fr = r0 + warp * 32 + mt * 16 + (lane >> 2) + h * 8;
        const int y = fr / st.wq;
        const int xl = fr - y * st.wq;
        const int xo = xs0 + xl;
        if (y >= p.Ho || xl >= st.sw || xo >= p.Wo) continue;
        uint16_t* o = out + (((b * p.Ho + y) * p.Wo + xo) * p.To + t) * Cout + co0 +
                      (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= n_tiles) break;
          const unsigned lo = f32_to_bf16(acc[mt][j][2 * h] + bv[j][0]);
          const unsigned hi = f32_to_bf16(acc[mt][j][2 * h + 1] + bv[j][1]);
          *reinterpret_cast<unsigned*>(o + j * 8) = lo | (hi << 16);
        }
      }
    }
  }
}

int launch_tc(const uint16_t* x, int B, int H, int W, int Tin, int C, const uint16_t* w,
              const float* bias, int Cout, int pad, int flip, uint16_t* out,
              cudaStream_t stream) {
  TcPlan p;
  if (tc_plan(&p, B, H, W, Tin, C, Cout, pad) != 0) return -1;
  const dim3 grid(p.st.strips * p.st.tiles * cdiv(Cout, TC_CO), p.t_chunks, B);
  auto run = [&](auto kernel) {
#ifdef __CUDACC__
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
#endif
    LAUNCH_SMEM(kernel, grid, TC_NT, p.smem, stream)(x, w, bias, out, H, W, Tin, C, Cout,
                                                     pad, flip, p);
    return (int)cudaGetLastError();
  };
  switch (p.cp) {
    case 16: return run(conv3d_tc_kernel<16>);
    case 32: return run(conv3d_tc_kernel<32>);
    case 48: return run(conv3d_tc_kernel<48>);
    case 64: return run(conv3d_tc_kernel<64>);
  }
  return -1;
}

// ---- bfloat16: K6 at C = Cout = 32 on wgmma ---------------------------------

constexpr int WK_C = 32;                       // input and output channels of the route
constexpr int WK_CONSUMERS = 4 * 128;          // four warpgroups, an m64 tile of the unit each
constexpr int WK_THREADS = WK_CONSUMERS + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg, within the block's 640 x 96 (launch
// bounds): 512 x 104 + 128 x 40
constexpr int WK_CONSUMER_REGS = 104;
constexpr int WK_PRODUCER_REGS = 40;
static_assert(64 * WK_CONSUMERS / 128 == TM, "a unit is one flat-plane tile");
constexpr int WK_TAP_BYTES = 3 * WK_C * WK_C * 2;  // B of one (dy, dx): 96 rows of 64 bytes
constexpr int WK_W_BYTES = 9 * WK_TAP_BYTES;       // 55,296: the whole kernel
// Strips of up to WK_SW columns. A stage holds, for each 8-channel chunk,
// the rows (16 bytes each) of the whole padded image rows that a unit's
// halo spans: at most WK_ROWS at WK_SW (420 at wq 46), so that every operand
// offset but dy wq and the unit's first row is a constant.
constexpr int WK_SW = 44;
constexpr int WK_ROWS = 424;
constexpr int WK_CHUNK = WK_ROWS * 16;  // bytes of one 8-channel chunk of a stage
constexpr int WK_STAGES = 6;            // the ring's stages
constexpr int WK_SMEM = 1024 + WK_W_BYTES + WK_STAGES * 4 * WK_CHUNK + 16 * WK_STAGES;
static_assert(WK_SMEM <= SMEM_LIMIT, "the kernel and the ring in one block's shared memory");

// Units (b, strip, tile) of TM flat-plane rows; a stage holds one input
// t-plane's halo of a unit: ny whole image rows of the strip's padded width
// (one TMA box a chunk), each of its four 8-channel chunks a run of rows 16
// bytes apart.
struct WkPlan {
  int Ho, Wo, To;
  Strips st;
  int ny, units;
};

void wk_plan(WkPlan* p, int B, int H, int W, int T, int pad) {
  p->Ho = H + 2 * pad - 2;
  p->Wo = W + 2 * pad - 2;
  p->To = T + 2 * pad - 2;
  p->st = strips_of(p->Ho, p->Wo, WK_SW);
  p->ny = (p->st.wq - 1 + p->st.halo - 1) / p->st.wq + 1;  // image rows a halo may span
  p->units = B * p->st.strips * p->st.tiles;
}

// Input plane pt (padded index) adds to outputs pt, pt - 1 and pt - 2
// (temporal taps dz 0, 1, 2): its products put column block dz of N = 96
// in accumulator block dz, which holds output pt - dz. After a plane's
// group is done, block 2 (output pt - 2) is complete: at the next plane it
// is copied out (and stored while that plane's group runs), blocks 0 and 1
// move up one and block 0 starts at zero. (An operand list permuted by pt %
// 3 instead would have the compiler copy the accumulators into one
// contiguous register range for every wgmma, and serialize them.)

// A finished accumulator block, v[OFF .. OFF + 15] (columns 8 i + 2 q (+
// 1), rows l / 4 (+ 8) of the warp's 16), as output t: the float32 bias,
// one rounding to bf16, a 4-byte store a pair of channels; rows off the
// plane are skipped. (OFF is a template argument so that the accumulators
// stay registers.)
template <int OFF, int N>
__device__ __forceinline__ void wk_store(uint16_t* const (&orow)[2], int t, const float (&v)[N],
                                         const float (&bv)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (orow[h] == nullptr) continue;
    uint16_t* o = orow[h] + t * WK_C;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<unsigned*>(o + 8 * i) =
          bf16x2_rn(v[OFF + 4 * i + 2 * h] + bv[i][0], v[OFF + 4 * i + 2 * h + 1] + bv[i][1]);
  }
}

// Grid: min(units, SMs) persistent blocks; block i walks units i, i +
// gridDim.x, ... (unit u: tile u % tiles, strip u / tiles % strips, b the
// rest). Warpgroup 4 is the producer: one of its threads loads each present
// input plane's halo of the unit into the next ring stage with four TMA
// boxes (x as a 5-D tensor (C, T, W, H, B): 8 channels x 1 plane x wq columns
// x ny rows, zero outside the input), their bytes completing on the stage's
// full barrier. Consumer warpgroup g owns tile rows 64 g .. 64 g + 63; for
// each plane it commits one group of 18 wgmma m64n96k16 (the 9 taps (dy,
// dx), each two k16 steps: A the plane's rows shifted by dy wq + dx, B the
// taps (dy, dx, 0..2) side by side), stores the block the plane before
// finished while the group runs, waits for it and frees the stage. Each
// group starts and ends inside its plane's iteration, with no branch around
// a wgmma: otherwise the compiler serializes them.
__global__ void __launch_bounds__(WK_THREADS, 1) conv3d_wg_kernel(
    const __grid_constant__ CUtensorMap xmap, const uint16_t* __restrict__ w,
    const float* __restrict__ bias, uint16_t* __restrict__ out, int Tin, int pad, WkPlan p) {
#ifdef __CUDACC__
  extern __shared__ __align__(1024) unsigned char smem_wk_raw[];
#else
  alignas(1024) __shared__ unsigned char smem_wk_raw[SMEM_LIMIT];
  emu_poison_shared(smem_wk_raw, sizeof smem_wk_raw);
#endif
  unsigned char* smem = smem_wk_raw + ((1024 - (shared_addr(smem_wk_raw) & 1023)) & 1023);
  unsigned char* s_w = smem;                  // [9 (dy, dx)][96 (dz, co)][32 c], 64-byte swizzled
  unsigned char* ring = smem + WK_W_BYTES;    // [stages][4 chunks][chunk bytes]
  constexpr int stage_bytes = 4 * WK_CHUNK;
  constexpr int S = WK_STAGES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * stage_bytes);
  uint64_t* empty = full + S;
  const Strips st = p.st;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                       // the producer's, with the boxes' bytes
      mbar_init(&empty[s], WK_CONSUMERS / 32);      // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  // The kernel, once a block: row n = 32 dz + co of tap (dy, dx) holds
  // w[dy][dx][dz][0 .. 31][co], 16-byte chunk c of the row at chunk c ^
  // ((n / 2) % 4) (the 64-byte swizzle). Two 16-byte loads of w (channels
  // c and c + 1 of 8 output channels) give 8 words of 8 rows.
  for (int i = tid; i < 27 * (WK_C / 2) * (WK_C / 8); i += WK_THREADS) {
    const int co8 = i & 3;
    const int c = ((i >> 2) & 15) * 2;
    const int tap = i >> 6;  // (dy, dx, dz)
    const Bits128* src = reinterpret_cast<const Bits128*>(w + (tap * WK_C + c) * WK_C + co8 * 8);
    const Bits128 lo = src[0], hi = src[WK_C / 8];
    const unsigned a[4] = {lo.a, lo.b, lo.c, lo.d};
    const unsigned h[4] = {hi.a, hi.b, hi.c, hi.d};
    unsigned char* row0 = s_w + tap / 3 * WK_TAP_BYTES;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = tap % 3 * WK_C + co8 * 8 + e;
      const unsigned v = e & 1 ? (a[e >> 1] >> 16) | (h[e >> 1] & 0xffff0000u)
                               : (a[e >> 1] & 0xffffu) | (h[e >> 1] << 16);
      *reinterpret_cast<unsigned*>(row0 + n * 64 + ((((c >> 3) ^ (n >> 1)) & 3) << 4) +
                                   (c & 7) * 2) = v;
    }
  }
  fence_proxy_async();  // the kernel's writes, visible to wgmma
  __syncthreads();

  if (tid >= WK_CONSUMERS) {  // the producer warpgroup: one thread loads
    setmaxnreg_dec<WK_PRODUCER_REGS>();
    if (tid != WK_CONSUMERS) return;
    const unsigned box_bytes = 16 * st.wq * p.ny;
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int r0 = u % st.tiles * TM;
      const int xs0 = u / st.tiles % st.strips * st.sw;
      const int b = u / (st.tiles * st.strips);
      for (int pt = pad; pt < pad + Tin; ++pt) {
        mbar_wait(&empty[stage], phase ^ 1u);
        mbar_arrive_expect_tx(&full[stage], 4 * box_bytes);
        unsigned char* dst = ring + stage * stage_bytes;
        for (int c = 0; c < 4; ++c)
          tma_load_5d(dst + c * WK_CHUNK, &xmap, 8 * c, pt - pad, xs0 - pad, r0 / st.wq - pad, b,
                      &full[stage]);
        if (++stage == S) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<WK_CONSUMER_REGS>();
  const int g = tid >> 7;  // rows 64 g .. 64 g + 63 of the tile
  const int wq4 = (tid >> 5) & 3;
  const int l = tid & 31;
  const int q = l & 3;
  float bv[4][2];  // this thread's output channels 8 i + 2 q (+ 1) and their bias
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[i][e] = bias ? bias[8 * i + 2 * q + e] : 0.f;
  float acc[48];  // the fragment: blocks dz 0, 1, 2 of 16
  const uint64_t b_desc = wgmma_desc_sw64(s_w);
  int stage = 0;
  unsigned phase = 0;

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int r0 = u % st.tiles * TM;
    const int xs0 = u / st.tiles % st.strips * st.sw;
    const long long b = u / (st.tiles * st.strips);
    const int a0 = r0 % st.wq;  // the tile's first row in its stage (whole image rows)
    // this thread's output rows 64 g + 16 wq4 + l / 4 + 8 h of the tile:
    // their channels 2 q of t_out 0, or null off the plane
    uint16_t* orow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fr = r0 + 64 * g + 16 * wq4 + (l >> 2) + 8 * h;
      const int y = fr / st.wq;
      const int xl = fr - y * st.wq;
      const int xo = xs0 + xl;
      orow[h] = y < p.Ho && xl < st.sw && xo < p.Wo
                    ? out + ((b * p.Ho + y) * p.Wo + xo) * p.To * WK_C + 2 * q
                    : nullptr;
    }
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = 0.f;
    // the present planes pad .. pad + Tin - 1 in turn (planes past the SAME
    // border add nothing); at plane pt, block 2 holds output pt - 3, done
    for (int pt = pad; pt < pad + Tin; ++pt) {
      float done[16];
      wgmma_fence_operands(acc);
#pragma unroll
      for (int i = 0; i < 16; ++i) {  // output pt - 3 out; pt - 2, pt - 1 move up; pt starts
        done[i] = acc[32 + i];
        acc[32 + i] = acc[16 + i];
        acc[16 + i] = acc[i];
        acc[i] = 0.f;
      }
      wgmma_fence_operands(acc);
      const unsigned char* a_plane = ring + stage * stage_bytes;
      mbar_wait(&full[stage], phase);
      wgmma_fence();
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        // A: the rows of tap (dy, dx) start dy wq + dx rows on; k16 step ks
        // is chunks 2 ks and 2 ks + 1
        const uint64_t a_dy =
            wgmma_desc_plain(a_plane + (a0 + 64 * g + dy * st.wq) * 16, WK_CHUNK, 128);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            wgmma_bf16_m64n96k16(acc, a_dy + ((dx * 16 + ks * 2 * WK_CHUNK) >> 4),
                                 b_desc + (((dy * 3 + dx) * WK_TAP_BYTES + ks * 32) >> 4));
      }
      wgmma_commit();
      if (pt >= 3) wk_store<0>(orow, pt - 3, done, bv);  // while the group runs
      wgmma_wait<0>();  // the plane's group is done: its stage is free
      wgmma_fence_operands(acc);
      if (l == 0) mbar_arrive(&empty[stage]);
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
    // the outputs still in the blocks: block k holds output pad + Tin - 1 - k
    const int last = pad + Tin - 1;
    if (last - 2 >= 0) wk_store<32>(orow, last - 2, acc, bv);
    if (last - 1 < p.To) wk_store<16>(orow, last - 1, acc, bv);
    if (last < p.To) wk_store<0>(orow, last, acc, bv);
  }
}

int launch_wg(const uint16_t* x, int B, int H, int W, int Tin, int C, const uint16_t* w,
              const float* bias, int Cout, int pad, uint16_t* out, cudaStream_t stream) {
  if (C != WK_C || Cout != WK_C) return -1;
  WkPlan p;
  wk_plan(&p, B, H, W, Tin, pad);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  // x (B, H, W, T, C) as TMA sees it: (C, T, W, H, B), innermost first
  CUtensorMap xmap;
  const uint64_t dims[5] = {(uint64_t)C, (uint64_t)Tin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t row = 2ull * C;
  const uint64_t strides[4] = {row, row * Tin, row * Tin * W, row * Tin * W * H};
  const unsigned box[5] = {8, 1, (unsigned)p.st.wq, (unsigned)p.ny, 1};
  const int m = encode_tensor_map(&xmap, 5, x, dims, strides, box, 0);
  if (m != 0) return m;
#ifdef __CUDACC__
  const cudaError_t e =
      cudaFuncSetAttribute(conv3d_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WK_SMEM);
  if (e != cudaSuccess) return (int)e;
#endif
  LAUNCH_SMEM(conv3d_wg_kernel, std::min(p.units, sms), WK_THREADS, WK_SMEM, stream)(
      xmap, w, bias, out, Tin, pad, p);
  return (int)cudaGetLastError();
}

// ---- bfloat16: K7 dW and db on the tensor cores ------------------------------

constexpr int WG_NT = 288;   // threads: 9 warps, one per (dy, dx) tap
constexpr int WG_C = 32;     // input channels per block (two m16 tiles)
constexpr int WG_CO = 32;    // output channels per block (four n8 tiles)
constexpr int WG_RS = 20;    // words per shared row: 32 channels and 16 bytes of pad
constexpr int WG_MAX_SW = 95;  // strip width that keeps two blocks on an SM
constexpr int WG_TARGET_BLOCKS = 2 * 132;

struct WgPlan {
  int Ho, Wo, To;
  Strips st;
  int c_blocks, co_blocks;
  int items, per_slot, slots;  // work items (b, t_out, strip, tile); per block; blocks
  int smem;
};

void wg_plan(WgPlan* p, int B, int H, int W, int T, int C, int Cout, int pad) {
  p->Ho = H + 2 * pad - 2;
  p->Wo = W + 2 * pad - 2;
  p->To = T + 2 * pad - 2;
  p->st = strips_of(p->Ho, p->Wo, WG_MAX_SW);
  p->c_blocks = cdiv(C, WG_C);
  p->co_blocks = cdiv(Cout, WG_CO);
  p->items = B * p->To * p->st.strips * p->st.tiles;
  const int max_slots = std::max(1, WG_TARGET_BLOCKS / (3 * p->c_blocks * p->co_blocks));
  p->per_slot = cdiv(p->items, max_slots);
  p->slots = cdiv(p->items, p->per_slot);
  p->smem = 2 * (p->st.halo + TM) * WG_RS * 4;
}

// Grid: x = workspace slot (a run of per_slot items), y = dz x input-channel
// block x output-channel block. Slot x of part holds dW (27, C, Cout) in
// (dy, dx, dz) tap order, then db (Cout,).
__global__ void __launch_bounds__(WG_NT, 2) conv3d_wgrad_tc_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ g, float* __restrict__ part,
    int H, int W, int Tin, int C, int Cout, int pad, WgPlan p) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned smem_wg[];
#else
  alignas(16) __shared__ unsigned smem_wg[SMEM_LIMIT / 4];
  emu_poison_shared(smem_wg, sizeof smem_wg);
#endif
  const Strips st = p.st;
  const int stage_words = (st.halo + TM) * WG_RS;  // x halo rows, then g rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dz = blockIdx.y % 3;
  const int cb = blockIdx.y / 3 % p.c_blocks;
  const int c0 = cb * WG_C;
  const int co0 = blockIdx.y / 3 / p.c_blocks * WG_CO;
  const int m_tiles = min(2, cdiv(C - c0, 16));
  const int n_tiles = min(4, (Cout - co0) / 8);
  const bool db_block = dz == 1 && cb == 0;  // plane t_out + 1 - pad is never absent
  const int dy = warp / 3;
  const int dx = warp % 3;

  struct Item {
    long long b;
    int t, xs0, r0;
  };
  auto item_at = [&](int it) {
    Item q;
    q.r0 = it % st.tiles * TM;
    it /= st.tiles;
    q.xs0 = it % st.strips * st.sw;
    it /= st.strips;
    q.t = it % p.To;
    q.b = it / p.To;
    return q;
  };
  auto present = [&](const Item& q) {
    const int ti = q.t + dz - pad;
    return ti >= 0 && ti < Tin;
  };
  // the item's input halo (plane t_out + dz) and g rows into a stage
  auto load_item = [&](int it, int stage) {
    const Item q = item_at(it);
    unsigned* xs = smem_wg + stage * stage_words;
    unsigned* gs = xs + st.halo * WG_RS;
    if (present(q)) {
      const int ti = q.t + dz - pad;
      for (int i = tid; i < st.halo * 4; i += WG_NT) {
        const int r = i >> 2;
        const int ch = i & 3;
        const int fr = q.r0 + r;
        const int yq = fr / st.wq;
        const int yi = yq - pad;
        const int xi = q.xs0 + (fr - yq * st.wq) - pad;
        const bool ok = c0 + ch * 8 < C && yi >= 0 && yi < H && xi >= 0 && xi < W;
        const uint16_t* src =
            ok ? x + (((q.b * H + yi) * W + xi) * Tin + ti) * C + c0 + ch * 8 : x;
        cp_async16(xs + r * WG_RS + ch * 4, src, ok);
      }
    } else if (!db_block) {
      return;
    }
    for (int i = tid; i < TM * 4; i += WG_NT) {
      const int r = i >> 2;
      const int ch = i & 3;
      const int fr = q.r0 + r;
      const int y = fr / st.wq;
      const int xl = fr - y * st.wq;
      const int xo = q.xs0 + xl;
      // the cropped columns, the rows past Ho and the channels past Cout are 0
      const bool ok = co0 + ch * 8 < Cout && y < p.Ho && xl < st.sw && xo < p.Wo;
      const uint16_t* src =
          ok ? g + (((q.b * p.Ho + y) * p.Wo + xo) * p.To + q.t) * Cout + co0 + ch * 8 : g;
      cp_async16(gs + r * WG_RS + ch * 4, src, ok);
    }
  };

  // ldmatrix.trans rows of this lane (pixels): A from the halo, B from g
  const int a_pix = ((lane >> 4) << 3) + (lane & 7);
  const int a_word = ((lane >> 3) & 1) * 4;
  const int b_pix = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int b_word = (lane >> 4) * 4;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
  float db_part = 0.f;  // output channel co0 + lane, rows warp, warp + 9, ...

  const int first = blockIdx.x * p.per_slot;
  const int last = min(first + p.per_slot, p.items);
  load_item(first, 0);
  cp_async_commit();
  for (int it = first; it < last; ++it) {
    const int stage = (it - first) & 1;
    if (it + 1 < last) load_item(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // item it is in
    const unsigned* xs = smem_wg + stage * stage_words;
    const unsigned* gs = xs + st.halo * WG_RS;
    if (present(item_at(it))) {
      const unsigned* ap = xs + (a_pix + dy * st.wq + dx) * WG_RS + a_word;
      const unsigned* bp = gs + b_pix * WG_RS + b_word;
      unsigned a[2][2][4], bf[2][2][4];  // two k16 steps' fragments
      auto fragments = [&](int ks, unsigned (&fa)[2][4], unsigned (&fb)[2][4]) {
        ldsm_x4_trans(fa[0], ap + ks * 16 * WG_RS);
        if (m_tiles > 1) ldsm_x4_trans(fa[1], ap + ks * 16 * WG_RS + 8);
        ldsm_x4_trans(fb[0], bp + ks * 16 * WG_RS);
        if (n_tiles > 2) ldsm_x4_trans(fb[1], bp + ks * 16 * WG_RS + 8);
      };
      fragments(0, a[0], bf[0]);
#pragma unroll
      for (int ks = 0; ks < TM / 16; ++ks) {
        if (ks + 1 < TM / 16) fragments(ks + 1, a[(ks + 1) & 1], bf[(ks + 1) & 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (mt < m_tiles && j < n_tiles)
              mma_bf16(acc[mt][j], a[ks & 1][mt], &bf[ks & 1][j >> 1][(j & 1) * 2]);
      }
    }
    if (db_block && co0 + lane < Cout) {
      const uint16_t* gh = reinterpret_cast<const uint16_t*>(gs);
      for (int r = warp; r < TM; r += WG_NT / 32) db_part += bf16_to_f32(gh[r * WG_RS * 2 + lane]);
    }
    __syncthreads();  // every read of this stage is done
  }

  float* slot = part + (long long)blockIdx.x * (27LL * C * Cout + Cout);
  const int tap = (dy * 3 + dx) * 3 + dz;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + mt * 16 + (lane >> 2) + h * 8;
      if (mt >= m_tiles || c >= C) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n_tiles) break;
        float* d = slot + ((long long)tap * C + c) * Cout + co0 + j * 8 + (lane & 3) * 2;
        d[0] = acc[mt][j][2 * h];
        d[1] = acc[mt][j][2 * h + 1];
      }
    }
  if (db_block) {  // the nine warps' partial sums, added in warp order
    float* red = reinterpret_cast<float*>(smem_wg);
    red[tid] = db_part;
    __syncthreads();
    if (tid < WG_CO && co0 + tid < Cout) {
      float s = 0.f;
      for (int k = 0; k < WG_NT / 32; ++k) s += red[k * 32 + tid];
      slot[27LL * C * Cout + co0 + tid] = s;
    }
  }
}

int launch_bwd_tc(const uint16_t* x, int B, int H, int W, int Tin, int C, const uint16_t* w,
                  const uint16_t* g, int Cout, int pad, uint16_t* dx, float* dw, float* db,
                  float* work, int n_slots, cudaStream_t stream) {
  WgPlan p;
  wg_plan(&p, B, H, W, Tin, C, Cout, pad);
  if (n_slots != p.slots) return -1;  // the workspace was sized for another call
  // dx: the convolution of g (B, Ho, Wo, To, Cout) with the flipped kernel
  int e = launch_tc(g, B, p.Ho, p.Wo, p.To, Cout, w, nullptr, C, 2 - pad, 1, dx, stream);
  if (e != 0) return e;
#ifdef __CUDACC__
  const cudaError_t a = cudaFuncSetAttribute(
      conv3d_wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (a != cudaSuccess) return (int)a;
#endif
  const dim3 grid(p.slots, 3 * p.c_blocks * p.co_blocks);
  LAUNCH_SMEM(conv3d_wgrad_tc_kernel, grid, WG_NT, p.smem, stream)(x, g, work, H, W, Tin, C,
                                                                   Cout, pad, p);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce_slots(work, n_slots, C, Cout, dw, db, stream);
}

}  // namespace

extern "C" {

// out (B, Ho, Wo, To, Cout) = conv(x (B, H, W, T, C), w (3, 3, 3, C, Cout)) +
// bias; pad 1 = SAME, 0 = VALID.
int conv3d_rfab_f32(const float* x, int B, int H, int W, int T, int C, const float* w,
                    const float* bias, int Cout, int pad, float* out,
                    cudaStream_t stream) {
  return launch_f32(x, B, H, W, T, C, w, bias, Cout, pad, 0, out, stream);
}

// The same on bfloat16 x, w and out (16-bit patterns); float32 sums; the
// mma.sync kernel, any C and Cout of the contract.
int conv3d_rfab_bf16(const uint16_t* x, int B, int H, int W, int T, int C,
                     const uint16_t* w, const float* bias, int Cout, int pad,
                     uint16_t* out, cudaStream_t stream) {
  return launch_tc(x, B, H, W, T, C, w, bias, Cout, pad, 0, out, stream);
}

// The same on the wgmma kernel; -1 unless C = Cout = 32.
int conv3d_rfab_bf16_wg(const uint16_t* x, int B, int H, int W, int T, int C,
                        const uint16_t* w, const float* bias, int Cout, int pad,
                        uint16_t* out, cudaStream_t stream) {
  return launch_wg(x, B, H, W, T, C, w, bias, Cout, pad, out, stream);
}

// Workspace slots of conv3d_rfab_bwd_f32 for x (B, H, W, T, .) and pad; the
// caller passes a float32 workspace of slots x (27 C Cout + Cout).
int conv3d_rfab_bwd_slots(int B, int H, int W, int T, int pad) {
  int tiles_w, tiles_hw;
  return splits(wgrad_items(B, H, W, T, pad, &tiles_w, &tiles_hw));
}

// The same for conv3d_rfab_bwd_bf16 of x (B, H, W, T, C), Cout and pad.
int conv3d_rfab_bwd_bf16_slots(int B, int H, int W, int T, int C, int Cout, int pad) {
  WgPlan p;
  wg_plan(&p, B, H, W, T, C, Cout, pad);
  return p.slots;
}

// K7: the gradients of conv3d_rfab_f32 for the cotangent g (B, Ho, Wo, To,
// Cout): dx (B, H, W, T, C), dw (3, 3, 3, C, Cout) and db (Cout,), float32.
// Three launches on the stream; returns -1 when n_slots is not
// conv3d_rfab_bwd_slots() of the call.
int conv3d_rfab_bwd_f32(const float* x, int B, int H, int W, int T, int C, const float* w,
                        const float* g, int Cout, int pad, float* dx, float* dw, float* db,
                        float* work, int n_slots, cudaStream_t stream) {
  return launch_bwd_f32(x, B, H, W, T, C, w, g, Cout, pad, dx, dw, db, work, n_slots, stream);
}

// The same on bfloat16 x, w, g and dx (16-bit patterns); dw and db float32;
// n_slots is conv3d_rfab_bwd_bf16_slots() of the call.
int conv3d_rfab_bwd_bf16(const uint16_t* x, int B, int H, int W, int T, int C,
                         const uint16_t* w, const uint16_t* g, int Cout, int pad,
                         uint16_t* dx, float* dw, float* db, float* work, int n_slots,
                         cudaStream_t stream) {
  return launch_bwd_tc(x, B, H, W, T, C, w, g, Cout, pad, dx, dw, db, work, n_slots, stream);
}

}  // extern "C"
