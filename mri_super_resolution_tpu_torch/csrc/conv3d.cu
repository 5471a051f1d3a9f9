// Hand-written Hopper (sm_90a) kernel K6 for the RAMS convolutions.
//
// Replaces conv3d_rfab of mri_super_resolution_tpu/ops/pallas/conv3d_kernel.py
// (def :109, pallas_call :133): a 3x3x3 convolution plus bias on
// channels-last (B, H, W, T, C) activations, SAME (zero padding of 1 in H, W
// and T) or VALID, with the kernel (3, 3, 3, C, Cout) in spatial order
// (H, W, T).
//
// Contract of the two entry points (the wrapper in ops/conv3d_kernel.py
// checks it before calling):
//   * x, w and out share one type, bfloat16 (as its 16-bit patterns) or
//     float32; bias is float32 (Cout,); all row-major and contiguous, x and
//     out 16-byte aligned;
//   * C and Cout are multiples of 8 (the gate of models/rams.py:123-128);
//   * each product is formed in float32 from the stored values and summed in
//     float32; the float32 bias is added last and the result rounded once
//     to the output type (to nearest even for bfloat16);
//   * one launch on the caller's stream; nothing allocates or synchronises;
//     each entry point returns cudaGetLastError() (0 on success).
//
// What bounds it on an H100: operations. The RAMS serving call (25 x 130 x
// 130 x 9 outputs, C = Cout = 32) is 210 GFLOP against 0.49 GB of
// compulsory traffic in bfloat16: 0.21 ms at the 989 TFLOP/s bf16
// tensor-core rate, 0.15 ms at 3.35 TB/s. This kernel does not use the
// tensor cores. It is a direct convolution in float32 FMA (67 TFLOP/s, so
// 3.1 ms at best for that call). What the design does:
//   * no im2col. The TPU kernel concatenates the 27 shifted taps into one
//     (M, 27 C) operand in VMEM and computes rows that it then crops. Here a
//     block stages its input halo in shared memory once per channel chunk
//     and reads every tap as a shifted window of it;
//   * a block is one (b, t_out) and a 16 x 32 tile of output pixels for 32
//     output channels; each of its 256 threads keeps 8 rows x 8 channels =
//     64 float32 sums in registers;
//   * input channels go in chunks of 8. A chunk's halo (3 t-planes x 18 x 34
//     pixels) is stored channel-major, so a warp reads 32 consecutive pixels
//     with no bank conflict, and its weights (27 taps x 8 x 32) are read as
//     broadcasts: 86,400 bytes of dynamic shared memory, two blocks per SM;
//   * for each (channel, dz, dx) a thread loads a column of 10 input values
//     once and does 3 x 64 FMAs with it (the three dy reuse the column).
// Tensor cores (mma.sync, then wgmma fed by TMA) are later work.
//
// Hand-written Hopper kernel K7, the backward of K6. Replaces conv3d_rfab_bwd
// of the same Pallas file (def :234, pallas_call :259): given the cotangent
// g of K6's output it returns dx (in x's type), dW (3, 3, 3, C, Cout) and db
// (Cout,) in float32. The TPU kernel walks the batch in order, rebuilds the
// (M, 27 C) operand per (b, t_out) and carries dW and db from one grid step
// to the next. Blocks on Hopper run in no order, so K7 is three launches:
//   * dx is the direct convolution of g with the tap-flipped, in/out
//     transposed kernel (W'[2-dy, 2-dx, 2-dz] = W[dy, dx, dz]^T), padded by
//     1 for a SAME forward and by 2 (the full convolution) for a VALID one:
//     K6's kernel with its weights read flipped and no bias, so the same
//     float32 sums and one rounding. A SAME forward's padded border gets no
//     gradient: the padding-1 convolution has exactly H x W x T outputs;
//   * dW and db: a block owns a run of work items, each one (b, t_out) and
//     an 8 x 16 tile of output pixels; it stages the three input planes'
//     halo (32 input channels) and the g tile in shared memory and adds the
//     tile's share of the (27 C x Cout) product, and db, to registers. Each
//     of its 384 threads owns one input channel, 8 output channels and the
//     9 (dy, dx) taps of one dz: 72 float32 sums, 11 shared-memory reads per
//     72 FMAs. The block writes its sums to its own slot of a workspace;
//   * a second pass adds the slots up in a fixed order. No float atomics, so
//     the results repeat run to run (as K1's split-K dW in common.cuh).
// What bounds K7 on an H100: operations. dx and dW each repeat the forward's
// multiply-adds: the training path's main call (32 x 34 x 34 x 9 outputs,
// C = Cout = 32) is 36.8 GFLOP, 0.037 ms at the bf16 tensor-core rate; these
// are float32 FMA loops, so 0.55 ms at the 67 TFLOP/s SIMT peak at best.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv3d.so conv3d.cu   (see ops/_build.py)

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#define LAUNCH_SMEM(kernel, grid, block, smem, stream) \
  kernel<<<(grid), (block), (smem), (stream)>>>
#else  // a host compiler (the CPU emulation): shared memory is a static array
#define LAUNCH_SMEM(kernel, grid, block, smem, stream) LAUNCH(kernel, grid, block, stream)
#endif

namespace {

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

__device__ __forceinline__ unsigned f2u(float f) {
#ifdef __CUDACC__
  return __float_as_uint(f);
#else
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
#endif
}

__device__ __forceinline__ float u2f(unsigned u) {
#ifdef __CUDACC__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

// bfloat16 bits -> float32 (exact) and float32 -> bfloat16 bits, rounded to
// nearest even (a NaN stays a NaN), as torch and XLA round.
__device__ __forceinline__ float bf16_to_f32(unsigned h) { return u2f(h << 16); }

__device__ __forceinline__ unsigned f32_to_bf16(float f) {
  unsigned u = f2u(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) { return bf16_to_f32(v); }

// eight consecutive values (16 or 32 bytes, 16-byte aligned) <-> float32
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const Bits128 lo = reinterpret_cast<const Bits128*>(p)[0];
  const Bits128 hi = reinterpret_cast<const Bits128*>(p)[1];
  v[0] = u2f(lo.a), v[1] = u2f(lo.b), v[2] = u2f(lo.c), v[3] = u2f(lo.d);
  v[4] = u2f(hi.a), v[5] = u2f(hi.b), v[6] = u2f(hi.c), v[7] = u2f(hi.d);
}

__device__ __forceinline__ void load8(const uint16_t* p, float v[8]) {
  const Bits128 q = *reinterpret_cast<const Bits128*>(p);
  const unsigned u[4] = {q.a, q.b, q.c, q.d};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = u2f(u[i] << 16);  // little-endian: element 2i is the low half
    v[2 * i + 1] = u2f(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<Bits128*>(p)[0] = {f2u(v[0]), f2u(v[1]), f2u(v[2]), f2u(v[3])};
  reinterpret_cast<Bits128*>(p)[1] = {f2u(v[4]), f2u(v[5]), f2u(v[6]), f2u(v[7])};
}

__device__ __forceinline__ void store8(uint16_t* p, const float v[8]) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = f32_to_bf16(v[2 * i]) | (f32_to_bf16(v[2 * i + 1]) << 16);
  *reinterpret_cast<Bits128*>(p) = {u[0], u[1], u[2], u[3]};
}

// Grid: x = output-channel block x tile row x tile column, y = t_out, z = b.
// flip = 0: w is (3, 3, 3, C, Cout). flip = 1 (K7's dx): w is a forward
// kernel (3, 3, 3, Cout, C), read as W'[tap][c][co] = w[26 - tap][co][c].
// bias may be null (no bias).
template <typename T>
__global__ void __launch_bounds__(NT, 2) conv3d_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ out, int H, int W, int Tin, int C, int Cout, int pad, int Ho,
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
      s_w[i] = co < Cout ? to_f32(w[wi]) : 0.f;
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

template <typename T>
int launch(const T* x, int B, int H, int W, int Tin, int C, const T* w, const float* bias,
           int Cout, int pad, int flip, T* out, cudaStream_t stream) {
  const int Ho = H + 2 * pad - 2;
  const int Wo = W + 2 * pad - 2;
  const int To = Tin + 2 * pad - 2;
  const int tiles_w = (Wo + TW - 1) / TW;
  const int tiles_hw = tiles_w * ((Ho + TH - 1) / TH);
  const dim3 grid(tiles_hw * ((Cout + CO - 1) / CO), To, B);
#ifdef __CUDACC__
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
#endif
  LAUNCH_SMEM(conv3d_kernel<T>, grid, NT, SMEM_BYTES, stream)(
      x, w, bias, out, H, W, Tin, C, Cout, pad, Ho, Wo, To, tiles_w, tiles_hw, flip);
  return (int)cudaGetLastError();
}

// ---- K7: dW and db ---------------------------------------------------------

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
template <typename T>
__global__ void __launch_bounds__(GNT, 1) conv3d_wgrad_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int H,
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

template <typename T>
int launch_bwd(const T* x, int B, int H, int W, int Tin, int C, const T* w, const T* g,
               int Cout, int pad, T* dx, float* dw, float* db, float* work, int n_slots,
               cudaStream_t stream) {
  int tiles_w, tiles_hw;
  const int n_items = wgrad_items(B, H, W, Tin, pad, &tiles_w, &tiles_hw);
  if (n_slots != splits(n_items)) return -1;  // the workspace was sized for another call
  const int per_split = (n_items + n_slots - 1) / n_slots;

  // dx: the convolution of g (B, Ho, Wo, To, Cout) with the flipped kernel
  const int pad_dx = 2 - pad;
  int e = launch(g, B, H + 2 * pad - 2, W + 2 * pad - 2, Tin + 2 * pad - 2, Cout, w,
                 static_cast<const float*>(nullptr), C, pad_dx, 1, dx, stream);
  if (e != 0) return e;

  const int co_blocks = (Cout + GCO - 1) / GCO;
  const dim3 grid(n_slots, ((C + GC - 1) / GC) * co_blocks);
#ifdef __CUDACC__
  const cudaError_t a = cudaFuncSetAttribute(
      conv3d_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
#endif
  LAUNCH_SMEM(conv3d_wgrad_kernel<T>, grid, GNT, GSMEM_BYTES, stream)(
      x, g, work, H, W, Tin, C, Cout, pad, H + 2 * pad - 2, W + 2 * pad - 2,
      Tin + 2 * pad - 2, tiles_w, tiles_hw, n_items, per_split, co_blocks);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int n_w = 27 * C * Cout;
  LAUNCH(conv3d_wgrad_reduce, (n_w + Cout + 255) / 256, 256, stream)(
      work, n_slots, n_w, Cout, dw, db);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Ho, Wo, To, Cout) = conv(x (B, H, W, T, C), w (3, 3, 3, C, Cout)) +
// bias; pad 1 = SAME, 0 = VALID.
int conv3d_rfab_f32(const float* x, int B, int H, int W, int T, int C, const float* w,
                    const float* bias, int Cout, int pad, float* out,
                    cudaStream_t stream) {
  return launch(x, B, H, W, T, C, w, bias, Cout, pad, 0, out, stream);
}

// The same on bfloat16 x, w and out (16-bit patterns); float32 sums.
int conv3d_rfab_bf16(const uint16_t* x, int B, int H, int W, int T, int C,
                     const uint16_t* w, const float* bias, int Cout, int pad,
                     uint16_t* out, cudaStream_t stream) {
  return launch(x, B, H, W, T, C, w, bias, Cout, pad, 0, out, stream);
}

// Workspace slots of conv3d_rfab_bwd_* for x (B, H, W, T, .) and pad; the
// caller passes a float32 workspace of slots x (27 C Cout + Cout).
int conv3d_rfab_bwd_slots(int B, int H, int W, int T, int pad) {
  int tiles_w, tiles_hw;
  return splits(wgrad_items(B, H, W, T, pad, &tiles_w, &tiles_hw));
}

// K7: the gradients of conv3d_rfab_f32 for the cotangent g (B, Ho, Wo, To,
// Cout): dx (B, H, W, T, C), dw (3, 3, 3, C, Cout) and db (Cout,), float32.
// Three launches on the stream; returns -1 when n_slots is not
// conv3d_rfab_bwd_slots() of the call.
int conv3d_rfab_bwd_f32(const float* x, int B, int H, int W, int T, int C, const float* w,
                        const float* g, int Cout, int pad, float* dx, float* dw, float* db,
                        float* work, int n_slots, cudaStream_t stream) {
  return launch_bwd(x, B, H, W, T, C, w, g, Cout, pad, dx, dw, db, work, n_slots, stream);
}

// The same on bfloat16 x, w, g and dx (16-bit patterns); dw and db float32.
int conv3d_rfab_bwd_bf16(const uint16_t* x, int B, int H, int W, int T, int C,
                         const uint16_t* w, const uint16_t* g, int Cout, int pad,
                         uint16_t* dx, float* dw, float* db, float* work, int n_slots,
                         cudaStream_t stream) {
  return launch_bwd(x, B, H, W, T, C, w, g, Cout, pad, dx, dw, db, work, n_slots, stream);
}

}  // extern "C"
