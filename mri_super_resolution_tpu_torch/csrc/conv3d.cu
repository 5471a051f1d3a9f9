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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv3d.so conv3d.cu   (see ops/_build.py)

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
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
template <typename T>
__global__ void __launch_bounds__(NT, 2) conv3d_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ out, int H, int W, int Tin, int C, int Cout, int pad, int Ho,
    int Wo, int To, int tiles_w, int tiles_hw) {
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
      s_w[i] = co < Cout ? to_f32(w[((long long)tap * C + c0 + cl) * Cout + co]) : 0.f;
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
  for (int k = 0; k < 8; ++k) bv[k] = bias[co0 + k];
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
           int Cout, int pad, T* out, cudaStream_t stream) {
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
      x, w, bias, out, H, W, Tin, C, Cout, pad, Ho, Wo, To, tiles_w, tiles_hw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Ho, Wo, To, Cout) = conv(x (B, H, W, T, C), w (3, 3, 3, C, Cout)) +
// bias; pad 1 = SAME, 0 = VALID.
int conv3d_rfab_f32(const float* x, int B, int H, int W, int T, int C, const float* w,
                    const float* bias, int Cout, int pad, float* out,
                    cudaStream_t stream) {
  return launch(x, B, H, W, T, C, w, bias, Cout, pad, out, stream);
}

// The same on bfloat16 x, w and out (16-bit patterns); float32 sums.
int conv3d_rfab_bf16(const uint16_t* x, int B, int H, int W, int T, int C,
                     const uint16_t* w, const float* bias, int Cout, int pad,
                     uint16_t* out, cudaStream_t stream) {
  return launch(x, B, H, W, T, C, w, bias, Cout, pad, out, stream);
}

}  // extern "C"
