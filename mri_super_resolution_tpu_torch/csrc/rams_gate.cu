// Hand-written kernels G1 for the channel-attention gate of RAMS's residual
// feature attention block (models/rams.py:RFAB), at inference:
//
//     att = sigmoid(att1(relu(att0(mean(float(x)))))), rounded to x's type
//     out = x * att + res
//
// on channels-last activations viewed as (B, S, C): x the block's second
// conv output, res its input, S = H W T pixels an item, att0 a 1x1x1 conv
// C -> R, att1 R -> C (the effective weight-normed kernels, float32). It
// replaces no TPU kernel: the JAX package leaves the gate to XLA, which
// fuses it; PyTorch's eager chain runs a float32 cast of x, a mean, a
// dozen tiny launches, a product and an add, each over the whole tensor.
//
// What bounds it on an H100: bytes. At the serving shape (25 x 130 x 130 x
// 9 x 32 in bfloat16, 243 MB a tensor) the gate needs x read twice (the
// mean must be complete before any output: two passes), res read once and
// out written once, 973 MB, 0.29 ms at 3.35 TB/s; a few hundred operations a
// pixel at most. The design moves each of those bytes once, 16 bytes a
// thread a load, and nothing else:
//   * sum pass: a block per (slot, item); slot s of item b sums pixels
//     [s span, (s + 1) span) in float32, each thread V channels of every
//     P-th pixel (P = 256 / (C / V) pixels a step, four steps' loads in
//     flight), in pixel order; the block's rows are summed in row order and
//     written to the slot's row of a workspace. No float atomics: the
//     partition and every order depend on (S, C, span) alone, so the
//     results repeat bit for bit. Items run last first: the conv that wrote
//     x finished with the last items, whose bytes may still sit in L2.
//   * gate pass: a block of C threads an item adds its slots in slot order,
//     divides by S, and runs att0 + bias, ReLU, att1 + bias and the sigmoid
//     in float32 (fmaf on the SIMT cores, no TF32), rounding att once to
//     the compute type as the eager chain's .to(x.dtype) does.
//   * apply pass: a thread per V channels of a pixel, round(round(x att) +
//     res) with the product and the sum each rounded to float32 (no
//     contraction) and then to the compute type, as PyTorch's x * att + res
//     rounds: given the same att the output equals the eager chain's bit
//     for bit.
// V is 8 (16-byte loads and stores) when C % 8 == 0 and every pointer a
// pass reads or writes is 16-byte aligned, as at every RFAB of RAMS; else 1
// (an element a load), with the same sums in the same order.
//
// Contract of the entry points (ops/rams_gate.py checks it before calling):
// x, res, out and att share one type, bfloat16 (16-bit patterns) or
// float32; x, res and out are (B, S, C) and att (B, C), all contiguous;
// 1 <= C <= 256; 1 <= R <= C; w0 (C, R), b0 (R,), w1 (R, C), b1 (C,)
// float32; work holds B slots C floats with slots = ceil(S / span). One
// launch sequence on the caller's stream; nothing allocates or
// synchronises; each entry returns cudaGetLastError() (0 on success), -1
// for a call it does not take.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librams_gate.so rams_gate.cu   (see ops/_build.py)

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "launch.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int NT = 256;      // threads of a sum or apply block
constexpr int MAX_C = 256;   // channels: a gate block has one thread each
constexpr int UNROLL = 4;    // sum pass: loads in flight a thread

// the float32 product and sum, each rounded to nearest, never fused
__device__ __forceinline__ float mul_rn(float a, float b) {
#ifdef __CUDACC__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float add_rn(float a, float b) {
#ifdef __CUDACC__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

struct alignas(16) Vec16 {
  unsigned w[4];
};

// eight consecutive channels of T as float32, 16 bytes a load, or one;
// round() the rounding of a float32 value to T
template <typename T>
struct Io;

template <>
struct Io<uint16_t> {
  static __device__ __forceinline__ void load8(const uint16_t* p, float v[8]) {
    const Vec16 a = *reinterpret_cast<const Vec16*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = u2f(a.w[k] << 16);
      v[2 * k + 1] = u2f(a.w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store8(uint16_t* p, const float v[8]) {
    Vec16 a;
#pragma unroll
    for (int k = 0; k < 4; ++k) a.w[k] = bf16x2_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<Vec16*>(p) = a;
  }
  static __device__ __forceinline__ void round8(float v[8]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned w = bf16x2_rn(v[2 * k], v[2 * k + 1]);
      v[2 * k] = u2f(w << 16);
      v[2 * k + 1] = u2f(w & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float load1(const uint16_t* p) { return bf16_to_f32(*p); }
  static __device__ __forceinline__ uint16_t round(float f) {
    return (uint16_t)f32_to_bf16(f);
  }
  static __device__ __forceinline__ float round1(float f) {
    return bf16_to_f32(f32_to_bf16(f));
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ void load8(const float* p, float v[8]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Vec16 a = reinterpret_cast<const Vec16*>(p)[h];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * h + k] = u2f(a.w[k]);
    }
  }
  static __device__ __forceinline__ void store8(float* p, const float v[8]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Vec16 a;
#pragma unroll
      for (int k = 0; k < 4; ++k) a.w[k] = f2u(v[4 * h + k]);
      reinterpret_cast<Vec16*>(p)[h] = a;
    }
  }
  static __device__ __forceinline__ void round8(float*) {}
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float f) { return f; }
  static __device__ __forceinline__ float round1(float f) { return f; }
};

// V consecutive channels: one 16-byte vector (two for float32) for V = 8,
// V single elements otherwise
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float v[V]) {
  if constexpr (V == 8) {
    Io<T>::load8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = Io<T>::load1(p + k);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float v[V]) {
  if constexpr (V == 8) {
    Io<T>::store8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = Io<T>::round(v[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void round_v(float v[V]) {
  if constexpr (V == 8) {
    Io<T>::round8(v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = Io<T>::round1(v[k]);
  }
}

// Grid: x = slot, y = item (last first). blockDim = (C / V) (NT / (C / V)):
// thread t reads channels V (t % L) .. + V of pixels begin + t / L + i P.
// work[b][slot][c] = the slot's float32 sum of channel c.
template <typename T, int V>
__global__ void __launch_bounds__(NT) gate_sum_kernel(const T* __restrict__ x, int S, int C,
                                                      int span, float* __restrict__ work) {
  __shared__ __align__(16) float red[NT * 8];  // [P][C]: each thread's V sums
#ifndef __CUDACC__
  emu_poison_shared(red, sizeof red);
#endif
  const int L = C / V;
  const int P = blockDim.x / L;
  const int g = threadIdx.x % L;
  const int q = threadIdx.x / L;
  const int slot = blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;
  const int begin = slot * span;
  const int end = S - begin < span ? S : begin + span;
  const T* xb = x + (size_t)b * S * C + g * V;
  float s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = 0.f;
  int p = begin + q;
  for (; p + (UNROLL - 1) * P < end; p += UNROLL * P) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_v<T, V>(xb + (size_t)(p + u * P) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] += v[u][k];
  }
  for (; p < end; p += P) {
    float v[V];
    load_v<T, V>(xb + (size_t)p * C, v);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] += v[k];
  }
  float* mine = red + q * C + g * V;
#pragma unroll
  for (int k = 0; k < V; ++k) mine[k] = s[k];
  __syncthreads();
  if ((int)threadIdx.x < C) {
    float acc = 0.f;
    for (int r = 0; r < P; ++r) acc += red[r * C + threadIdx.x];
    work[((size_t)b * gridDim.x + slot) * C + threadIdx.x] = acc;
  }
}

// Grid: x = item; blockDim = C. The slots' sums in slot order, the mean,
// the gate MLP in float32; att[b] rounded to T.
template <typename T>
__global__ void __launch_bounds__(MAX_C) gate_att_kernel(
    const float* __restrict__ work, int slots, int S, int C, const float* __restrict__ w0,
    const float* __restrict__ b0, int R, const float* __restrict__ w1,
    const float* __restrict__ b1, T* __restrict__ att) {
  __shared__ float sm[2 * MAX_C];  // the item's means, then the hidden units
#ifndef __CUDACC__
  emu_poison_shared(sm, sizeof sm);
#endif
  float* const mean_ = sm;
  float* const hid_ = sm + MAX_C;
  const int b = blockIdx.x;
  const int c = threadIdx.x;
  const float* wb = work + (size_t)b * slots * C;
  float acc = 0.f;
  for (int s = 0; s < slots; ++s) acc += wb[(size_t)s * C + c];
  mean_[c] = acc / (float)S;
  __syncthreads();
  if (c < R) {
    float h = 0.f;
    for (int k = 0; k < C; ++k) h = fmaf(mean_[k], w0[k * R + c], h);
    h = h + b0[c];
    hid_[c] = h < 0.f ? 0.f : h;  // ReLU (a NaN stays a NaN, as torch.relu)
  }
  __syncthreads();
  float z = 0.f;
  for (int j = 0; j < R; ++j) z = fmaf(hid_[j], w1[j * C + c], z);
  z = z + b1[c];
  const float a = 1.f / (1.f + expf(-z));  // torch.sigmoid's float32 formula
  att[(size_t)b * C + c] = Io<T>::round(a);
}

// Grid: x = run of NT vectors, y = item; vecs = S C / V vectors an item.
template <typename T, int V>
__global__ void __launch_bounds__(NT) gate_apply_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ att,
                                                        const T* __restrict__ res, int vecs,
                                                        int L, T* __restrict__ out) {
  const int v = blockIdx.x * NT + threadIdx.x;
  if (v >= vecs) return;
  const size_t i = ((size_t)blockIdx.y * vecs + v) * V;
  float xv[V], av[V], rv[V];
  load_v<T, V>(x + i, xv);
  load_v<T, V>(res + i, rv);
  load_v<T, V>(att + ((size_t)blockIdx.y * L + v % L) * V, av);
#pragma unroll
  for (int k = 0; k < V; ++k) xv[k] = mul_rn(xv[k], av[k]);
  round_v<T, V>(xv);
#pragma unroll
  for (int k = 0; k < V; ++k) xv[k] = add_rn(xv[k], rv[k]);
  store_v<T, V>(out + i, xv);
}

int slots_of(int S, int span) { return (int)(((long long)S + span - 1) / span); }

bool takes(int B, int S, int C, int R, int span) {
  return B >= 1 && B <= 65535 && S >= 1 && span >= 1 && C >= 1 && C <= MAX_C && R >= 1 &&
         R <= C && (long long)S + span + (long long)UNROLL * NT < INT_MAX &&
         (long long)S * C + NT < INT_MAX;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int V>
void launch_sum(const T* x, int B, int S, int C, int span, int slots, float* work,
                cudaStream_t stream) {
  const int L = C / V;
  void (*kernel)(const T*, int, int, int, float*) = gate_sum_kernel<T, V>;
  LAUNCH(kernel, dim3(slots, B), L * (NT / L), stream)(x, S, C, span, work);
}

template <typename T>
int launch_att(const T* x, int B, int S, int C, const float* w0, const float* b0, int R,
               const float* w1, const float* b1, int span, float* work, T* att,
               cudaStream_t stream) {
  if (!takes(B, S, C, R, span)) return -1;
  const int slots = slots_of(S, span);
  if (C % 8 == 0 && aligned16(x))
    launch_sum<T, 8>(x, B, S, C, span, slots, work, stream);
  else
    launch_sum<T, 1>(x, B, S, C, span, slots, work, stream);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  LAUNCH(gate_att_kernel<T>, B, C, stream)(work, slots, S, C, w0, b0, R, w1, b1, att);
  return (int)cudaGetLastError();
}

template <typename T, int V>
void launch_apply_v(const T* x, const T* att, const T* res, int B, int S, int C, T* out,
                    cudaStream_t stream) {
  const int vecs = S * (C / V);
  void (*kernel)(const T*, const T*, const T*, int, int, T*) = gate_apply_kernel<T, V>;
  LAUNCH(kernel, dim3((vecs + NT - 1) / NT, B), NT, stream)(x, att, res, vecs, C / V, out);
}

template <typename T>
int launch_apply(const T* x, const T* att, const T* res, int B, int S, int C, T* out,
                 cudaStream_t stream) {
  if (!takes(B, S, C, 1, 1)) return -1;
  if (C % 8 == 0 && aligned16(x) && aligned16(att) && aligned16(res) && aligned16(out))
    launch_apply_v<T, 8>(x, att, res, B, S, C, out, stream);
  else
    launch_apply_v<T, 1>(x, att, res, B, S, C, out, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The sum and gate passes: att (B, C) in x's type from x (B, S, C); work
// holds the slots' sums, B ceil(S / span) C floats.
int rams_gate_att_bf16(const uint16_t* x, int B, int S, int C, const float* w0,
                       const float* b0, int R, const float* w1, const float* b1, int span,
                       float* work, uint16_t* att, cudaStream_t stream) {
  return launch_att(x, B, S, C, w0, b0, R, w1, b1, span, work, att, stream);
}

int rams_gate_att_f32(const float* x, int B, int S, int C, const float* w0, const float* b0,
                      int R, const float* w1, const float* b1, int span, float* work,
                      float* att, cudaStream_t stream) {
  return launch_att(x, B, S, C, w0, b0, R, w1, b1, span, work, att, stream);
}

// The apply pass: out = round(round(x att) + res), (B, S, C).
int rams_gate_apply_bf16(const uint16_t* x, const uint16_t* att, const uint16_t* res, int B,
                         int S, int C, uint16_t* out, cudaStream_t stream) {
  return launch_apply(x, att, res, B, S, C, out, stream);
}

int rams_gate_apply_f32(const float* x, const float* att, const float* res, int B, int S, int C,
                        float* out, cudaStream_t stream) {
  return launch_apply(x, att, res, B, S, C, out, stream);
}

}  // extern "C"
