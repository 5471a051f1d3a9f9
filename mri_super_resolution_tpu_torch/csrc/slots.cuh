// What the one-pass K1 kernels that keep a slot a block share
// (csrc/siren_resident.cu, csrc/siren_stream.cu): the per-layer activation
// codes, each activation with its factor for the backward, and the second
// launch that sums the blocks' slots in block order (no float atomics: a
// call repeats bit for bit).

#pragma once

#include "common.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_SINE = 1, ACT_RELU = 2 };

// a = act(z) and its factor act'(z) (omega cos(omega z) for sine, the step
// z > 0 for ReLU, 1 for none), as the SIMT epilogues compute them
__device__ __forceinline__ void act_and_factor(int act, float omega, float z, float& a,
                                               float& f) {
  if (act == ACT_SINE) {
    float s, c;
    sincosf(omega * z, &s, &c);
    a = s;
    f = omega * c;
  } else if (act == ACT_RELU) {
    a = z > 0.f ? z : 0.f;
    f = z > 0.f ? 1.f : 0.f;
  } else {
    a = z;
    f = 1.f;
  }
}

// out[i] = the sum over the blocks' slots (n_params + 2 floats each) in
// block order (i < n_params: the grads; n_params: the loss, times inv_n) or
// their max (n_params + 1: max |out|)
__global__ void slot_reduce_kernel(const float* __restrict__ partial, int blocks, int n_params,
                                   float inv_n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int count = n_params + 2;
  if (i >= count) return;
  float s = 0.f;
  if (i == n_params + 1) {
    for (int z = 0; z < blocks; ++z) {
      const float v = partial[(long long)z * count + i];
      s = v > s ? v : s;
    }
  } else {
    for (int z = 0; z < blocks; ++z) s += partial[(long long)z * count + i];
    if (i == n_params) s *= inv_n;
  }
  out[i] = s;
}

}  // namespace
