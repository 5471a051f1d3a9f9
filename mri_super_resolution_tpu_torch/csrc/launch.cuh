// The launch macros every csrc/*.cu uses: LAUNCH for static shared memory,
// LAUNCH_SMEM for a dynamic size, LAUNCH_COOP for a cooperative launch (every
// block resident at once, so that blocks may wait on each other; it returns
// the launch's cudaError_t). A host compiler (the CPU emulation under
// tests/cuda_emulation) defines LAUNCH and LAUNCH_COOP itself, and its
// kernels keep their shared memory in static arrays or in the emulation's
// per-block window, so LAUNCH_SMEM drops the size there.

#pragma once

#include <cuda_runtime.h>

#ifndef LAUNCH
#define LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif

#ifdef __CUDACC__
#define LAUNCH_SMEM(kernel, grid, block, smem, stream) \
  kernel<<<(grid), (block), (smem), (stream)>>>
#else
#define LAUNCH_SMEM(kernel, grid, block, smem, stream) LAUNCH(kernel, grid, block, stream)
#endif

#ifdef __CUDACC__
template <class... P, class... A>
cudaError_t launch_cooperative(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                               cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
#define LAUNCH_COOP(kernel, grid, block, smem, stream, ...) \
  launch_cooperative(kernel, dim3(grid), dim3(block), (smem), (stream), __VA_ARGS__)
#endif
