// The launch macros every csrc/*.cu uses: LAUNCH for static shared memory,
// LAUNCH_SMEM for a dynamic size. A host compiler (the CPU emulation under
// tests/cuda_emulation) defines LAUNCH itself, and its kernels keep their
// shared memory in static arrays, so LAUNCH_SMEM drops the size there.

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
