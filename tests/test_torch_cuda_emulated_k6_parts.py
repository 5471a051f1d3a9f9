"""The emulation's parts that K6's wgmma kernel (``csrc/conv3d.cu``) brings,
each on a small kernel against a plain version: an unswizzled K-major A
operand read from any row on (``wgmma_desc_plain``) and ``wgmma``
m64n96k16 (a fragment of 48 floats a thread) against a float32 product; a
TMA load from a tensor map of rank 5 (unswizzled, out-of-range elements
zero) against numpy's slicing."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_source

SOURCE = r'''
#include <cstdint>

#include "launch.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int B_BYTES = 96 * 64;  // B: 96 rows of 32 bf16, 64-byte swizzled
constexpr int A_MAX_ROWS = 128;

// d (64 x 96) = A[shift .. shift + 63] B^T over 32 of depth, two k16
// steps; A (rows x 32 bf16) unswizzled, its four 8-channel chunks each
// `rows` 16-byte rows apart.
__global__ void n96_kernel(const uint16_t* a, int rows, int shift, const uint16_t* b, float* d) {
  alignas(1024) __shared__ unsigned char smem[B_BYTES + 4 * A_MAX_ROWS * 16];
  emu_poison_shared(smem, sizeof smem);
  const int tid = threadIdx.x;
  unsigned char* sb = smem;
  unsigned char* sa = smem + B_BYTES;
  for (int i = tid; i < 96 * 4; i += 128) {
    const int n = i / 4, c = i % 4;
    std::memcpy(sb + n * 64 + ((c ^ ((n >> 1) & 3)) << 4), b + n * 32 + c * 8, 16);
  }
  for (int i = tid; i < rows * 4; i += 128) {
    const int r = i / 4, c = i % 4;
    std::memcpy(sa + c * rows * 16 + r * 16, a + r * 32 + c * 8, 16);
  }
  fence_proxy_async();
  __syncthreads();
  float acc[48];
  for (int i = 0; i < 48; ++i) acc[i] = 0.f;
  wgmma_fence();
  const uint64_t da = wgmma_desc_plain(sa + shift * 16, rows * 16, 128);
  const uint64_t db = wgmma_desc_sw64(sb);
  for (int ks = 0; ks < 2; ++ks)
    wgmma_bf16_m64n96k16(acc, da + ((ks * 2 * rows * 16) >> 4), db + ((ks * 32) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  const int w = tid / 32, l = tid % 32;
  for (int i = 0; i < 12; ++i)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e)
        d[(16 * w + l / 4 + 8 * h) * 96 + 8 * i + 2 * (l % 4) + e] = acc[4 * i + 2 * h + e];
}

// one thread loads the box at c of a (d4, d3, d2, d1, d0) bf16 tensor with
// boxes of box[] into shared memory; the block copies it out
__global__ void tma5_kernel(const uint16_t* src, const int* dims, const int* box, const int* c,
                            uint16_t* dst, int n) {
  alignas(1024) __shared__ unsigned char smem[8192 + 64];
  emu_poison_shared(smem, sizeof smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 8192);
  if (threadIdx.x == 0) {
    uint64_t d[5], s[4];
    unsigned b[5];
    uint64_t stride = 2;
    for (int i = 0; i < 5; ++i) {
      d[i] = dims[i];
      b[i] = box[i];
      if (i < 4) s[i] = stride * dims[i];
      stride *= dims[i];
    }
    CUtensorMap map;
    if (encode_tensor_map(&map, 5, src, d, s, b, 0) != 0) std::abort();
    mbar_init(bar, 1);
    mbar_arrive_expect_tx(bar, 2 * n);
    tma_load_5d(smem, &map, c[0], c[1], c[2], c[3], c[4], bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < n; i += 32) std::memcpy(dst + i, smem + 2 * i, 2);
}

}  // namespace

extern "C" {
int run_tma5(const uint16_t* src, const int* dims, const int* box, const int* c, uint16_t* dst,
             int n) {
  LAUNCH(tma5_kernel, 1, 32, 0)(src, dims, box, c, dst, n);
  return 0;
}
int run_n96(const uint16_t* a, int rows, int shift, const uint16_t* b, float* d) {
  if (rows > A_MAX_ROWS || shift + 64 > rows) return -1;
  LAUNCH(n96_kernel, 1, 128, 0)(a, rows, shift, b, d);
  return 0;
}
}
'''


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run_n96.argtypes = [p, i, i, p, p]
    lib.run_n96.restype = i
    lib.run_tma5.argtypes = [p, p, p, p, p, i]
    lib.run_tma5.restype = i


@pytest.fixture(scope="module")
def emulated_parts(tmp_path_factory):
    return emulated_source(tmp_path_factory, "k6_parts", SOURCE, _declare)


@pytest.mark.parametrize("rows,shift", [
    (64, 0),  # the operand at its start
    (96, 13),  # an odd row shift
    (128, 57),  # the chunks 2 KB apart
])
def test_emulated_wgmma_n96_unswizzled_a(emulated_parts, rows, shift):
    """64 rows of A from row ``shift`` of an unswizzled operand times the
    96 columns of a 64-byte swizzled B, over two k16 steps, equal to the
    float32 product of the same bf16 values."""
    rng = np.random.default_rng(rows + shift)
    a = torch.as_tensor(rng.normal(size=(rows, 32)).astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.normal(size=(96, 32)).astype(np.float32)).bfloat16()
    d = torch.full((64, 96), float("nan"))
    assert emulated_parts.run_n96(a.data_ptr(), rows, shift, b.data_ptr(), d.data_ptr()) == 0
    want = a[shift:shift + 64].float() @ b.float().t()
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [
    (8, 1, -1, -1, 0),  # K6's first box of a SAME plane: the column and row before the image
    (0, 2, 3, 4, 1),  # inside, past the image's last row and column
])
def test_emulated_tma_5d_box(emulated_parts, c):
    """A box of 8 x 1 x 7 x 6 x 1 of a (2, 5, 6, 3, 16) bf16 tensor (as K6
    loads a plane's chunk: channels, a plane, columns, rows, an item) equals
    numpy's slice of the tensor zero-padded around it."""
    shape = (2, 5, 6, 3, 16)  # (B, H, W, T, C); dims innermost first: (C, T, W, H, B)
    box = (8, 1, 7, 6, 1)
    rng = np.random.default_rng(sum(c) + 40)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    dims = torch.tensor(shape[::-1], dtype=torch.int32)
    n = int(np.prod(box))
    dst = torch.full((n,), float("nan"), dtype=torch.bfloat16)
    assert emulated_parts.run_tma5(x.data_ptr(), dims.data_ptr(),
                                 torch.tensor(box, dtype=torch.int32).data_ptr(),
                                 torch.tensor(c, dtype=torch.int32).data_ptr(), dst.data_ptr(),
                                 n) == 0
    o = (1, 6, 8, 1, 8)  # x's place in a zero array with room for every box around it
    pad = np.zeros((4, 17, 19, 5, 24), dtype=np.float32)
    pad[o[0]:o[0] + 2, o[1]:o[1] + 5, o[2]:o[2] + 6, o[3]:o[3] + 3, o[4]:o[4] + 16] = (
        x.float().numpy())
    c0, c1, c2, c3, c4 = c
    want = pad[o[0] + c4:o[0] + c4 + 1, o[1] + c3:o[1] + c3 + 6, o[2] + c2:o[2] + c2 + 7,
               o[3] + c1:o[3] + c1 + 1, o[4] + c0:o[4] + c0 + 8]
    assert np.array_equal(dst.float().numpy().reshape(want.shape), want)
