// The bf16x3 tensor-core GEMM main loop of the hand-written Hopper kernels
// csrc/siren_tc.cu (K1-K3) and csrc/wire_tc.cu (K4), with what both use
// around it: the 128 x 128 block tile of 8 warps (64 x 32 a warp: 4 x 4
// mma tiles, 64 float32 sums a thread), 32 of depth a stage, two stages of
// hi/lo bf16 planes filled by cp.async of 16 bytes (81,920 bytes, so that
// two blocks share an SM), ldmatrix fragments and three mma.sync m16n8k16
// a tile and k16 step (hi hi + hi lo + lo hi, float32 sums); the planes'
// split and store, their split-K plan and column sums. Each kernel runs
// gemm3_products and then its own epilogue on the accumulators.
//
// Operands: depth-contiguous ones (A_KC / B_KC) are (rows, K) arrays of row
// length lda / ldb, read with ldmatrix; row-contiguous ones are (K, cols)
// arrays, read with ldmatrix.trans. Rows of A past M and depth past this
// block's range read as zeros. Grid: x = column tile, y = row tile, z =
// split of the depth (k_split a multiple of TK). Shared rows are padded by
// 16 bytes, so the eight rows of an ldmatrix matrix fall in distinct banks.

#pragma once

#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int TC_TILE = 128;  // block tile rows and columns; widths are multiples of it
constexpr int TK = 32;        // depth a stage
constexpr int TC_NT = 256;    // threads: 8 warps, 2 along rows x 4 along columns
constexpr int TC_STAGES = 2;
constexpr int KROW = TK + 8;          // halves a row of a depth-contiguous tile
constexpr int MROW = TC_TILE + 8;     // halves a row of a row-contiguous tile
constexpr int PLANE = TC_TILE * KROW;  // halves a tile plane (>= TK * MROW)
constexpr int STAGE = 4 * PLANE;       // A hi, A lo, B hi, B lo
constexpr int TC_SMEM = TC_STAGES * STAGE * 2;  // bytes: 81,920
constexpr int TC_TARGET_BLOCKS = 2 * 132;  // two blocks on each SM

// two bf16 planes of one (rows, cols) array: x = hi + lo
struct Planes {
  const uint16_t* hi;
  const uint16_t* lo;
};

__device__ __forceinline__ void split_bf16(float x, unsigned& hi, unsigned& lo) {
  hi = f32_to_bf16(x);
  lo = f32_to_bf16(x - bf16_to_f32(hi));
}

__device__ __forceinline__ void store_planes(uint16_t* hi, uint16_t* lo, long long off,
                                             float v0, float v1) {
  unsigned h0, l0, h1, l1;
  split_bf16(v0, h0, l0);
  split_bf16(v1, h1, l1);
  *reinterpret_cast<unsigned*>(hi + off) = h0 | (h1 << 16);
  *reinterpret_cast<unsigned*>(lo + off) = l0 | (l1 << 16);
}

// acc[i][j][2 h + e] = the block tile's sum of Aop Bop at row wm + 16 i +
// lane / 4 + 8 h, column wn + 8 j + 2 (lane % 4) + e, where warp = tid / 32,
// wm = (warp / 4) * 64 and wn = (warp % 4) * 32; smem3: TC_SMEM bytes.
template <bool A_KC, bool B_KC>
__device__ __forceinline__ void gemm3_products(Planes A, int lda, Planes B, int ldb, int M,
                                               int N, int K, int k_split, uint16_t* smem3,
                                               float (&acc)[4][4][4]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * TC_TILE;
  const int n0 = blockIdx.x * TC_TILE;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  // depth-contiguous tile: rows r0 .. r0 + 127 (zero from rmax), depth k0 ..
  // k0 + 31, row stride KROW
  auto load_kc = [&](uint16_t* dh, uint16_t* dl, Planes src, int ld, int r0, int rmax,
                     int k0) {
    for (int i = tid; i < TC_TILE * 4; i += TC_NT) {
      const int r = i >> 2, c = (i & 3) * 8;
      const bool ok = r0 + r < rmax;
      const long long off = ok ? (long long)(r0 + r) * ld + k0 + c : 0;
      cp_async16(dh + r * KROW + c, src.hi + off, ok);
      cp_async16(dl + r * KROW + c, src.lo + off, ok);
    }
  };
  // row-contiguous tile: depth rows k0 .. k0 + 31 (zero from kmax), columns
  // c0 .. c0 + 127, row stride MROW
  auto load_rc = [&](uint16_t* dh, uint16_t* dl, Planes src, int ld, int k0, int kmax,
                     int c0) {
    for (int i = tid; i < TK * 16; i += TC_NT) {
      const int k = i >> 4, c = (i & 15) * 8;
      const bool ok = k0 + k < kmax;
      const long long off = ok ? (long long)(k0 + k) * ld + c0 + c : 0;
      cp_async16(dh + k * MROW + c, src.hi + off, ok);
      cp_async16(dl + k * MROW + c, src.lo + off, ok);
    }
  };
  auto load_stage = [&](int kt) {
    uint16_t* s = smem3 + (kt % TC_STAGES) * STAGE;
    const int k0 = kb + kt * TK;
    if (A_KC) {
      load_kc(s, s + PLANE, A, lda, m0, M, k0);
    } else {
      load_rc(s, s + PLANE, A, lda, k0, ke, m0);
    }
    if (B_KC) {
      load_kc(s + 2 * PLANE, s + 3 * PLANE, B, ldb, n0, N, k0);
    } else {
      load_rc(s + 2 * PLANE, s + 3 * PLANE, B, ldb, k0, ke, n0);
    }
  };

  // this lane's ldmatrix row addresses (in halves, within a plane) for k16
  // step 0; step 1 is 16 halves (KC) or 16 rows (RC) further
  const int q = lane >> 3;  // the 8 x 8 matrix this lane addresses
  int a_off[4], b_off[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a_off[i] = A_KC ? (wm + i * 16 + (lane & 15)) * KROW + (lane >> 4) * 8
                    : ((q >> 1) * 8 + (lane & 7)) * MROW + wm + i * 16 + (q & 1) * 8;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    b_off[jj] = B_KC ? (wn + jj * 16 + (q >> 1) * 8 + (lane & 7)) * KROW + (q & 1) * 8
                     : ((q & 1) * 8 + (lane & 7)) * MROW + wn + jj * 16 + (q >> 1) * 8;
  constexpr int A_STEP = A_KC ? 16 : 16 * MROW;
  constexpr int B_STEP = B_KC ? 16 : 16 * MROW;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (ke - kb + TK - 1) / TK;
  for (int t = 0; t < TC_STAGES - 1; ++t) {
    if (t < nk) load_stage(t);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + TC_STAGES - 1 < nk) load_stage(kt + TC_STAGES - 1);  // into kt - 1's slot
    cp_async_commit();
    const uint16_t* s = smem3 + (kt % TC_STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      unsigned ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint16_t* p = s + a_off[i] + ks * A_STEP;
        if (A_KC) {
          ldsm_x4(ah[i], p);
          ldsm_x4(al[i], p + PLANE);
        } else {
          ldsm_x4_trans(ah[i], p);
          ldsm_x4_trans(al[i], p + PLANE);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const uint16_t* p = s + 2 * PLANE + b_off[jj] + ks * B_STEP;
        unsigned rh[4], rl[4];
        if (B_KC) {
          ldsm_x4(rh, p);
          ldsm_x4(rl, p + PLANE);
        } else {
          ldsm_x4_trans(rh, p);
          ldsm_x4_trans(rl, p + PLANE);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bh[2 * jj + h][0] = rh[2 * h];
          bh[2 * jj + h][1] = rh[2 * h + 1];
          bl[2 * jj + h][0] = rl[2 * h];
          bl[2 * jj + h][1] = rl[2 * h + 1];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], ah[i], bl[j]);
          mma_bf16(acc[i][j], al[i], bh[j]);
          mma_bf16(acc[i][j], ah[i], bh[j]);
        }
    }
  }
}

// partial[z, j] = sum over the rows p of split z of hi[p, j] + lo[p, j]
__global__ void __launch_bounds__(COLSUM_THREADS) colsum_planes_kernel(
    Planes X, int P, int N, int rows_per_split, float* __restrict__ partial) {
  const int j = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (j >= N) return;
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = min((long long)P, r0 + rows_per_split);
  float s = 0.f;
  for (long long p = r0; p < r1; ++p)
    s += bf16_to_f32(X.hi[p * N + j]) + bf16_to_f32(X.lo[p * N + j]);
  partial[(long long)blockIdx.y * N + j] = s;
}

// Split-K plan of a dW pass (M x N output, depth P): one wave of blocks.
SplitPlan dw_plan(int M, int N, int P) {
  const int tiles = (M / TC_TILE) * (N / TC_TILE);
  int splits = TC_TARGET_BLOCKS / tiles;
  if (splits < 1) splits = 1;
  const int k_split = cdiv(cdiv(P, splits), TK) * TK;
  return {cdiv(P, k_split), k_split};
}

}  // namespace
