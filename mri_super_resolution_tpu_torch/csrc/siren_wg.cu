// Hand-written Hopper (sm_90a) SIREN kernels K1, K2 and K3 of the tensor-core
// class of shapes, every hidden-layer product on wgmma fed by TMA: the
// unbatched K1, K2 and K3 with a float32 stash, and the batched K1 (D stacked
// SIRENs on one x) with the Pallas kernel's bf16 stash.
//
// Replaces, for the calls whose widths fit its tiling, the Pallas TPU
// kernels of mri_super_resolution_tpu/ops/pallas/siren_kernel.py:
//   K1 siren_loss_grads (:518, pallas_call at :580): one-pass forward,
//      masked MSE and backward, giving the loss and every dW and db; and K1
//      as jax.vmap runs it over stacked weights, the hybrid tissue fit's four
//      per-TE SIRENs (pipelines/hybrid.py:109-137 of the JAX package);
//   K2 siren_fused's _bwd (:377, pallas_call at :401): the forward again,
//      then an upstream g (P, 1) back to dx and, when asked, every dW, db;
//   K3 siren_forward (:240, pallas_call at :258): the MLP's output (P, 1).
// ops/siren_kernel.py sends it the calls of the tensor-core class of shapes
// (sine on every hidden layer, a linear last layer of one output, the input
// and every hidden width a multiple of 128, the last hidden width at most
// 2,048, at most 15 hidden layers; K1 without sample weights or max |out|);
// csrc/siren.cu's SIMT kernels keep every other call.
//
// Numerics. The forward is float32: each float32 operand is split into hi =
// bf16(x) and lo = bf16(x - hi) (both rounded to nearest even, |x - hi - lo|
// <= 2^-16 |x|) and each product is hi hi + hi lo + lo hi on the tensor cores
// with float32 accumulation (bf16x3); the bias, sin and cos (sincosf, never
// fast math), the last layer's row dot, the residual, the loss and db are
// float32; the chain's deltas are hi/lo planes. What the backward keeps of
// the forward, the stash, is a compile-time parameter of every pass:
//   STASH_F32, the unbatched K1 and K2 (their plain versions are
//     siren_loss_grads_ref and siren_fused_bwd_ref): each layer's input as
//     its hi and lo planes, so that dW = delta^T a is bf16x3 like every other
//     product (three products a k step), and the sine's factor cos(omega z)
//     in float32, the chain multiplying delta by omega * F;
//   STASH_BF16, the batched K1, as the TPU kernel keeps it
//     (siren_kernel.py:196-199, :289, :309, :319): each layer's input as
//     bf16(a) alone (the hi plane), so dW = delta^T bf16(a) is two products a
//     k step (delta hi and delta lo against a's hi), and the factor as
//     bf16(cos(omega z)), multiplied by omega in the chain; the plain version
//     is siren_loss_grads_batched_ref(..., stash="bf16").
// K3 keeps no stash. No atomics anywhere: every sum runs in a fixed order,
// so a call repeats bit for bit, whatever the grid.
//
// What bounds it on an H100: the products. At the 3-D pipeline's 256 ->
// 512x4 -> 1 a row is 917,504 multiply-adds forward, 786,432 in the chain and
// 917,504 in dW; bf16x3 makes each three bf16 products, so K1 on P = 70,000
// rows is 1,101 GFLOP, 1.114 ms at the card's 989 TFLOP/s of dense bf16; K3
// (the forward) 0.390 ms; K2 without dW (the forward, the chain and dx =
// delta_0 W_0) 0.779 ms. The batched K1 at the hybrid's D = 4, P = 100,800,
// its dW two products, is 5.61 TFLOP, 5.67 ms. The bytes the passes move
// (the activations' planes written and read again, F, the deltas' planes)
// overlap the products within each pass; the epilogues (the sine, the
// splits, the staging) add to them.
//
// Design. Every hidden-layer product is one launch of wg_kernel over all D
// slots: a persistent grid walks units of (slot, row tile, column tile)
// (dW: (slot, split of the rows, tile)) in a fixed order, each unit a 128 x
// 128 output tile. A block is one producer warp and two consumer
// warpgroups (64 rows each). The producer's lane 0 keeps a ring of 32-deep
// stages full with TMA box loads (tensor maps built once a call on the
// host; 64-byte swizzled boxes of 32 bf16 rows), each stage's bytes
// completing on its full mbarrier; the consumers run wgmma.m64n128k16 on
// each stage, then release it on its empty mbarrier, so that the next
// unit's loads run under this unit's epilogue. The FWD, CHAIN and DX
// epilogues stage their outputs in 128-byte swizzled shared memory and
// write them with TMA stores that run under the next unit's products, one
// block an SM; the ring takes what the staging leaves (wg_stages: FWD with
// a float32 F stages 128 KB beside three stages, with a bf16 F 96 KB beside
// four, K3's 64 KB beside five; CHAIN and DX four). DW's partials are plain
// stores (two blocks an SM, three stages each). The epilogues set the
// time: global stores from the wgmma fragment layout and software bf16
// rounding each cost more than the products, hence the staging and
// cvt.rn.bf16x2; F's float32 stores from the fragment layout were slower
// than staged ones, even with the deeper ring they would leave room for.
// The operands:
//   FWD   z = a W^T + b: a and W K-major; epilogue the sine, the output's
//         hi/lo planes (the bf16 stash's last hidden layer its hi plane
//         alone; K3's and K2's last none) and F (K3: none); FWD_LAST, the
//         last hidden layer of K1 and K3, also writes each column tile's
//         float32 row dot with the last layer's weights;
//   CHAIN delta_{l-1} = (delta_l W_l) * omega F_{l-1}: W MN-major (the
//         instruction's transpose bit); epilogue the product, delta's
//         planes and (with dW) db_{l-1}'s column sums over the tile's rows;
//   DX    dx = delta_0 W_0 (K2): operands as CHAIN; epilogue the float32
//         product;
//   DW    dW_l = delta_l^T a_l over a split of the rows: delta and a
//         MN-major; epilogue the split's float32 partial.
// Between the forward and the backward, one SIMT launch over the slots (the
// last layer): K1 the row dots' sum plus b, the masked residual and the
// loss, K2 the upstream g; then the last layer's dW and db and the first
// delta of the chain with its db column sums. One launch splits x and every
// slot's W into planes at the start, one sums every partial (dW splits, db
// row tiles, the loss; K3 the row dots into the output) in a fixed order at
// the end.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsiren_wg.so siren_wg.cu   (see ops/_build.py)

#include <vector>

#include "gemm3.cuh"

namespace {

constexpr int WG_BM = 128;  // unit tile rows: two consumer warpgroups of 64
constexpr int WG_BN = 128;  // unit tile columns: one m64n128k16 a warpgroup
constexpr int WG_BK = 32;   // depth a stage: a 64-byte swizzled row of bf16
constexpr int WG_CONSUMERS = 256;              // two warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and the producer warp
constexpr int WG_PLAN_SMS = 132;  // an H100's SMs: the dW split plan (the numbers) uses this
constexpr int WG_TILE_BYTES = WG_BM * WG_BK * 2;  // a 128 x 32 bf16 plane tile: 8 KB
constexpr int WG_BOX_BYTES = WG_BK * WG_BK * 2;   // an MN-major box, 32 x 32: 2 KB
constexpr int WG_STAGE_BYTES = 4 * WG_TILE_BYTES;  // A hi, A lo, B hi, B lo
constexpr int WG_COLSUM_FLOATS = 8 * WG_BN;        // a column sum a consumer warp
constexpr int WG_OUT_BOX = 64 * 128;  // a staged box: 64 rows of 128 bytes (64 bf16, 32 floats)
constexpr int WG_OUT_PLANE = 2 * WG_OUT_BOX;  // a warpgroup's 64 x 128 bf16 output plane
constexpr int WG_OUT_F32 = 4 * WG_OUT_BOX;    // and its 64 x 128 float plane
constexpr int LAST_ROWS = 32;  // rows a chunk of the last-layer kernel
constexpr int LAST_THREADS = 256;
constexpr int LAST_BLOCKS = 128;  // blocks a slot from four slots up; fewer slots, more each
constexpr int LAST_COLS = 4;     // column pairs a thread: widths up to 2,048
constexpr int LAST_MAX_W = 2 * LAST_THREADS * LAST_COLS;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_JOBS = 2 * MAX_LAYERS + 3;

enum WgMode { WG_FWD = 0, WG_FWD_LAST = 1, WG_CHAIN = 2, WG_DW = 3, WG_DX = 4 };
// what the backward keeps of the forward (K3 keeps nothing)
enum WgStash { STASH_BF16 = 0, STASH_F32 = 1, STASH_NONE = 2 };

// A warpgroup's staging: FWD the output's hi and lo planes and F (bf16,
// float, or none in K3), CHAIN delta's planes, DX the float product, DW
// none.
__host__ __device__ constexpr int wg_staging(int mode, int stash) {
  return mode == WG_DW      ? 0
         : mode == WG_CHAIN ? 2 * WG_OUT_PLANE
         : mode == WG_DX    ? WG_OUT_F32
                            : 2 * WG_OUT_PLANE + (stash == STASH_F32    ? WG_OUT_F32
                                                  : stash == STASH_BF16 ? WG_OUT_PLANE
                                                                        : 0);
}

// A pass's ring stages: as many as its staging leaves room for at one block
// an SM (DW: three, at two blocks). A deeper ring keeps more of the next
// unit's loads running under a unit's epilogue.
__host__ __device__ constexpr int wg_stages(int mode, int stash) {
  return mode == WG_DW                              ? 3
         : mode == WG_CHAIN || mode == WG_DX        ? 4
         : stash == STASH_F32                       ? 3
         : stash == STASH_BF16                      ? 4
                                                    : 5;
}

// A pass's shared memory: the ring, both warpgroups' staging, CHAIN's
// column sums, the barriers, and slack to align the ring to 1 KB.
constexpr int wg_smem(int mode, int stash) {
  return wg_stages(mode, stash) * WG_STAGE_BYTES + 2 * wg_staging(mode, stash) +
         (mode == WG_CHAIN ? 4 * WG_COLSUM_FLOATS : 0) + 16 * wg_stages(mode, stash) + 1024;
}
constexpr int wg_blocks_per_sm(int mode) { return mode == WG_DW ? 2 : 1; }

// the largest pass's shared memory (the emulation's static array), within
// the H100's 232,448 bytes a block
constexpr int WG_SMEM_MOST = wg_smem(WG_FWD, STASH_NONE);
static_assert(WG_SMEM_MOST >= wg_smem(WG_FWD, STASH_F32) &&
                  WG_SMEM_MOST >= wg_smem(WG_FWD, STASH_BF16) &&
                  WG_SMEM_MOST >= wg_smem(WG_CHAIN, STASH_F32) &&
                  WG_SMEM_MOST >= wg_smem(WG_DX, STASH_F32) && WG_SMEM_MOST <= 232448,
              "a pass's shared memory");

// the last-layer kernel's blocks a slot: 512 over the slots (at least
// LAST_BLOCKS), so that one slot fills the card too
inline int last_blocks(int D) { return D >= 4 ? LAST_BLOCKS : LAST_BLOCKS * (4 / D); }

// One pass over the D slots. Per slot the output is M x N over depth K (FWD,
// CHAIN, DX: M = P rows; DW: M = d_out, N = d_in, K = P). The slot strides
// are elements of each array between consecutive slots.
struct WgPass {
  int M, N, K;
  int units;           // D x row tiles x column tiles (DW: x splits)
  int splits, k_split;  // DW: splits of the depth and the rows of each
  int a_shared, b_shared;  // the operand (x) is one array for every slot
  float omega;             // FWD: this layer's; CHAIN: the factor's layer's
  const float* bias;       // FWD
  long long bias_slot;
  const float* w_last;  // FWD_LAST: the last layer's weights (N of them)
  long long wl_slot;
  int store_hi, store_lo, store_f;  // FWD: which of the output's planes and F go out
  const void* F;  // CHAIN: the factor, bf16 or float (M, N) a slot
  long long f_slot;
  float* part;  // FWD_LAST: row dots (N / 128, M); CHAIN: db's (row tiles, N), or null
                // (no db); DW: (splits, M, N)
  long long part_slot;
};

struct Unit {
  int slot, m0, n0, kb, ke, tile_row, tile_col, split;
};

__device__ __forceinline__ Unit unit_of(const WgPass& a, int MODE, int u) {
  Unit t;
  if (MODE == WG_DW) {
    const int ntn = a.N / WG_BN, tiles = (a.M / WG_BM) * ntn;
    const int tile = u % tiles;
    t.split = (u / tiles) % a.splits;
    t.slot = u / (tiles * a.splits);
    t.tile_row = tile / ntn;
    t.tile_col = tile % ntn;
    t.kb = t.split * a.k_split;
    t.ke = min(a.K, t.kb + a.k_split);
  } else {
    const int nct = a.N / WG_BN, nrt = (a.M + WG_BM - 1) / WG_BM;
    t.tile_col = u % nct;
    t.tile_row = (u / nct) % nrt;
    t.slot = u / (nct * nrt);
    t.split = 0;
    t.kb = 0;
    t.ke = a.K;
  }
  t.m0 = t.tile_row * WG_BM;
  t.n0 = t.tile_col * WG_BN;
  return t;
}

// The producer's loads of one stage: FWD A (k0, m0) and B (k0, n0) K-major
// 128-row boxes; CHAIN and DX A K-major, B four MN-major 32 x 32 boxes along
// N; DW A four MN-major boxes along M (hi and lo), B four along N (hi, and
// with the float32 stash lo).
template <int MODE, int STASH>
__device__ __forceinline__ void load_stage(unsigned char* s, const CUtensorMap* mA_hi,
                                           const CUtensorMap* mA_lo, const CUtensorMap* mB_hi,
                                           const CUtensorMap* mB_lo, const Unit& t, int a_slot,
                                           int b_slot, int k0, uint64_t* bar) {
  unsigned char* a_hi = s;
  unsigned char* a_lo = s + WG_TILE_BYTES;
  unsigned char* b_hi = s + 2 * WG_TILE_BYTES;
  unsigned char* b_lo = s + 3 * WG_TILE_BYTES;
  if (MODE == WG_DW) {
    mbar_arrive_expect_tx(bar, (STASH == STASH_F32 ? 4 : 3) * WG_TILE_BYTES);
    for (int j = 0; j < 4; ++j) {
      tma_load_3d(a_hi + j * WG_BOX_BYTES, mA_hi, t.m0 + 32 * j, k0, a_slot, bar);
      tma_load_3d(a_lo + j * WG_BOX_BYTES, mA_lo, t.m0 + 32 * j, k0, a_slot, bar);
      tma_load_3d(b_hi + j * WG_BOX_BYTES, mB_hi, t.n0 + 32 * j, k0, b_slot, bar);
      if (STASH == STASH_F32)
        tma_load_3d(b_lo + j * WG_BOX_BYTES, mB_lo, t.n0 + 32 * j, k0, b_slot, bar);
    }
    return;
  }
  mbar_arrive_expect_tx(bar, 4 * WG_TILE_BYTES);
  tma_load_3d(a_hi, mA_hi, k0, t.m0, a_slot, bar);
  tma_load_3d(a_lo, mA_lo, k0, t.m0, a_slot, bar);
  if (MODE == WG_CHAIN || MODE == WG_DX) {
    for (int j = 0; j < 4; ++j) {
      tma_load_3d(b_hi + j * WG_BOX_BYTES, mB_hi, t.n0 + 32 * j, k0, b_slot, bar);
      tma_load_3d(b_lo + j * WG_BOX_BYTES, mB_lo, t.n0 + 32 * j, k0, b_slot, bar);
    }
  } else {
    tma_load_3d(b_hi, mB_hi, k0, t.n0, b_slot, bar);
    tma_load_3d(b_lo, mB_lo, k0, t.n0, b_slot, bar);
  }
}

// One stage's products for warpgroup g: two k16 steps, bf16x3 (hi lo + lo
// hi + hi hi; DW: delta lo a hi + delta hi a lo + delta hi a hi) or, DW
// with the bf16 stash, its two (delta lo a hi + delta hi a hi); `first`:
// the unit's first stage (its first product overwrites acc).
template <int MODE, int STASH>
__device__ __forceinline__ void stage_products(const unsigned char* s, int g, bool first,
                                               float (&acc)[64]) {
  const unsigned char* a_hi = s;
  const unsigned char* a_lo = s + WG_TILE_BYTES;
  const unsigned char* b_hi = s + 2 * WG_TILE_BYTES;
  const unsigned char* b_lo = s + 3 * WG_TILE_BYTES;
#pragma unroll
  for (int ks = 0; ks < WG_BK / 16; ++ks) {
    const int keep = (first && ks == 0) ? 0 : 1;
    if (MODE == WG_DW) {
      // A: rows 64 g .. 64 g + 63 of M are boxes 2 g and 2 g + 1
      const int ao = 2 * g * WG_BOX_BYTES + ks * 1024;
      const uint64_t dah = wgmma_desc_sw64(a_hi + ao, WG_BOX_BYTES);
      const uint64_t dal = wgmma_desc_sw64(a_lo + ao, WG_BOX_BYTES);
      const uint64_t dbh = wgmma_desc_sw64(b_hi + ks * 1024, WG_BOX_BYTES);
      wgmma_bf16_m64n128k16_t<1, 1>(acc, dal, dbh, keep);
      if (STASH == STASH_F32)
        wgmma_bf16_m64n128k16_t<1, 1>(acc, dah, wgmma_desc_sw64(b_lo + ks * 1024, WG_BOX_BYTES),
                                      1);
      wgmma_bf16_m64n128k16_t<1, 1>(acc, dah, dbh, 1);
    } else {
      const int ao = g * 64 * 64 + ks * 32;  // 64 rows of 64 bytes a warpgroup
      const uint64_t dah = wgmma_desc_sw64(a_hi + ao);
      const uint64_t dal = wgmma_desc_sw64(a_lo + ao);
      if (MODE == WG_CHAIN || MODE == WG_DX) {
        const uint64_t dbh = wgmma_desc_sw64(b_hi + ks * 1024, WG_BOX_BYTES);
        const uint64_t dbl = wgmma_desc_sw64(b_lo + ks * 1024, WG_BOX_BYTES);
        wgmma_bf16_m64n128k16_t<0, 1>(acc, dah, dbl, keep);
        wgmma_bf16_m64n128k16_t<0, 1>(acc, dal, dbh, 1);
        wgmma_bf16_m64n128k16_t<0, 1>(acc, dah, dbh, 1);
      } else {
        const uint64_t dbh = wgmma_desc_sw64(b_hi + ks * 32);
        const uint64_t dbl = wgmma_desc_sw64(b_lo + ks * 32);
        wgmma_bf16_m64n128k16_t<0, 0>(acc, dah, dbl, keep);
        wgmma_bf16_m64n128k16_t<0, 0>(acc, dal, dbh, 1);
        wgmma_bf16_m64n128k16_t<0, 0>(acc, dah, dbh, 1);
      }
    }
  }
}

// the hi and lo words of two floats: hi = bf16(v0) | bf16(v1) << 16 and lo
// the same of v - f32(hi), all rounded to nearest even (split_bf16's planes)
__device__ __forceinline__ void split_pair(float v0, float v1, unsigned& hi, unsigned& lo) {
  hi = bf16x2_rn(v0, v1);
  lo = bf16x2_rn(v0 - bf16_to_f32(hi & 0xffffu), v1 - bf16_to_f32(hi >> 16));
}

// A warpgroup's staged 64 x 128 bf16 output plane: two 64 x 64 boxes,
// 128-byte swizzled as the TMA store reads them (16-byte chunk c of row r at
// chunk c ^ (r % 8)). The word (two bf16) at row r, columns 8 i + 2 q, + 1
// (i < 16, q < 4); a warp's 32 words (8 rows, 4 q) fall in 32 distinct banks.
__device__ __forceinline__ void stage_word(unsigned char* plane, int r, int i, int q,
                                           unsigned v) {
  *reinterpret_cast<unsigned*>(plane + (i >> 3) * WG_OUT_BOX + r * 128 +
                               (((i & 7) ^ (r & 7)) << 4) + 4 * q) = v;
}

// A warpgroup's staged 64 x 128 float plane: four 64 x 32 boxes, swizzled
// alike; the two floats at row r, columns 8 i + 2 q, + 1 (bytes 32 (i % 4) +
// 8 q of the row of box i / 4).
__device__ __forceinline__ void stage_float2(unsigned char* plane, int r, int i, int q, float v0,
                                             float v1) {
  float2 v;
  v.x = v0;
  v.y = v1;
  *reinterpret_cast<float2*>(plane + (i >> 2) * WG_OUT_BOX + r * 128 +
                             (((2 * (i & 3) + (q >> 1)) ^ (r & 7)) << 4) + 8 * (q & 1)) = v;
}

// The unit's epilogue on warpgroup g's accumulators: acc[4 i + 2 h + e] is
// row m0 + 64 g + 16 w + l / 4 + 8 h, column n0 + 8 i + 2 (l % 4) + e (warp w
// of the warpgroup, lane l). m_f: F's map (FWD) or dx's (DX).
template <int MODE, int STASH>
__device__ __forceinline__ void epilogue(const WgPass& a, const Unit& t, int g, float (&acc)[64],
                                         float* colsum, unsigned char* stage,
                                         const CUtensorMap* m_hi, const CUtensorMap* m_lo,
                                         const CUtensorMap* m_f) {
  const int tid = threadIdx.x;
  const int w = (tid >> 5) & 3, l = tid & 31, q = l & 3;
  const long long slot = t.slot;
  const int row0 = t.m0 + 64 * g + 16 * w + (l >> 2);
  const int col0 = t.n0 + 2 * q;
  if (MODE == WG_DW) {
    float* part = a.part + slot * a.part_slot + (long long)t.split * a.M * a.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)(row0 + 8 * h) * a.N;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float2 v;
        v.x = acc[4 * i + 2 * h];
        v.y = acc[4 * i + 2 * h + 1];
        *reinterpret_cast<float2*>(part + row + col0 + 8 * i) = v;
      }
    }
    return;
  }
  // the warpgroup's outputs go out through its staging: one thread waits
  // until the last unit's stores have read it, the warpgroup fills it, and
  // that thread stores it with TMA (rows past M dropped) while the
  // warpgroup goes on
  const bool elected = (tid & 127) == 0;
  unsigned char* plane_hi = stage + g * wg_staging(MODE, STASH);
  unsigned char* plane_lo = plane_hi + WG_OUT_PLANE;
  unsigned char* plane_f = MODE == WG_DX ? plane_hi : plane_lo + WG_OUT_PLANE;
  const bool store_hi = MODE == WG_CHAIN || ((MODE == WG_FWD || MODE == WG_FWD_LAST) && a.store_hi);
  const bool store_lo = MODE == WG_CHAIN || ((MODE == WG_FWD || MODE == WG_FWD_LAST) && a.store_lo);
  const bool store_f =
      MODE == WG_DX || (STASH != STASH_NONE && (MODE == WG_FWD || MODE == WG_FWD_LAST) && a.store_f);
  if (elected) bulk_wait_read<0>();
  named_barrier_sync(3 + g, 128);
  const int rl0 = 16 * w + (l >> 2);  // the row within the warpgroup's 64
  if (MODE == WG_FWD || MODE == WG_FWD_LAST) {
    const float* bias = a.bias + slot * a.bias_slot;
    const float* wl = MODE == WG_FWD_LAST ? a.w_last + slot * a.wl_slot : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = col0 + 8 * i;
        float s0, c0, s1, c1;  // (a slot's bias may lie at an odd float: no float2)
        sincosf(a.omega * (acc[4 * i + 2 * h] + bias[c]), &s0, &c0);
        sincosf(a.omega * (acc[4 * i + 2 * h + 1] + bias[c + 1]), &s1, &c1);
        if (store_hi) {
          unsigned hi, lo;
          split_pair(s0, s1, hi, lo);
          stage_word(plane_hi, rl0 + 8 * h, i, q, hi);
          if (store_lo) stage_word(plane_lo, rl0 + 8 * h, i, q, lo);
        }
        if (store_f) {
          if (STASH == STASH_F32)
            stage_float2(plane_f, rl0 + 8 * h, i, q, c0, c1);
          else
            stage_word(plane_f, rl0 + 8 * h, i, q, bf16x2_rn(c0, c1));
        }
        if (MODE == WG_FWD_LAST) dot = fmaf(s1, wl[c + 1], fmaf(s0, wl[c], dot));
      }
      if (MODE == WG_FWD_LAST) {
        // the row's dot over this tile's 128 columns: the four lanes of the row
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int p = row0 + 8 * h;
        if (p < a.M && q == 0) a.part[slot * a.part_slot + (long long)t.tile_col * a.M + p] = dot;
      }
    }
  } else if (MODE == WG_CHAIN) {
    // delta = acc * omega F, its planes, and the tile's column sums (stored
    // with db)
    float* mine = colsum + (tid >> 5) * WG_BN;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = col0 + 8 * i;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row0 + 8 * h;
        float v0 = 0.f, v1 = 0.f;
        if (p < a.M) {
          const long long off = slot * a.f_slot + (long long)p * a.N + c;
          float f0, f1;
          if (STASH == STASH_F32) {
            const float2 f = *reinterpret_cast<const float2*>(static_cast<const float*>(a.F) + off);
            f0 = f.x;
            f1 = f.y;
          } else {
            const unsigned f = *reinterpret_cast<const unsigned*>(
                static_cast<const uint16_t*>(a.F) + off);
            f0 = bf16_to_f32(f & 0xffffu);
            f1 = bf16_to_f32(f >> 16);
          }
          v0 = acc[4 * i + 2 * h] * (a.omega * f0);
          v1 = acc[4 * i + 2 * h + 1] * (a.omega * f1);
        }
        unsigned hi, lo;
        split_pair(v0, v1, hi, lo);
        stage_word(plane_hi, rl0 + 8 * h, i, q, hi);
        stage_word(plane_lo, rl0 + 8 * h, i, q, lo);
        s0 += v0;
        s1 += v1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (l < 4) {
        mine[8 * i + 2 * l] = s0;
        mine[8 * i + 2 * l + 1] = s1;
      }
    }
  } else {  // DX: the float32 product
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        stage_float2(plane_f, rl0 + 8 * h, i, q, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  fence_proxy_async();  // the staging's writes, visible to the TMA store
  named_barrier_sync(3 + g, 128);
  if (elected) {
    const int r0 = t.m0 + 64 * g;
    for (int b = 0; b < 2; ++b) {
      if (store_hi) tma_store_3d(m_hi, t.n0 + 64 * b, r0, t.slot, plane_hi + b * WG_OUT_BOX);
      if (store_lo) tma_store_3d(m_lo, t.n0 + 64 * b, r0, t.slot, plane_lo + b * WG_OUT_BOX);
    }
    if (store_f) {
      if (STASH == STASH_F32 || MODE == WG_DX) {
        for (int b = 0; b < 4; ++b)
          tma_store_3d(m_f, t.n0 + 32 * b, r0, t.slot, plane_f + b * WG_OUT_BOX);
      } else {
        for (int b = 0; b < 2; ++b)
          tma_store_3d(m_f, t.n0 + 64 * b, r0, t.slot, plane_f + b * WG_OUT_BOX);
      }
    }
    bulk_commit();
  }
  if (MODE == WG_CHAIN && a.part != nullptr) {
    named_barrier_sync(1, WG_CONSUMERS);  // every warp's column sums are in
    if (tid < WG_BN) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += colsum[k * WG_BN + tid];
      a.part[slot * a.part_slot + (long long)t.tile_row * a.N + t.n0 + tid] = s;
    }
    named_barrier_sync(2, WG_CONSUMERS);  // and read: the buffer is free again
  }
}

// One pass (see WgPass and the modes above): a persistent block of one
// producer warp (warp 8) and two consumer warpgroups walks the units
// blockIdx.x, blockIdx.x + gridDim.x, ...
template <int MODE, int STASH>
__global__ void __launch_bounds__(WG_THREADS, wg_blocks_per_sm(MODE))
    wg_kernel(const __grid_constant__ CUtensorMap mA_hi, const __grid_constant__ CUtensorMap mA_lo,
              const __grid_constant__ CUtensorMap mB_hi, const __grid_constant__ CUtensorMap mB_lo,
              const __grid_constant__ CUtensorMap mO_hi, const __grid_constant__ CUtensorMap mO_lo,
              const __grid_constant__ CUtensorMap mO_f, const WgPass a) {
#ifdef __CUDACC__
  extern __shared__ __align__(1024) unsigned char smem_raw[];
#else
  alignas(1024) __shared__ unsigned char smem_raw[WG_SMEM_MOST];
  emu_poison_shared(smem_raw, sizeof smem_raw);
#endif
  unsigned char* smem = smem_raw + ((1024 - (shared_addr(smem_raw) & 1023)) & 1023);
  constexpr int S = wg_stages(MODE, STASH);
  unsigned char* staging = smem + S * WG_STAGE_BYTES;  // none in DW
  float* colsum = reinterpret_cast<float*>(staging + 2 * wg_staging(MODE, STASH));  // CHAIN's
  uint64_t* full =
      reinterpret_cast<uint64_t*>(colsum + (MODE == WG_CHAIN ? WG_COLSUM_FLOATS : 0));
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {  // the producer warp: lane 0 issues every load
    if (tid != WG_CONSUMERS) return;
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit t = unit_of(a, MODE, u);
      const int a_slot = a.a_shared ? 0 : t.slot, b_slot = a.b_shared ? 0 : t.slot;
      for (int k0 = t.kb; k0 < t.ke; k0 += WG_BK) {
        mbar_wait(&empty[stage], phase ^ 1u);  // the consumers are done with it
        load_stage<MODE, STASH>(smem + stage * WG_STAGE_BYTES, &mA_hi, &mA_lo, &mB_hi, &mB_lo, t,
                                a_slot, b_slot, k0, &full[stage]);
        if (++stage == S) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  const int g = tid >> 7;  // consumer warpgroup
  const int lane = tid & 31;
  int stage = 0;
  unsigned phase = 0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit t = unit_of(a, MODE, u);
    int prev = -1;
    for (int k0 = t.kb; k0 < t.ke; k0 += WG_BK) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      stage_products<MODE, STASH>(smem + stage * WG_STAGE_BYTES, g, k0 == t.kb, acc);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is read: release it
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
    wgmma_fence_operands(acc);
    epilogue<MODE, STASH>(a, t, g, acc, colsum, staging, &mO_hi, &mO_lo, &mO_f);
    wgmma_fence_operands(acc);
  }
  if (MODE != WG_DW && (tid & 127) == 0) bulk_wait<0>();  // the last stores are done
}

// The last layer over every slot's rows (grid (last_blocks(D), D)). Its delta
// is K1's, from the last hidden layer's row dots: out = sum of the tiles'
// dots + b, the residual r = out - target on rows below n_rows (0 beyond),
// delta_last = two_inv_n r, with the loss's sum of r^2; or K2's, delta_last
// = g. Then, with dW (dw_part set), dW_last = sum_p delta_last a (the float32
// stash a's hi + lo, the bf16 stash bf16(a)) and db_last = sum_p delta_last;
// and the chain's first delta, delta[p, c] = (delta_last[p] w[c]) * omega
// F[p, c], as planes, with (dW) its column sums. Each block writes its
// partials: dW_last and the column sums (width W each), and the loss and
// db_last.
struct LastArgs {
  int P, n_rows, W, nct;
  float omega, two_inv_n;
  const float* rowdot;  // K1: (nct, P) a slot
  long long rowdot_slot;
  const float* g;  // K2: (P) (one slot); null: K1
  const float* w_last;
  long long wl_slot;
  const float* b_last;
  long long bl_slot;
  const float* target;   // K1: (D, P)
  const uint16_t* a_hi;  // the last hidden activation's planes (P, W) a slot (with dW)
  const uint16_t* a_lo;  // (the float32 stash)
  const void* F;         // its factor, bf16 or float (P, W) a slot
  long long a_slot;
  uint16_t* d_hi;  // the chain's first delta (P, W) a slot
  uint16_t* d_lo;
  float* dw_part;  // (blocks, W) a slot, or null (no dW)
  float* db_part;
  float* scalars;  // (blocks, 2) a slot: the loss's sum, db_last's
};

template <int STASH>
__global__ void __launch_bounds__(LAST_THREADS) last_layer_kernel(const LastArgs a) {
  __shared__ float wl[LAST_MAX_W];
  __shared__ float dl[LAST_ROWS];
  const int tid = threadIdx.x;
  const long long slot = blockIdx.y;
  const bool grads = a.dw_part != nullptr;
  const float* w_last = a.w_last + slot * a.wl_slot;
  for (int c = tid; c < a.W; c += LAST_THREADS) wl[c] = w_last[c];
  float dw[LAST_COLS][2], db[LAST_COLS][2];
#pragma unroll
  for (int j = 0; j < LAST_COLS; ++j) dw[j][0] = dw[j][1] = db[j][0] = db[j][1] = 0.f;
  float sq = 0.f, dsum = 0.f;
  const float b = a.g == nullptr ? a.b_last[slot * a.bl_slot] : 0.f;
  const long long plane = slot * a.a_slot;
  __syncthreads();
  for (int r0 = blockIdx.x * LAST_ROWS; r0 < a.P; r0 += gridDim.x * LAST_ROWS) {
    if (tid < LAST_ROWS) {
      const int p = r0 + tid;
      float d = 0.f;
      if (p < a.P && a.g != nullptr) {
        d = a.g[p];
        dsum += d;
      } else if (p < a.P) {
        float s = 0.f;
        const float* dots = a.rowdot + slot * a.rowdot_slot + p;
        for (int ct = 0; ct < a.nct; ++ct) s += dots[(long long)ct * a.P];
        const float r = p < a.n_rows ? (s + b) - a.target[slot * a.P + p] : 0.f;
        d = a.two_inv_n * r;
        sq = fmaf(r, r, sq);
        dsum += d;
      }
      dl[tid] = d;
    }
    __syncthreads();
    const int rows = min(LAST_ROWS, a.P - r0);
#pragma unroll
    for (int j = 0; j < LAST_COLS; ++j) {
      const int c = 2 * tid + 2 * LAST_THREADS * j;
      if (c >= a.W) continue;
#pragma unroll 8
      for (int rr = 0; rr < rows; ++rr) {
        const float d = dl[rr];
        const long long off = plane + (long long)(r0 + rr) * a.W + c;
        float f0, f1;
        if (STASH == STASH_F32) {
          const float2 f = *reinterpret_cast<const float2*>(static_cast<const float*>(a.F) + off);
          f0 = f.x;
          f1 = f.y;
        } else {
          const unsigned f =
              *reinterpret_cast<const unsigned*>(static_cast<const uint16_t*>(a.F) + off);
          f0 = bf16_to_f32(f & 0xffffu);
          f1 = bf16_to_f32(f >> 16);
        }
        const float v0 = (d * wl[c]) * (a.omega * f0);
        const float v1 = (d * wl[c + 1]) * (a.omega * f1);
        store_planes(a.d_hi, a.d_lo, off, v0, v1);
        if (grads) {
          const unsigned h = *reinterpret_cast<const unsigned*>(a.a_hi + off);
          dw[j][0] = fmaf(d, bf16_to_f32(h & 0xffffu), dw[j][0]);
          dw[j][1] = fmaf(d, bf16_to_f32(h >> 16), dw[j][1]);
          if (STASH == STASH_F32) {
            const unsigned lo = *reinterpret_cast<const unsigned*>(a.a_lo + off);
            dw[j][0] = fmaf(d, bf16_to_f32(lo & 0xffffu), dw[j][0]);
            dw[j][1] = fmaf(d, bf16_to_f32(lo >> 16), dw[j][1]);
          }
          db[j][0] += v0;
          db[j][1] += v1;
        }
      }
    }
    __syncthreads();  // dl is read
  }
  if (!grads) return;
  const long long part = (slot * gridDim.x + blockIdx.x) * a.W;
#pragma unroll
  for (int j = 0; j < LAST_COLS; ++j) {
    const int c = 2 * tid + 2 * LAST_THREADS * j;
    if (c >= a.W) continue;
    a.dw_part[part + c] = dw[j][0];
    a.dw_part[part + c + 1] = dw[j][1];
    a.db_part[part + c] = db[j][0];
    a.db_part[part + c + 1] = db[j][1];
  }
  if (tid < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    }
    if (tid == 0) {
      a.scalars[2 * (slot * gridDim.x + blockIdx.x)] = sq;
      a.scalars[2 * (slot * gridDim.x + blockIdx.x) + 1] = dsum;
    }
  }
}

// out[s out_slot + i] = scale * sum over z < parts of part[s part_slot + z
// stride + i] (+ add[0] when add is set), i < count, for every slot s (grid
// (count blocks, jobs, D))
struct ReduceJob {
  const float* part;
  long long part_slot, stride, count, out_slot;
  int parts;
  float scale;
  float* out;
  const float* add;
};
struct ReduceJobs {
  ReduceJob job[MAX_JOBS];
};

__global__ void reduce_jobs_kernel(const ReduceJobs jobs) {
  const ReduceJob& j = jobs.job[blockIdx.y];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= j.count) return;
  const float* p = j.part + (long long)blockIdx.z * j.part_slot + i;
  float s = 0.f;
  for (int z = 0; z < j.parts; ++z) s += p[z * j.stride];
  s *= j.scale;
  if (j.add != nullptr) s += j.add[0];
  j.out[(long long)blockIdx.z * j.out_slot + i] = s;
}

// hi/lo planes of `slots` copies of n floats (grid (blocks, jobs))
struct SplitJob {
  const float* src;
  long long src_slot, n, dst_slot;
  int slots;
  uint16_t* hi;
  uint16_t* lo;
};
struct SplitJobs {
  SplitJob job[MAX_LAYERS];
};

__global__ void split_jobs_kernel(const SplitJobs jobs) {
  const SplitJob& j = jobs.job[blockIdx.y];
  for (int s = 0; s < j.slots; ++s) {
    const float* src = j.src + s * j.src_slot;
    uint16_t* hi = j.hi + s * j.dst_slot;
    uint16_t* lo = j.lo + s * j.dst_slot;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < j.n;
         i += (long long)gridDim.x * blockDim.x) {
      unsigned h, l;
      split_bf16(src[i], h, l);
      hi[i] = (uint16_t)h;
      lo[i] = (uint16_t)l;
    }
  }
}

bool wg_supported(const int* dims, int L, int D) {
  if (L < 2 || L > MAX_LAYERS || dims[L] != 1 || D < 1 || D > 65535) return false;
  for (int l = 0; l < L; ++l)
    if (dims[l] < WG_BN || dims[l] % WG_BN) return false;
  return dims[L - 1] <= LAST_MAX_W;
}

// dW's split of the P rows: about two waves' units of 128 x 128 tiles over
// the planned SMs, each split a whole number of stages
SplitPlan wg_dw_plan(int D, int d_out, int d_in, int P) {
  const int tiles = D * (d_out / WG_BN) * (d_in / WG_BN);
  int splits = wg_blocks_per_sm(WG_DW) * WG_PLAN_SMS / tiles;
  const int stages = cdiv(P, WG_BK);
  splits = splits < 1 ? 1 : (splits > stages ? stages : splits);
  const int k_split = cdiv(stages, splits) * WG_BK;
  return {cdiv(P, k_split), k_split};
}

// What a call keeps in its workspace.
enum WgPlan {
  PLAN_LOSS_GRADS,  // K1 and K2 with dW: every activation, F, both deltas, the row dots, partials
  PLAN_FORWARD,     // K3: two activation slots, the row dots
  PLAN_BWD_DX,      // K2, dx only: F and both deltas; the activations ping-pong in the deltas
};

// The workspace of a call: pieces of D slots each, 1024-byte aligned.
struct WgWork {
  uint16_t *x_hi = nullptr, *x_lo = nullptr;  // (P, d_0), shared
  std::vector<uint16_t*> w_hi, w_lo;          // W_l (D, d_{l+1}, d_l), l < L - 1
  std::vector<uint16_t*> a_hi, a_lo;          // a_{l+1} (D, P, d_{l+1}), or null (not kept)
  std::vector<void*> F;                       // cos(omega z_l) (D, P, d_{l+1}), bf16 or float
  uint16_t *d_hi[2] = {}, *d_lo[2] = {};      // deltas (D, P, d) of a layer's width d
  float* rowdot = nullptr;                    // (D, d_{L-1} / 128, P)
  std::vector<float*> dw_part;                // (D, splits_l, d_{l+1}, d_l)
  std::vector<float*> db_part;                // (D, row tiles, d_{l+1}); l = L - 2: (D, blocks, .)
  float* last_dw = nullptr;                   // (D, last_blocks(D), d_{L-1})
  float* scalars = nullptr;                   // (D, last_blocks(D), 2)
  long long bytes = 0;
};

WgWork wg_carve(char* base, int P, const int* dims, int L, int D, int stash, int plan) {
  WgWork w;
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 1023) / 1024 * 1024;
    return p;
  };
  auto half = [&](long long n) { return reinterpret_cast<uint16_t*>(take(2 * n)); };
  auto flt = [&](long long n) { return reinterpret_cast<float*>(take(4 * n)); };
  const bool keep = plan == PLAN_LOSS_GRADS;  // every activation, for dW
  int width = 0;
  for (int l = 1; l < L; ++l) width = dims[l] > width ? dims[l] : width;
  const int nrt = cdiv(P, WG_BM);
  w.x_hi = half((long long)P * dims[0]);
  w.x_lo = half((long long)P * dims[0]);
  for (int l = 0; l + 1 < L; ++l) {
    const long long wn = (long long)D * dims[l + 1] * dims[l];
    const long long an = (long long)D * P * dims[l + 1];
    w.w_hi.push_back(half(wn));
    w.w_lo.push_back(half(wn));
    w.a_hi.push_back(keep ? half(an) : nullptr);
    w.a_lo.push_back(keep && (stash == STASH_F32 || l + 2 < L) ? half(an) : nullptr);
    if (plan != PLAN_FORWARD) w.F.push_back(take((stash == STASH_F32 ? 4 : 2) * an));
    if (keep) {
      const SplitPlan sp = wg_dw_plan(D, dims[l + 1], dims[l], P);
      w.dw_part.push_back(flt((long long)D * sp.splits * dims[l + 1] * dims[l]));
      w.db_part.push_back(flt((long long)D * (l + 2 < L ? nrt : last_blocks(D)) * dims[l + 1]));
    }
  }
  if (plan == PLAN_FORWARD) {
    // hidden layer l < L - 2 writes slot l % 2; the last one its row dots alone
    uint16_t *slot_hi[2] = {}, *slot_lo[2] = {};
    for (int s = 0; s < 2 && s + 2 < L; ++s) {
      slot_hi[s] = half((long long)D * P * width);
      slot_lo[s] = half((long long)D * P * width);
    }
    for (int l = 0; l + 2 < L; ++l) {
      w.a_hi[l] = slot_hi[l % 2];
      w.a_lo[l] = slot_lo[l % 2];
    }
  } else {
    for (int i = 0; i < 2; ++i) {
      w.d_hi[i] = half((long long)D * P * width);
      w.d_lo[i] = half((long long)D * P * width);
    }
    // dx only: the forward's activations are read by the next layer alone,
    // and the deltas are not written before the forward ends
    if (plan == PLAN_BWD_DX)
      for (int l = 0; l + 2 < L; ++l) {
        w.a_hi[l] = w.d_hi[l % 2];
        w.a_lo[l] = w.d_lo[l % 2];
      }
  }
  if (plan != PLAN_BWD_DX) w.rowdot = flt((long long)D * (dims[L - 1] / WG_BN) * P);
  if (keep) {
    w.last_dw = flt((long long)D * last_blocks(D) * dims[L - 1]);
    w.scalars = flt((long long)D * last_blocks(D) * 2);
  }
  w.bytes = at;
  return w;
}

// a (D, rows, cols) bf16 array's tensor map with boxes of box_cols x box_rows:
// 64-byte swizzled for the operands' loads, 128-byte for the outputs' stores
int wg_map(CUtensorMap* m, const uint16_t* base, int cols, long long rows, int D,
           unsigned box_cols, unsigned box_rows, int swizzle = 64) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)D};
  const uint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const unsigned box[2] = {box_cols, box_rows};
  return encode_tensor_map_3d(m, base, dims, strides, box, swizzle);
}

int wg_out_map(CUtensorMap* m, const uint16_t* base, int cols, long long rows, int D) {
  return wg_map(m, base, cols, rows, D, 64, 64, 128);
}

// a (D, rows, cols) float array's map for the stores of staged float planes:
// boxes of 32 x 64, 128-byte swizzled
int wg_out_map_f32(CUtensorMap* m, const float* base, int cols, long long rows, int D) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)D};
  const uint64_t strides[2] = {4ull * cols, 4ull * cols * rows};
  const unsigned box[2] = {32, 64};
  return encode_tensor_map_3d(m, base, dims, strides, box, 128, 4);
}

int wg_grid(int units, int per_sm) {
  int dev = 0, sms = WG_PLAN_SMS;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = WG_PLAN_SMS;
  const int most = per_sm * sms;
  return units < most ? units : most;
}

// m: the operands' maps (A hi, A lo, B hi, B lo), then the outputs' (hi,
// lo, F or dx; those a pass does not store are left zero)
template <int MODE, int STASH>
int wg_launch(const CUtensorMap (&m)[7], const WgPass& a, cudaStream_t stream) {
  constexpr int smem = wg_smem(MODE, STASH);
#ifdef __CUDACC__
  const cudaError_t e = cudaFuncSetAttribute(wg_kernel<MODE, STASH>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
#endif
  const auto kernel = wg_kernel<MODE, STASH>;
  LAUNCH_SMEM(kernel, wg_grid(a.units, wg_blocks_per_sm(MODE)), WG_THREADS, smem, stream)(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], a);
  CHECK_LAUNCH();
  return 0;
}

template <int MODE>
int wg_launch(int stash, const CUtensorMap (&m)[7], const WgPass& a, cudaStream_t stream) {
  if constexpr (MODE == WG_FWD || MODE == WG_FWD_LAST)
    if (stash == STASH_NONE) return wg_launch<MODE, STASH_NONE>(m, a, stream);
  return stash == STASH_F32 ? wg_launch<MODE, STASH_F32>(m, a, stream)
                            : wg_launch<MODE, STASH_BF16>(m, a, stream);
}

// What a call reads and writes. K1: target, loss, dW/db; K2: g, dx (or
// null), dW/db (or null); K3: out. w_slot and b_slot null: one slot.
struct WgCall {
  const float* x;
  int P, n_rows, L, D;
  const int* dims;
  const float* const* W;
  const float* const* b;
  const long long* w_slot;
  const long long* b_slot;
  const float* omegas;
  const float* target;
  float inv_n;
  const float* g;
  float* const* dW;
  float* const* db;
  long long g_slot;
  float* loss;
  float* dx;
  float* out;
  int stash, plan;
  long long wslot(int l) const { return w_slot ? w_slot[l] : 0; }
  long long bslot(int l) const { return b_slot ? b_slot[l] : 0; }
};

// The FWD passes: layer l reads x or a_l's planes and writes a_{l+1}'s
// planes and F_l as the plan keeps them; the last hidden layer of K1 and K3
// also its row dots.
int wg_forward(const WgCall& c, const WgWork& w, cudaStream_t stream) {
  const int* dims = c.dims;
  const int P = c.P, D = c.D, L = c.L;
  for (int l = 0; l + 1 < L; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    const bool dots = l + 2 == L && w.rowdot != nullptr && c.g == nullptr;
    CUtensorMap m[7] = {};
    const uint16_t* in_hi = l == 0 ? w.x_hi : w.a_hi[l - 1];
    const uint16_t* in_lo = l == 0 ? w.x_lo : w.a_lo[l - 1];
    const int in_slots = l == 0 ? 1 : D;
    int rc = wg_map(&m[0], in_hi, din, P, in_slots, WG_BK, WG_BM);
    if (!rc) rc = wg_map(&m[1], in_lo, din, P, in_slots, WG_BK, WG_BM);
    if (!rc) rc = wg_map(&m[2], w.w_hi[l], din, dout, D, WG_BK, WG_BN);
    if (!rc) rc = wg_map(&m[3], w.w_lo[l], din, dout, D, WG_BK, WG_BN);
    if (!rc && w.a_hi[l]) rc = wg_out_map(&m[4], w.a_hi[l], dout, P, D);
    if (!rc && w.a_lo[l]) rc = wg_out_map(&m[5], w.a_lo[l], dout, P, D);
    if (!rc && !w.F.empty())
      rc = c.stash == STASH_F32
               ? wg_out_map_f32(&m[6], static_cast<const float*>(w.F[l]), dout, P, D)
               : wg_out_map(&m[6], static_cast<const uint16_t*>(w.F[l]), dout, P, D);
    if (rc) return rc;
    WgPass a{};
    a.M = P;
    a.N = dout;
    a.K = din;
    a.units = D * cdiv(P, WG_BM) * (dout / WG_BN);
    a.a_shared = l == 0;
    a.omega = c.omegas[l];
    a.bias = c.b[l];
    a.bias_slot = c.bslot(l);
    a.store_hi = w.a_hi[l] != nullptr;
    a.store_lo = w.a_lo[l] != nullptr;
    a.store_f = !w.F.empty();
    if (dots) {
      a.w_last = c.W[L - 1];
      a.wl_slot = c.wslot(L - 1);
      a.part = w.rowdot;
      a.part_slot = (long long)(dout / WG_BN) * P;
      rc = wg_launch<WG_FWD_LAST>(c.stash, m, a, stream);
    } else {
      rc = wg_launch<WG_FWD>(c.stash, m, a, stream);
    }
    if (rc) return rc;
  }
  return 0;
}

// K1's and K2's last layer (see last_layer_kernel)
int wg_last_layer(const WgCall& c, const WgWork& w, cudaStream_t stream) {
  const int L = c.L, W = c.dims[L - 1];
  const bool grads = c.dW != nullptr;
  LastArgs a{};
  a.P = c.P;
  a.n_rows = c.n_rows;
  a.W = W;
  a.nct = W / WG_BN;
  a.omega = c.omegas[L - 2];
  a.two_inv_n = 2.f * c.inv_n;
  a.rowdot = w.rowdot;
  a.rowdot_slot = (long long)a.nct * c.P;
  a.g = c.g;
  a.w_last = c.W[L - 1];
  a.wl_slot = c.wslot(L - 1);
  a.b_last = c.b[L - 1];
  a.bl_slot = c.bslot(L - 1);
  a.target = c.target;
  a.F = w.F[L - 2];
  a.a_slot = (long long)c.P * W;
  a.d_hi = w.d_hi[0];
  a.d_lo = w.d_lo[0];
  if (grads) {
    a.a_hi = w.a_hi[L - 2];
    a.a_lo = w.a_lo[L - 2];
    a.dw_part = w.last_dw;
    a.db_part = w.db_part[L - 2];
    a.scalars = w.scalars;
  }
  const dim3 grid(last_blocks(c.D), c.D, 1);
  if (c.stash == STASH_F32)
    LAUNCH(last_layer_kernel<STASH_F32>, grid, LAST_THREADS, stream)(a);
  else
    LAUNCH(last_layer_kernel<STASH_BF16>, grid, LAST_THREADS, stream)(a);
  CHECK_LAUNCH();
  return 0;
}

// From delta_{L-2} in delta buffer 0: for each hidden layer l from L - 2
// down, with dW its DW pass (the split partials); then (l > 0) the chain to
// delta_{l-1} with, with dW, db_{l-1}'s column sums, or (l = 0, K2 with dx)
// the DX pass.
int wg_backward(const WgCall& c, const WgWork& w, cudaStream_t stream) {
  const int* dims = c.dims;
  const int P = c.P, D = c.D;
  const bool grads = c.dW != nullptr;
  int cur = 0;
  for (int l = c.L - 2; l >= 0; --l) {
    const int din = dims[l], dout = dims[l + 1];
    int rc = 0;
    if (grads) {
      const SplitPlan sp = wg_dw_plan(D, dout, din, P);
      CUtensorMap m[7] = {};
      const int in_slots = l == 0 ? 1 : D;
      rc = wg_map(&m[0], w.d_hi[cur], dout, P, D, WG_BK, WG_BK);
      if (!rc) rc = wg_map(&m[1], w.d_lo[cur], dout, P, D, WG_BK, WG_BK);
      if (!rc) rc = wg_map(&m[2], l == 0 ? w.x_hi : w.a_hi[l - 1], din, P, in_slots, WG_BK, WG_BK);
      if (!rc && c.stash == STASH_F32)  // DW reads a's lo plane too
        rc = wg_map(&m[3], l == 0 ? w.x_lo : w.a_lo[l - 1], din, P, in_slots, WG_BK, WG_BK);
      if (rc) return rc;
      WgPass a{};
      a.M = dout;
      a.N = din;
      a.K = P;
      a.splits = sp.splits;
      a.k_split = sp.k_split;
      a.units = D * sp.splits * (dout / WG_BM) * (din / WG_BN);
      a.b_shared = l == 0;
      a.part = w.dw_part[l];
      a.part_slot = (long long)sp.splits * dout * din;
      rc = wg_launch<WG_DW>(c.stash, m, a, stream);
      if (rc) return rc;
    }
    if (l == 0 && c.dx == nullptr) break;
    CUtensorMap m[7] = {};
    rc = wg_map(&m[0], w.d_hi[cur], dout, P, D, WG_BK, WG_BM);
    if (!rc) rc = wg_map(&m[1], w.d_lo[cur], dout, P, D, WG_BK, WG_BM);
    if (!rc) rc = wg_map(&m[2], w.w_hi[l], din, dout, D, WG_BK, WG_BK);
    if (!rc) rc = wg_map(&m[3], w.w_lo[l], din, dout, D, WG_BK, WG_BK);
    if (rc) return rc;
    WgPass ch{};
    ch.M = P;
    ch.N = din;
    ch.K = dout;
    ch.units = D * cdiv(P, WG_BM) * (din / WG_BN);
    if (l == 0) {  // dx = delta_0 W_0 (K2: one slot, the float32 stash)
      rc = wg_out_map_f32(&m[6], c.dx, din, P, 1);
      if (!rc) rc = wg_launch<WG_DX, STASH_F32>(m, ch, stream);
      return rc;
    }
    rc = wg_out_map(&m[4], w.d_hi[1 - cur], din, P, D);
    if (!rc) rc = wg_out_map(&m[5], w.d_lo[1 - cur], din, P, D);
    if (rc) return rc;
    ch.omega = c.omegas[l - 1];
    ch.F = w.F[l - 1];
    ch.f_slot = (long long)P * din;
    if (grads) {
      ch.part = w.db_part[l - 1];
      ch.part_slot = (long long)cdiv(P, WG_BM) * din;
    }
    rc = wg_launch<WG_CHAIN>(c.stash, m, ch, stream);
    if (rc) return rc;
    cur = 1 - cur;
  }
  return 0;
}

// x's and every slot's W's planes, one launch
int wg_split(const WgCall& c, const WgWork& w, cudaStream_t stream) {
  SplitJobs jobs{};
  int n = 0;
  jobs.job[n++] = {c.x, 0, (long long)c.P * c.dims[0], 0, 1, w.x_hi, w.x_lo};
  long long most = jobs.job[0].n;
  for (int l = 0; l + 1 < c.L; ++l) {
    const long long e = (long long)c.dims[l + 1] * c.dims[l];
    jobs.job[n++] = {c.W[l], c.wslot(l), e, e, c.D, w.w_hi[l], w.w_lo[l]};
    most = e > most ? e : most;
  }
  LAUNCH(split_jobs_kernel, dim3(ew_blocks(most), n, 1), EW_THREADS, stream)(jobs);
  CHECK_LAUNCH();
  return 0;
}

// every partial summed into the outputs, one launch: K1 and K2 with dW the
// dW splits, db's row tiles, the last layer's partials (and K1's loss); K3
// the row dots plus b into the output
int wg_reduce(const WgCall& c, const WgWork& w, cudaStream_t stream) {
  const int* dims = c.dims;
  const int P = c.P, L = c.L, W = dims[L - 1], lb = last_blocks(c.D);
  ReduceJobs jobs{};
  int n = 0;
  long long most = 1;
  auto add = [&](const float* part, long long part_slot, long long stride, int parts,
                 long long count, float scale, float* out, long long out_slot,
                 const float* plus = nullptr) {
    jobs.job[n++] = {part, part_slot, stride, count, out_slot, parts, scale, out, plus};
    most = count > most ? count : most;
  };
  if (c.out != nullptr) {
    add(w.rowdot, (long long)(W / WG_BN) * P, P, W / WG_BN, P, 1.f, c.out, P, c.b[L - 1]);
  } else {
    for (int l = 0; l + 1 < L; ++l) {
      const long long e = (long long)dims[l + 1] * dims[l];
      const SplitPlan sp = wg_dw_plan(c.D, dims[l + 1], dims[l], P);
      add(w.dw_part[l], sp.splits * e, e, sp.splits, e, 1.f, c.dW[l], c.g_slot);
      const int parts = l + 2 < L ? cdiv(P, WG_BM) : lb;
      add(w.db_part[l], (long long)parts * dims[l + 1], dims[l + 1], parts, dims[l + 1], 1.f,
          c.db[l], c.g_slot);
    }
    add(w.last_dw, (long long)lb * W, W, lb, W, 1.f, c.dW[L - 1], c.g_slot);
    add(w.scalars + 1, 2 * lb, 2, lb, 1, 1.f, c.db[L - 1], c.g_slot);
    if (c.loss != nullptr) add(w.scalars, 2 * lb, 2, lb, 1, c.inv_n, c.loss, 1);
  }
  LAUNCH(reduce_jobs_kernel, dim3(cdiv(most, 256), n, c.D), 256, stream)(jobs);
  CHECK_LAUNCH();
  return 0;
}

long long wg_bytes(int P, const int* dims, int L, int D, int stash, int plan) {
  if (!wg_supported(dims, L, D) || P < 1) return -1;
  return wg_carve(nullptr, P, dims, L, D, stash, plan).bytes;
}

// A call: the splits, the forward, (K1, K2) the last layer and the
// backward, the reduction.
int wg_run(const WgCall& c, void* work, cudaStream_t stream) {
  if (!wg_supported(c.dims, c.L, c.D) || c.P < 1) return -1;
  const WgWork w = wg_carve(static_cast<char*>(work), c.P, c.dims, c.L, c.D, c.stash, c.plan);
  int rc = wg_split(c, w, stream);
  if (!rc) rc = wg_forward(c, w, stream);
  if (c.plan != PLAN_FORWARD) {
    if (!rc) rc = wg_last_layer(c, w, stream);
    if (!rc) rc = wg_backward(c, w, stream);
  }
  if (!rc && c.plan != PLAN_BWD_DX) rc = wg_reduce(c, w, stream);
  return rc;
}

}  // namespace

extern "C" {

// Bytes of workspace siren_loss_grads_wg needs for D slots, or -1 when it
// does not take these shapes (the input and every hidden width a multiple
// of 128, the last hidden one at most 2,048, one output, 1 to 15 hidden
// layers, 1 <= D <= 65535).
long long siren_wg_workspace_bytes(int P, const int* dims, int n_layers, int D) {
  return wg_bytes(P, dims, n_layers, D, STASH_BF16, PLAN_LOSS_GRADS);
}

// Batched K1 over D stacked MLPs that share x (P, d_0), the counterpart of
// jax.vmap over the Pallas siren_loss_grads, with its bf16 stash: slot s's
// weights are W[l] + s w_slot[l] and b[l] + s b_slot[l] (floats; sine
// hidden layers of omegas[l], a linear last layer of one output), its
// target target + s P (the targets (D, P, 1)); it writes loss[s] = inv_n
// sum_{p < n_rows} (MLP(x)_p - target_p)^2 and dW[l] + s g_slot, db[l] + s
// g_slot. work: siren_wg_workspace_bytes bytes.
int siren_loss_grads_wg(const float* x, int P, int n_rows, const int* dims, int n_layers, int D,
                        const float* const* W, const float* const* b, const long long* w_slot,
                        const long long* b_slot, const float* omegas, const float* target,
                        float inv_n, void* work, float* const* dW, float* const* db,
                        long long g_slot, float* loss, cudaStream_t stream) {
  if (n_rows < 1 || n_rows > P) return -1;
  WgCall c{};
  c.x = x;
  c.P = P;
  c.n_rows = n_rows;
  c.L = n_layers;
  c.D = D;
  c.dims = dims;
  c.W = W;
  c.b = b;
  c.w_slot = w_slot;
  c.b_slot = b_slot;
  c.omegas = omegas;
  c.target = target;
  c.inv_n = inv_n;
  c.dW = dW;
  c.db = db;
  c.g_slot = g_slot;
  c.loss = loss;
  c.stash = STASH_BF16;
  c.plan = PLAN_LOSS_GRADS;
  return wg_run(c, work, stream);
}

// Bytes of workspace siren_loss_grads_wg_f32 needs, or -1 (the shapes as
// above, one slot).
long long siren_loss_grads_wg_f32_workspace_bytes(int P, const int* dims, int n_layers) {
  return wg_bytes(P, dims, n_layers, 1, STASH_F32, PLAN_LOSS_GRADS);
}

// K1 with the float32 stash: loss = inv_n * sum_{p < n_rows} (MLP(x)_p -
// target_p)^2 and every dW/db, for sine hidden layers (omegas[l]) and a
// linear last layer; work: siren_loss_grads_wg_f32_workspace_bytes bytes.
int siren_loss_grads_wg_f32(const float* x, int P, int n_rows, const int* dims, int n_layers,
                            const float* const* W, const float* const* b, const float* omegas,
                            const float* target, float inv_n, void* work, float* const* dW,
                            float* const* db, float* loss, cudaStream_t stream) {
  if (n_rows < 1 || n_rows > P) return -1;
  WgCall c{};
  c.x = x;
  c.P = P;
  c.n_rows = n_rows;
  c.L = n_layers;
  c.D = 1;
  c.dims = dims;
  c.W = W;
  c.b = b;
  c.omegas = omegas;
  c.target = target;
  c.inv_n = inv_n;
  c.dW = dW;
  c.db = db;
  c.loss = loss;
  c.stash = STASH_F32;
  c.plan = PLAN_LOSS_GRADS;
  return wg_run(c, work, stream);
}

// Bytes of workspace siren_forward_wg needs, or -1 (as above).
long long siren_forward_wg_workspace_bytes(int P, const int* dims, int n_layers) {
  return wg_bytes(P, dims, n_layers, 1, STASH_NONE, PLAN_FORWARD);
}

// K3: out (P, 1) = MLP(x) for sine hidden layers (omegas[l]) and a linear
// last layer; work: siren_forward_wg_workspace_bytes bytes.
int siren_forward_wg(const float* x, int P, const int* dims, int n_layers, const float* const* W,
                     const float* const* b, const float* omegas, void* work, float* out,
                     cudaStream_t stream) {
  WgCall c{};
  c.x = x;
  c.P = P;
  c.n_rows = P;
  c.L = n_layers;
  c.D = 1;
  c.dims = dims;
  c.W = W;
  c.b = b;
  c.omegas = omegas;
  c.out = out;
  c.stash = STASH_NONE;
  c.plan = PLAN_FORWARD;
  return wg_run(c, work, stream);
}

// Bytes of workspace siren_fused_bwd_wg needs with dW (need_dw != 0) or
// without, or -1 (as above).
long long siren_fused_bwd_wg_workspace_bytes(int P, const int* dims, int n_layers, int need_dw) {
  return wg_bytes(P, dims, n_layers, 1, STASH_F32, need_dw ? PLAN_LOSS_GRADS : PLAN_BWD_DX);
}

// K2 with the float32 stash: for g = dL/d out (P, 1), dx (P, d_0) unless dx
// is null and every dW/db unless dW is null; work:
// siren_fused_bwd_wg_workspace_bytes(..., dW != null) bytes.
int siren_fused_bwd_wg(const float* x, int P, const int* dims, int n_layers,
                       const float* const* W, const float* const* b, const float* omegas,
                       const float* g, void* work, float* const* dW, float* const* db, float* dx,
                       cudaStream_t stream) {
  WgCall c{};
  c.x = x;
  c.P = P;
  c.n_rows = P;
  c.L = n_layers;
  c.D = 1;
  c.dims = dims;
  c.W = W;
  c.b = b;
  c.omegas = omegas;
  c.g = g;
  c.dW = dW;
  c.db = db;
  c.dx = dx;
  c.stash = STASH_F32;
  c.plan = dW != nullptr ? PLAN_LOSS_GRADS : PLAN_BWD_DX;
  return wg_run(c, work, stream);
}

}  // extern "C"
