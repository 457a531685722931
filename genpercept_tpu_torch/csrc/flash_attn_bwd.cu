// Non-causal flash-attention backward for Hopper (sm_90a), f32 or bf16 in:
//   K3 flash_attn_bwd_dq   replaces genpercept_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel
//   K4 flash_attn_bwd_dkv  replaces genpercept_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (both reached through _flash_bwd_bhsd). They compute the TPU kernels' function
// from the forward's saved base-2 lse (lse2 = m*c + log2 l, c = scale*log2 e)
// and dsum = rowsum(dO * O), which the wrapper computes in f32:
//   P  = exp2(S*c - lse2),  S = Q K^T              f32
//   dP = dO V^T                                    f32 accumulate
//   dS = P * (dP - dsum) * scale, ROUNDED to k's dtype (K3) / q's dtype (K4)
//   dQ = sum_k dS K;  dK = sum_q dS^T Q;  dV = sum_q round(P^T to dO's dtype) dO
// with f32 accumulators and the outputs cast to the input dtypes.
//
// What bounds them on the card: like the forward, the (Sq x Sk) matrices never
// reach device memory, so both are bound by the matrix products: K3 runs
// three (S, dP, dS K), K4 four (S^T, dP^T, P^T dO, dS^T Q) per tile pair,
// and both recompute P; in f32 every product is three tf32 products. Two
// kernels, as on the TPU, so that no sum crosses CTAs: K3's CTA owns a q tile
// and loops over k tiles, K4's owns a k tile and loops over q tiles holding
// its dk and dv accumulators (bf16 at d = 512: one of them a pass, below).
// No atomics: results repeat bit for bit from run to run.
//
// One body serves both kernels. A CTA owns a tile of "rows" and loops over
// tiles of "cols" (64 in bf16; in f32 the tiling's BC):
//   K3: rows = queries, cols = keys;    A1 = Q, A2 = dO, B1 = K, B2 = V
//   K4: rows = keys,    cols = queries; A1 = K, A2 = V,  B1 = Q, B2 = dO
// X = A1 B1^T is S (K3) or S^T (K4), Y = A2 B2^T is dP or dP^T; lse2 and dsum
// belong to the query, the row's in K3 and the column's in K4; then
//   E1 = P (Y - dsum) scale,  out1 += E1 B1     (dq += dS K;  dk += dS^T Q)
//   E2 = P,                   out2 += E2 B2     (K4 only: dv += P^T dO)
// Rows past their length load zeros and are not stored; columns past theirs
// get P = 0, so ragged lengths need no padding.
//
// Bodies, for SD2.1's head dims 64 (UNet) and 512 (VAE mid block), all on
// the tensor cores: mma.sync in f32, wgmma in bf16. In the f32 bodies every
// warp owns 16 rows and a 64-wide slice of d; at d=512 the eight slices of a
// row group each write partial X and Y to shared memory and every warp sums
// the eight in one fixed order, so all eight hold identical P and dS (the d
// split K1 uses against the 227 KB limit), and each accumulates its slice of
// the outputs.
//   - f32 (flash_attn_bwd_f32_kernel): split TF32, as K1's f32 body. Every
//     operand x is split into hi = tf32(x), rounded to nearest with ties
//     away, and lo = x - hi truncated (common.cuh split_tf32), and each
//     product is lo.hi + hi.lo + hi.hi on mma.sync m16n8k8 (lo.lo dropped),
//     so K3's bound is its three products, K4's its four, at a third of the
//     TF32 rate (495 / 3 = 165 TFLOP/s). What the design does about it:
//       * one row-major copy of each B tile, staged by cp.async (16 bytes,
//         .cg) through a ring of NBUF (B1, B2) tiles filled NBUF - 1 tiles
//         ahead, one barrier a tile. X and Y read its rows as col operands
//         (column g, d t and t + 4), the output products with k = column
//         (rows 2t and 2t + 1, column g); rows of D + 4 floats keep both
//         patterns free of bank conflicts (bank 4 row + column);
//       * E1 and E2 stay in registers: the key order inside each 8-column
//         group is relabelled (column 2t at k position t, 2t + 1 at t + 4),
//         so the C layout of X and Y is the A layout of the output products;
//       * each column tile's output products sum into accumulators of their
//         own, added to the running sums once per tile: the tensor cores
//         truncate every sum into an accumulator, and in one accumulator
//         over the whole column loop that bias grows with the length;
//       * A1 and A2 stay in shared memory (their hi and lo for a slice
//         would take 128 registers beside the accumulators): split at each
//         k step (APRE false) or split once when staged (APRE true), a
//         template choice taken per kernel by measurement; B is split at
//         each read. Tilings by measurement (scripts/tune_k34.py, PERF.md):
//         d=64 64 rows a CTA (4 warps), 32 columns a tile, 2 buffers, K4
//         with A pre-split; d=512 16 rows a CTA (8 warps, one slice each),
//         16 columns a tile, 2 buffers.
//   - bf16, d = 512 (flash_attn_bwd_wgmma_d512_kernel): the products at the
//     bf16 tensor rate, eight times d = 64's work a logit, so the one
//     exponential a logit is small beside them; what decides the design is
//     where the operands and sums fit. The budgets:
//       * registers: a 64-row f32 output over d = 512 is 128 KB, 128
//         registers a thread over two warpgroups (as K1 holds O). K3 has one
//         (dq); K4's two (dk, dv) would take the SM's whole register file,
//         and shared memory cannot hold them either. So K4 runs two passes
//         of the body, each a kernel of its own: the dk pass (S^T, dP^T,
//         dk += dS^T Q: K3's structure, the roles swapped) and the dv pass
//         (S^T, dv += round(P^T) dO: the forward's). Five products to the
//         function's four, 25% more work. The dv pass is launched with PDL
//         (programmatic dependent launch): it starts once every CTA of the
//         dk pass has started, fills the dk pass's last wave, and ends only
//         after the dk pass. No room for per-tile parts either (another 128
//         registers): each output sums in one f32 accumulator over the
//         column loop.
//       * shared memory (232,448 bytes a CTA): A1 and A2 resident, 64 rows
//         as 8 atoms of 64 columns each (2 x 64 KB; the dv pass loads A1
//         alone); the E tile, 64 x 64 bf16, twice (16 KB); the column tiles
//         stream as 64-column atoms (8 KB: 64 columns' rows of 64 values of
//         d) through a ring of NBUF = 10 stages (80 KB). B1 is read by X and
//         again, MN-major, by the output product, so its 8 atoms stay from X
//         to the end of that product; B2 is read by Y alone, each atom
//         released as its group retires. So Y runs first, then X, and tile
//         j + 1's first B2 atoms land in the two spare stages, the rest as
//         the output product releases B1's.
//       * shared-memory bandwidth: a wgmma m64nNk16 with both operands in
//         shared memory reads (64 + N) 32 bytes for 64 N 32 flop; at about
//         4,100 dense bf16 flop and 128 bytes a clock an SM sits at the
//         limit with N = 64 and needs 1.5x at N = 32.
//     The design: a CTA of 64 rows, a producer warpgroup (setmaxnreg 40, one
//     thread issuing every TMA copy onto a "full" mbarrier a stage, waiting
//     on its "empty" one: the first product's A by the 3-D map, 8 atoms, then
//     each column tile's 16 atoms, B2's then B1's (the dv pass: B1's then
//     B2's), and in the XY passes A1 after the first tile's B2 atoms) and two
//     consumer warpgroups (232 registers) that split X and Y by columns:
//     warpgroup w computes both for the tile's columns 32 w.., as m64n32k16
//     over d (4 k steps an atom). Its P and E in the accumulator layout,
//     rounded to bf16, go into its half of the E tile in the 128-byte
//     swizzle; a named barrier joins the two; then warpgroup w owns
//     out[:, 256 w : 256 w + 256] and adds E B over its 4 atoms of B as
//     m64n64k16, E K-major and B MN-major through the transpose bit, each
//     atom released as its group retires. One product of an atom, not one
//     m64n256k16 over four: the four atoms of a half need not lie in
//     consecutive stages, so the ring takes 10 stages, not 8. Every thread
//     waits on every atom of the stream in order (the dv pass's B2 atoms
//     after X, where the XY passes wait on B1's) and releases the other
//     warpgroup's half of the kept atoms at once; the code is the same in
//     both warpgroups, only addresses differ (a branch by warpgroup around
//     the waits made ptxas serialize every wgmma, advisory C7520, as did one
//     kernel for both of K4's passes). K4 reads its columns' lse2 and dsum
//     from global memory as a tile starts, so the loads land under its
//     products. Each stage waits for its own products (wait_group 0 before
//     any branch), so ptxas can follow every wgmma. Measured variants
//     (scripts/tune_k34.py, PERF.md): rings of 8 to 10 stages within 1%, K4's
//     passes launched without PDL up to 20% slower; E loaded into registers
//     by ldmatrix for the output product (a quarter of its shared-memory
//     reads) ran 5% slower and is not kept.
//   - bf16, d = 64 (flash_attn_bwd_wgmma_kernel): the products at the bf16
//     tensor rate (K3 3, K4 4 a tile pair: 6 and 8 flop a logit per d) and
//     beside them one exponential a logit on the 16-a-clock MUFU, which at
//     d = 64 takes about half as long as K4's products. The design keeps the
//     tensor cores fed and runs the exponentials while they work:
//       * wgmma only. A consumer warpgroup owns 64 rows: A1 and A2 (64 rows
//         of 128 bytes each, the 128-byte swizzle) land once by TMA. X and Y
//         are m64n64k16, four k steps over d, both operands K-major from
//         shared memory. P and E1 (and K4's E2) are computed in the
//         accumulator layout, packed to bf16 pairs and are at once the
//         register A operands of out1 += E1 B1 (and out2 += E2 B2), m64n64k16
//         over the tile's 64 columns, which read the B tile [col][d]
//         MN-major through the transpose bit, as K1 reads V: one copy of
//         each B tile serves both of its products.
//       * A producer warpgroup (setmaxnreg 24; the consumers take the rest)
//         issues every copy by TMA into a ring of NBUF stages, a "full"
//         mbarrier a stage and an "empty" one that every consumer thread
//         arrives on once the tile's output products have retired: B1 and
//         B2 by 3-D maps (rows past their length arrive as zeros), and in
//         K4 the column tile's lse2 and dsum by flat 1-D maps over bh * sq
//         f32 values, boxes from the 16-byte boundary at or before the
//         tile's first column (a 2-D map would need 16-byte row strides,
//         which ragged Sq lacks). K3 reads its rows' lse2 and dsum once into
//         registers.
//       * Each stage overlaps within its warpgroup: it issues tile j + 1's
//         X and Y and tile j's first output product together, and once the
//         first retire (wgmma.wait_group 1) the exponentials of tile j + 1
//         run while the product is in flight; K4's second output product
//         follows through the same registers, beside tile j + 1's dS. (K4
//         with both products in flight at once, two tiles' parts beside
//         two tiles' X and Y, spilled and ran 27% slower.) A stage is
//         straight-line code from its first wgmma to its last wait, the
//         mask of the last tile compiled into its own copy: where ptxas
//         cannot follow a stage it serializes every wgmma (advisory C7514).
//         Across warpgroups the SM overlaps too: K3 runs two CTAs a SM of
//         one consumer warpgroup each, K4 one CTA of two consumer
//         warpgroups (240 registers each; at 232, two CTAs a SM, it spilled
//         24 bytes and ran 4% slower). Tilings by measurement
//         (scripts/tune_k34.py --dtype bf16, PERF.md): rings of 4 column
//         tiles.
//       * Each tile's output products sum from zero into a part of their
//         own, added to the running sums by f32 adds, as the TPU adds each
//         block's product into its accumulator (one accumulator over the
//         loop ran 8% faster, at twice the mean error).
//     exp2 is ex2.approx.ftz. Columns past their length get P = 0 (keys past
//     Sk in K3; queries past Sq in K4, whose lse2 would come from the next
//     head or zeros; with the zero rows of Q and dO they would add nothing,
//     but a mask keeps P finite whatever lse2 holds); rows past theirs are
//     computed on zeros and not stored.

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace gp;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBC = 64;  // cols per tile of the bf16 bodies
constexpr int kDC = 64;  // the slice of d a warp of the f32 body owns

struct Args {
  const void* a1;
  const void* a2;
  const void* b1;
  const void* b2;
  const float* lse;   // (bh, sq) base-2 lse of the scaled logits
  const float* dsum;  // (bh, sq) rowsum(dO * O)
  void* out1;         // dq (K3) or dk (K4)
  void* out2;         // dv (K4)
  int n_rows, n_cols;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

// ---------------------------------------------------------------------------
// f32 body: split TF32 on mma.sync m16n8k8 (the file header gives the design)

template <int D, int PARTS, int SPLITS, int BC, int NBUF, bool APRE>
struct F32Tile {
  static constexpr int THREADS = 32 * PARTS * SPLITS;
  static constexpr int BR = 16 * PARTS;  // rows a CTA
  static constexpr int DS = D / SPLITS;  // a warp's slice of d
  static constexpr int LD = D + 4;       // row stride of the A and B tiles (floats)
  static constexpr int PLD = BC + 4;     // row stride of the partial X and Y
  static constexpr int A_TILE = BR * LD;
  static constexpr int B_TILE = BC * LD;
  // A1, A2 (APRE: hi and lo of each); the ring of NBUF (B1, B2) tiles;
  // SPLITS > 1: partial X and Y
  static constexpr int RING_OFF = (APRE ? 4 : 2) * A_TILE;
  static constexpr int PART_OFF = RING_OFF + NBUF * 2 * B_TILE;
  static constexpr int FLOATS = PART_OFF + (SPLITS > 1 ? 2 * SPLITS * BR * PLD : 0);
  static constexpr size_t BYTES = (size_t)FLOATS * sizeof(float);
  static_assert(DS == kDC && BC % 8 == 0 && NBUF >= 2, "64-wide slices, 8-column groups, a ring");
};

__device__ __forceinline__ uint4 split4(float4 x, uint4& lo) {
  uint4 hi;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  return hi;
}

template <int D, int PARTS, int SPLITS, int BC, int NBUF, bool APRE, bool DKV>
__global__ void __launch_bounds__(32 * PARTS * SPLITS) flash_attn_bwd_f32_kernel(Args args) {
  using L = F32Tile<D, PARTS, SPLITS, BC, NBUF, APRE>;
  constexpr int LD = L::LD, THREADS = L::THREADS;
  constexpr int KD = L::DS / 8;  // k steps of X and Y over the warp's slice
  constexpr int NS = BC / 8;     // 8-column groups: n tiles of X and Y, k steps of the outputs
  constexpr int NO = L::DS / 8;  // 8-wide tiles of the warp's output slice
  constexpr int kOutTiles = 4;   // output tiles per pass of mma_3xtf32
  static_assert(NO % kOutTiles == 0, "output tiles in whole passes");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t* Apre = reinterpret_cast<const uint32_t*>(smem);  // APRE: A1h, A1l, A2h, A2l
  float* ring = smem + L::RING_OFF;
  float* Xp = smem + L::PART_OFF;  // [SPLITS][BR][PLD]
  float* Yp = Xp + SPLITS * L::BR * L::PLD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp % PARTS, slice = warp / PARTS;
  const int g = lane / 4, t = lane % 4;
  const int rw = part * 16 + g;  // this thread's rows rw and rw + 8 of the tile
  const int d0 = slice * L::DS;
  const int n_rows = args.n_rows, n_cols = args.n_cols;
  const int r0 = blockIdx.x * L::BR;
  const size_t bh = blockIdx.y;
  const float* a1 = static_cast<const float*>(args.a1) + bh * n_rows * D;
  const float* a2 = static_cast<const float*>(args.a2) + bh * n_rows * D;
  const float* b1 = static_cast<const float*>(args.b1) + bh * n_cols * D;
  const float* b2 = static_cast<const float*>(args.b2) + bh * n_cols * D;
  const size_t sq = DKV ? n_cols : n_rows;
  const float* lse = args.lse + bh * sq;
  const float* dsum = args.dsum + bh * sq;
  const float scale = args.scale;
  const float c = scale * kLog2e;
  const int ntile = (n_cols + BC - 1) / BC;

  // one commit group per column tile (B1 and B2), empty past the last, so
  // that "tile j has landed" is always cp.async.wait_group NBUF - 2 at tile j
  auto load_tile = [&](int j) {
    if (j < ntile) {
      float* dst = ring + (j % NBUF) * 2 * L::B_TILE;
      cp_async_rows<D, BC, THREADS>(dst, b1, j * BC, n_cols);
      cp_async_rows<D, BC, THREADS>(dst + L::B_TILE, b2, j * BC, n_cols);
    }
    cp_async_commit();
  };

  // A1, A2: split once into hi and lo (APRE), or staged as they are (they
  // land with tile 0) and split at each k step
  if constexpr (APRE) {
    uint32_t* As = reinterpret_cast<uint32_t*>(smem);
    for (int idx = threadIdx.x; idx < L::BR * (D / 4); idx += THREADS) {
      const int r = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < n_rows) x = load4((m ? a2 : a1) + (size_t)(r0 + r) * D + c4);
        uint4 lo;
        *reinterpret_cast<uint4*>(As + 2 * m * L::A_TILE + r * LD + c4) = split4(x, lo);
        *reinterpret_cast<uint4*>(As + (2 * m + 1) * L::A_TILE + r * LD + c4) = lo;
      }
    }
  } else {
    cp_async_rows<D, L::BR, THREADS>(smem, a1, r0, n_rows);
    cp_async_rows<D, L::BR, THREADS>(smem + L::A_TILE, a2, r0, n_rows);
  }
#pragma unroll
  for (int j = 0; j < NBUF - 1; ++j) load_tile(j);

  // the A fragment (rows rw, rw + 8; k step kd of this warp's slice) of A1
  // (m = 0) or A2 (m = 1), in hi and lo
  auto a_frag = [&](int m, int kd, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const int off = rw * LD + d0 + kd * 8 + t;
    if constexpr (APRE) {
      const uint32_t* hi = Apre + 2 * m * L::A_TILE + off;
      const uint32_t* lo = hi + L::A_TILE;
      ah[0] = hi[0]; ah[1] = hi[8 * LD]; ah[2] = hi[4]; ah[3] = hi[8 * LD + 4];
      al[0] = lo[0]; al[1] = lo[8 * LD]; al[2] = lo[4]; al[3] = lo[8 * LD + 4];
    } else {
      const float* p = smem + m * L::A_TILE + off;
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * LD], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * LD + 4], ah[3], al[3]);
    }
  };

  float row_lse[2] = {0.f, 0.f}, row_dsum[2] = {0.f, 0.f};
  if (!DKV)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + rw + 8 * h;
      if (row < n_rows) {
        row_lse[h] = lse[row];
        row_dsum[h] = dsum[row];
      }
    }

  float acc1[NO][4], acc2[DKV ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[n][e] = 0.f;
      if constexpr (DKV) acc2[n][e] = 0.f;
    }

  for (int j = 0; j < ntile; ++j) {
    const int c0 = j * BC;
    // K4: lse2 and dsum of this thread's columns (queries), read early
    float col_lse[DKV ? NS : 1][2], col_dsum[DKV ? NS : 1][2];
    if constexpr (DKV)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + n * 8 + 2 * t + e;
          const bool ok = col < n_cols;
          col_lse[n][e] = ok ? lse[col] : 0.f;
          col_dsum[n][e] = ok ? dsum[col] : 0.f;
        }
    cp_async_wait<NBUF - 2>();
    __syncthreads();  // tile j is visible; every warp is done with tile j - 1
    load_tile(j + NBUF - 1);
    // B2's tile follows B1's (element i of B2 at i + B_TILE); both are split
    // into hi and lo at each read
    const float* B1t = ring + (j % NBUF) * 2 * L::B_TILE;

    // X = A1 B1^T and Y = A2 B2^T over this warp's slice of d: B's rows are
    // the col operands (column n*8 + g, d kd*8 + t and + 4)
    float x[NS][4], y[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = y[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ah[4], al[4], bh[NS][2], bl[NS][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a_frag(m, kd, ah, al);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int i = m * L::B_TILE + (n * 8 + g) * LD + d0 + kd * 8 + t;
          split_tf32(B1t[i], bh[n][0], bl[n][0]);
          split_tf32(B1t[i + 4], bh[n][1], bl[n][1]);
        }
        mma_3xtf32<NS>(m ? y : x, ah, al, bh, bl);
      }
    }
    if constexpr (SPLITS > 1) {  // sum the slices' partial X and Y in one fixed order
      float* xm = Xp + (slice * L::BR + part * 16) * L::PLD;
      float* ym = Yp + (slice * L::BR + part * 16) * L::PLD;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (g + 8 * h) * L::PLD + n * 8 + 2 * t;
          *reinterpret_cast<float2*>(xm + off) = make_float2(x[n][2 * h], x[n][2 * h + 1]);
          *reinterpret_cast<float2*>(ym + off) = make_float2(y[n][2 * h], y[n][2 * h + 1]);
        }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (rw + 8 * h) * L::PLD + n * 8 + 2 * t;
          float2 sx = make_float2(0.f, 0.f), sy = sx;
#pragma unroll
          for (int s = 0; s < SPLITS; ++s) {
            const float2 px = *reinterpret_cast<const float2*>(Xp + s * L::BR * L::PLD + off);
            const float2 py = *reinterpret_cast<const float2*>(Yp + s * L::BR * L::PLD + off);
            sx.x += px.x; sx.y += px.y;
            sy.x += py.x; sy.y += py.y;
          }
          x[n][2 * h] = sx.x; x[n][2 * h + 1] = sx.y;
          y[n][2 * h] = sy.x; y[n][2 * h + 1] = sy.y;
        }
    }

    // P; E1 = P (Y - dsum) scale into x, E2 = P into y, in registers
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float l2, ds;
        if constexpr (DKV) {
          l2 = col_lse[n][e & 1];
          ds = col_dsum[n][e & 1];
        } else {
          l2 = row_lse[e / 2];
          ds = row_dsum[e / 2];
        }
        const float p = (c0 + n * 8 + 2 * t + (e & 1) < n_cols) ? exp2f(x[n][e] * c - l2) : 0.f;
        x[n][e] = p * (y[n][e] - ds) * scale;
        y[n][e] = p;
      }

    // out1 += E1 B1 (and out2 += E2 B2): column 2t of group jk at k position
    // t, column 2t + 1 at t + 4, so E's C layout is the A layout; B's rows
    // 2t, 2t + 1 of the group are read at output column g. The tile's
    // products sum into accumulators of their own, from zero, which are
    // added to out's once per tile: the tensor cores truncate each sum into
    // an accumulator, and over thousands of columns in one accumulator that
    // bias grows with the length (1.2e-4 of max|plain| at 9216 tokens)
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += kOutTiles)
#pragma unroll
      for (int m = 0; m < (DKV ? 2 : 1); ++m) {
        float part[kOutTiles][4];
#pragma unroll
        for (int n = 0; n < kOutTiles; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
        for (int jk = 0; jk < NS; ++jk) {
          const float(&ev)[4] = m ? y[jk] : x[jk];
          uint32_t eh[4], el[4], bh[kOutTiles][2], bl[kOutTiles][2];
          split_tf32(ev[0], eh[0], el[0]);
          split_tf32(ev[2], eh[1], el[1]);
          split_tf32(ev[1], eh[2], el[2]);
          split_tf32(ev[3], eh[3], el[3]);
          const int i0 = m * L::B_TILE + (jk * 8 + 2 * t) * LD + d0 + n0 * 8 + g;
#pragma unroll
          for (int n = 0; n < kOutTiles; ++n) {
            split_tf32(B1t[i0 + n * 8], bh[n][0], bl[n][0]);
            split_tf32(B1t[i0 + LD + n * 8], bh[n][1], bl[n][1]);
          }
          mma_3xtf32<kOutTiles>(part, eh, el, bh, bl);
        }
        float(*acc)[4] = (m ? acc2 : acc1) + n0;
#pragma unroll
        for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
  }

  float* out1 = static_cast<float*>(args.out1) + bh * n_rows * D;
  float* out2 = DKV ? static_cast<float*>(args.out2) + bh * n_rows * D : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rw + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const size_t off = (size_t)row * D + d0 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(out1 + off) = make_float2(acc1[n][2 * h], acc1[n][2 * h + 1]);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(out2 + off) = make_float2(acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

template <int D, int PARTS, int SPLITS, int BC, int NBUF, bool APRE, bool DKV>
cudaError_t launch_f32(const Args& a, int bh, cudaStream_t stream) {
  using L = F32Tile<D, PARTS, SPLITS, BC, NBUF, APRE>;
  auto kern = flash_attn_bwd_f32_kernel<D, PARTS, SPLITS, BC, NBUF, APRE, DKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n_rows + L::BR - 1) / L::BR, bh);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at d = 64: the wgmma body (the file header gives the design). NWG
// consumer warpgroups of 64 rows a CTA, a ring of NBUF column tiles

// K4's lse2 and dsum boxes: a column tile's kBC values and up to 3 before
// them, so that every box starts on a 16-byte boundary (a 1-D TMA box at an
// element offset off 16 bytes faults: an illegal instruction at Sq = 77)
constexpr int kColBox = kBC + 4;

template <int NWG, int NBUF>
struct WgBwdTile {
  static constexpr int BR = 64 * NWG;              // rows a CTA
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int AB = 64 * 128;              // bytes of a warpgroup's A1 or A2
  static constexpr int TB = kBC * 128;             // bytes of a B1 or B2 tile
  static constexpr int STAGE = 2 * TB;             // B1 and B2 of a column tile
  // K4: lse2 and dsum of a column tile, each a box of kColBox values from the
  // 16-byte boundary at or before the tile's first, in a 384-byte slot
  static constexpr int COLV = 2 * 384;
  static constexpr size_t BYTES =
      1024 + (size_t)NWG * 2 * AB + (size_t)NBUF * (STAGE + COLV) + 8 * (1 + 2 * NBUF);
  // setmaxnreg as K1's bf16 bodies: a kernel starts with 64K / (THREADS *
  // MINB) registers a thread, rounded down to 8; the producer keeps 24 and
  // the consumers share the rest. Two CTAs a SM at one consumer warpgroup.
  static constexpr int MINB = NWG == 1 ? 2 : 1;
  static constexpr int REGS = 65536 / (THREADS * MINB) / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) / NWG / 8 * 8;
  static_assert((NWG == 1 || NWG == 2) && NBUF >= 2, "warpgroups and ring");
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
  static_assert(MINB * BYTES <= 232448, "shared memory of the CTAs of a SM");
};

template <int NWG, int NBUF, bool DKV>
__global__ void __launch_bounds__(WgBwdTile<NWG, NBUF>::THREADS, WgBwdTile<NWG, NBUF>::MINB)
flash_attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap ta1,
                            const __grid_constant__ CUtensorMap ta2,
                            const __grid_constant__ CUtensorMap tb1,
                            const __grid_constant__ CUtensorMap tb2,
                            const __grid_constant__ CUtensorMap tlse,
                            const __grid_constant__ CUtensorMap tdsum, const Args args) {
  using T = WgBwdTile<NWG, NBUF>;
  constexpr int NS = kBC / 8;   // 8-column tiles of X and Y
  constexpr int KP = kBC / 16;  // k steps of the output products
  constexpr int NO = 8;         // 8-wide tiles of an output row (d = 64)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [NWG][A1, A2]
  uint8_t* ring = As + NWG * 2 * T::AB;                          // [NBUF][B1, B2]
  uint8_t* colv = ring + NBUF * T::STAGE;  // [NBUF][lse2, dsum][384 B]
  uint64_t* a_full = reinterpret_cast<uint64_t*>(colv + NBUF * T::COLV);
  uint64_t* full = a_full + 1;
  uint64_t* empty = full + NBUF;

  const int n_rows = args.n_rows, n_cols = args.n_cols;
  const int r0 = blockIdx.x * T::BR;
  const int bh = blockIdx.y;
  const int ntile = (n_cols + kBC - 1) / kBC;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, T::CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= T::CONSUMERS) {  // the producer warpgroup
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS) {
      mbar_expect_tx(a_full, NWG * 2 * T::AB);
      for (int w = 0; w < NWG; ++w) {
        tma_load_3d(As + 2 * w * T::AB, &ta1, a_full, 0, r0 + 64 * w, bh);
        tma_load_3d(As + (2 * w + 1) * T::AB, &ta2, a_full, 0, r0 + 64 * w, bh);
      }
      for (int i = 0; i < ntile; ++i) {
        const int s = i % NBUF;
        if (i >= NBUF) mbar_wait(empty + s, (i / NBUF - 1) & 1);  // tile i - NBUF released
        mbar_expect_tx(full + s, T::STAGE + (DKV ? 2 * kColBox * 4 : 0));
        tma_load_3d(ring + s * T::STAGE, &tb1, full + s, 0, i * kBC, bh);
        tma_load_3d(ring + s * T::STAGE + T::TB, &tb2, full + s, 0, i * kBC, bh);
        if constexpr (DKV) {  // this head's columns in the flat (bh * sq) maps
          const int c0 = (bh * n_cols + i * kBC) & ~3;
          tma_load_1d(colv + s * T::COLV, &tlse, full + s, c0);
          tma_load_1d(colv + s * T::COLV + T::COLV / 2, &tdsum, full + s, c0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<T::CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;  // rows lane / 4 and lane / 4 + 8 of the warp's 16, columns 2t, 2t + 1
  const int row0 = r0 + wg * 64 + warp * 16 + lane / 4;
  const uint8_t* A1w = As + 2 * wg * T::AB;
  const uint8_t* A2w = A1w + T::AB;
  const float scale = args.scale, c = scale * kLog2e;
  // K4: where a column tile's first value lies in its lse2 and dsum boxes
  const int col0 = (bh * n_cols) & 3;

  // K3: lse2 and dsum of this thread's rows (queries)
  float row_lse[2] = {0.f, 0.f}, row_dsum[2] = {0.f, 0.f};
  if constexpr (!DKV)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < n_rows) {
        row_lse[h] = args.lse[(size_t)bh * n_rows + row0 + 8 * h];
        row_dsum[h] = args.dsum[(size_t)bh * n_rows + row0 + 8 * h];
      }

  float x[NS][4], y[NS][4];                  // X, Y of a column tile; then E1, E2 in f32
  float acc1[NO][4], acc2[DKV ? NO : 1][4];  // out1, out2 over the column loop
  float prod[NO][4];                         // a column tile's output product
  uint32_t e1f[KP][4], e2f[DKV ? KP : 1][4];  // E1, E2 in bf16: the register A operands
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[n][e] = 0.f;
      if constexpr (DKV) acc2[n][e] = 0.f;
    }

  // The descriptors of a chain step on from its tiles' bases by whole 16-byte
  // units, from bases the compiler cannot hoist out of the column loop.
  // X = A1 B1^T (m = 0) or Y = A2 B2^T (m = 1), both K-major
  auto issue_xy = [&](int j, int m, float (&d)[NS][4]) {
    const uint8_t* st = ring + (j % NBUF) * T::STAGE + m * T::TB;
    const uint32_t step = opaque(0);
    const uint64_t da = sw128_desc(m ? A2w : A1w), db = sw128_desc(st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + step + 2 * kk, db + step + 2 * kk, kk);
  };
  // prod = E B1 (m = 0) or E B2 (m = 1): the B tile [col][d] read MN-major,
  // 16 columns (2048 bytes) a k step
  auto issue_out = [&](int j, int m, float (&prod)[NO][4], const uint32_t (&e)[KP][4]) {
    const uint8_t* st = ring + (j % NBUF) * T::STAGE + m * T::TB;
    const uint32_t step = opaque(0);
    const uint64_t db = sw128_desc(st);
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) wgmma_rs(prod, e[kk], db + step + 128 * kk, kk);
  };
  // P = exp2(X c - lse2) into x, 0 past the columns' end (MASK: the last
  // tile). K4 reads each column's lse2 (the query's) from the ring
  auto probs = [&](int j, auto mask) {
    const float* cl = reinterpret_cast<const float*>(colv + (j % NBUF) * T::COLV) + col0;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float2 l2 = make_float2(row_lse[0], row_lse[1]);
      if constexpr (DKV) l2 = make_float2(cl[n * 8 + 2 * t], cl[n * 8 + 2 * t + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float le = (DKV ? e & 1 : e / 2) ? l2.y : l2.x;
        const float p = ex2(fmaf(x[n][e], c, -le));
        x[n][e] = decltype(mask)::value && j * kBC + n * 8 + 2 * t + (e & 1) >= n_cols ? 0.f : p;
      }
    }
  };
  // E1 = P (Y - dsum) scale into x and E2 = P into y, from P in x
  auto grads = [&](int j) {
    const float* cl =
        reinterpret_cast<const float*>(colv + (j % NBUF) * T::COLV + T::COLV / 2) + col0;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float2 ds = make_float2(row_dsum[0], row_dsum[1]);
      if constexpr (DKV) ds = make_float2(cl[n * 8 + 2 * t], cl[n * 8 + 2 * t + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = x[n][e];
        x[n][e] = p * (y[n][e] - ((DKV ? e & 1 : e / 2) ? ds.y : ds.x)) * scale;
        y[n][e] = p;
      }
    }
  };
  // v rounded to bf16 pairs into the A operand e: k step n / 2, register
  // 2 (n % 2) + r is the accumulator's n-tile n, row half r
  auto pack = [&](auto& e, const float (&v)[NS][4]) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) e[n / 2][(n % 2) * 2 + r] = pack_bf16(v[n][2 * r], v[n][2 * r + 1]);
  };
  // a tile's output product, retired in prod, into a running sum: f32 adds
  auto add_part = [&](float (&acc)[NO][4]) {
    reg_fence(prod);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += prod[n][e];
  };
  // X and Y of tile j, then E1 and E2 packed (the first tile)
  auto xy_alone = [&](int j, auto mask) {
    mbar_wait(full + j % NBUF, (j / NBUF) & 1);
    reg_fence(x);
    reg_fence(y);
    wgmma_fence();
    issue_xy(j, 0, x);
    issue_xy(j, 1, y);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(x);
    reg_fence(y);
    probs(j, mask);
    grads(j);
    pack(e1f, x);
    if constexpr (DKV) pack(e2f, y);
  };
  // tile j's output products one after the other, then its ring stage
  // released (the last tile)
  auto out_alone = [&](int j) {
    reg_fence(prod);
    reg_fence(e1f);
    wgmma_fence();
    issue_out(j, 0, prod, e1f);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(e1f);
    add_part(acc1);
    if constexpr (DKV) {
      reg_fence(e2f);
      wgmma_fence();
      issue_out(j, 1, prod, e2f);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(e2f);
      add_part(acc2);
    }
    mbar_arrive(empty + j % NBUF);
  };
  // Stage j, straight-line from its first wgmma to its last wait (ptxas
  // serializes every wgmma when it cannot follow a stage): X and Y of tile
  // j + 1 and out1's product of tile j on the tensor cores; once X and Y
  // retire, tile j + 1's P while the product is in flight. In K4 out2's
  // product follows through the same registers (two parts beside two tiles' X
  // and Y spilled), beside tile j + 1's E. Then tile j's stage is released
  // and tile j + 1's E packed.
  auto stage = [&](int j, auto mask) {
    mbar_wait(full + (j + 1) % NBUF, ((j + 1) / NBUF) & 1);
    reg_fence(x);
    reg_fence(y);
    reg_fence(prod);
    reg_fence(e1f);
    wgmma_fence();
    issue_xy(j + 1, 0, x);
    issue_xy(j + 1, 1, y);
    wgmma_commit();
    issue_out(j, 0, prod, e1f);
    wgmma_commit();
    wgmma_wait<1>();  // X, Y retired; E1 B1 in flight
    reg_fence(x);
    reg_fence(y);
    probs(j + 1, mask);
    if constexpr (DKV) {
      wgmma_wait<0>();
      reg_fence(e1f);
      add_part(acc1);
      reg_fence(e2f);
      wgmma_fence();
      issue_out(j, 1, prod, e2f);
      wgmma_commit();
      grads(j + 1);
      pack(e1f, x);
      wgmma_wait<0>();
      reg_fence(e2f);
      mbar_arrive(empty + j % NBUF);
      add_part(acc2);
      pack(e2f, y);
    } else {
      grads(j + 1);
      wgmma_wait<0>();
      reg_fence(e1f);
      mbar_arrive(empty + j % NBUF);
      add_part(acc1);
      pack(e1f, x);
    }
  };

  mbar_wait(a_full, 0);
  if (ntile == 1) xy_alone(0, std::true_type{});
  else xy_alone(0, std::false_type{});
  for (int j = 0; j + 2 < ntile; ++j) stage(j, std::false_type{});
  if (ntile > 1) stage(ntile - 2, std::true_type{});  // the last tile may be partial
  out_alone(ntile - 1);

  __nv_bfloat16* out1 = static_cast<__nv_bfloat16*>(args.out1) + (size_t)bh * n_rows * 64;
  __nv_bfloat16* out2 =
      DKV ? static_cast<__nv_bfloat16*>(args.out2) + (size_t)bh * n_rows * 64 : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const size_t off = (size_t)row * 64 + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out1 + off) =
          __floats2bfloat162_rn(acc1[n][2 * h], acc1[n][2 * h + 1]);
      if constexpr (DKV)
        *reinterpret_cast<__nv_bfloat162*>(out2 + off) =
            __floats2bfloat162_rn(acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

// K3: A = (q, dout) rows of sq, B = (k, v) rows of sk; K4 the other way
// round, with lse2 and dsum by the flat 1-D maps
template <int NWG, int NBUF, bool DKV>
cudaError_t launch_wgmma(const Args& a, int bh, cudaStream_t stream) {
  using T = WgBwdTile<NWG, NBUF>;
  const size_t sq = DKV ? a.n_cols : a.n_rows;
  CUtensorMap ta1, ta2, tb1, tb2, tlse, tdsum;
  if (!(tma_map_bhsd(&ta1, a.a1, 64, a.n_rows, bh, 64) &&
        tma_map_bhsd(&ta2, a.a2, 64, a.n_rows, bh, 64) &&
        tma_map_bhsd(&tb1, a.b1, 64, a.n_cols, bh, kBC) &&
        tma_map_bhsd(&tb2, a.b2, 64, a.n_cols, bh, kBC) &&
        tma_map_f32_1d(&tlse, a.lse, (size_t)bh * sq, kColBox) &&
        tma_map_f32_1d(&tdsum, a.dsum, (size_t)bh * sq, kColBox)))
    return cudaErrorInvalidValue;
  auto kern = flash_attn_bwd_wgmma_kernel<NWG, NBUF, DKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n_rows + T::BR - 1) / T::BR, bh);
  kern<<<grid, T::THREADS, T::BYTES, stream>>>(ta1, ta2, tb1, tb2, tlse, tdsum, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at d = 512: the wgmma body (the file header gives the design). CTAs of
// 64 rows: two consumer warpgroups and a producer one; the column tiles'
// 64-column atoms stream through a ring of NBUF atom stages

// what a kernel of the d = 512 body computes: K3's dq, or K4's dk (its dk
// pass: S^T, dP^T, dS^T Q) or dv (its dv pass: S^T, P^T dO)
enum D512Pass { kPassDq, kPassDk, kPassDv };

template <int NBUF>
struct WgD512Bwd {
  static constexpr int ATOMS = 8;                  // 64-column atoms of a 512 row
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int ATOM = 64 * 128;            // bytes of an atom: 64 rows of 64 bf16
  static constexpr int NBAR = 2 + 2 * NBUF;        // A (two), full, empty
  // A1 and A2 (8 atoms each), two E tiles (an atom each), the ring, the
  // mbarriers
  static constexpr size_t BYTES = 1024 + (size_t)(2 * ATOMS + 2 + NBUF) * ATOM + 8 * NBAR;
  // setmaxnreg as K1's d = 512 body: 65536 / 384 rounded down to 8 at launch
  static constexpr int REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) / 2 / 8 * 8;
  static_assert(NBUF >= ATOMS, "a column tile's kept B atoms fit the ring");
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
  static_assert(BYTES <= 232448, "shared memory of a CTA");
};

// The consumer warpgroups of one pass (the producer is the kernel's). Tile j
// takes stream positions 16 j + a: first the 8 atoms of the B that one
// product reads (B2 for Y; the dv pass's B1 for X), each released once read,
// then the 8 of the B that the output product reads (B1, also read by X; the
// dv pass's B2).
template <int NBUF, int PASS>
__device__ __forceinline__ void bwd_d512_consumer(const Args& args, const uint8_t* A1s,
                                                  const uint8_t* A2s, uint8_t* Es,
                                                  const uint8_t* ring, uint64_t* a1_full,
                                                  uint64_t* full, uint64_t* empty, int ntile) {
  using T = WgD512Bwd<NBUF>;
  constexpr bool XY = PASS != kPassDv;      // E = dS from X and Y; the dv pass: E = P
  constexpr bool BY_COL = PASS != kPassDq;  // lse2 and dsum of the column (K4)
  constexpr int NS = 4;                     // 8-column tiles of a warpgroup's 32 columns
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = warp * 16 + lane / 4;  // this thread's rows row0 and row0 + 8 of the tile
  const int n_rows = args.n_rows, n_cols = args.n_cols;
  const int r0 = blockIdx.x * 64, bh = blockIdx.y;
  const float scale = args.scale, c = scale * kLog2e;
  auto stage = [&](int pos) { return ring + (pos % NBUF) * T::ATOM; };
  auto parity = [&](int pos) { return (uint32_t)(pos / NBUF) & 1; };

  // K3: lse2 and dsum of this thread's rows (queries)
  float row_lse[2] = {0.f, 0.f}, row_dsum[2] = {0.f, 0.f};
  if constexpr (!BY_COL)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + row0 + 8 * r < n_rows) {
        row_lse[r] = args.lse[(size_t)bh * n_rows + r0 + row0 + 8 * r];
        row_dsum[r] = args.dsum[(size_t)bh * n_rows + r0 + row0 + 8 * r];
      }

  float acc[4][8][4];  // out[:, 256 wg + 64 a + 8 n ..] over the column loop
  float x[NS][4], y[NS][4];  // X, Y of this warpgroup's 32 columns of a tile
  // K4: lse2 and dsum of this thread's columns (queries) of a tile, read
  // from global memory as the tile starts, so that the loads land under its
  // products (the dv pass reads no dsum)
  float col_lse[BY_COL ? NS : 1][2], col_dsum[BY_COL && XY ? NS : 1][2];
  auto load_cols = [&](int j) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = j * kBC + 32 * wg + 8 * n + 2 * t + h;
        const bool ok = col < n_cols;
        const size_t at = (size_t)bh * n_cols + (ok ? col : 0);
        col_lse[n][h] = ok ? args.lse[at] : 0.f;
        if constexpr (XY) col_dsum[n][h] = ok ? args.dsum[at] : 0.f;
      }
  };
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.f;

  // d = A B^T over d = 512 for the tile's columns 32 wg..: A the resident
  // rows (atom a: their 64 columns of d from 64 a), B the atoms at stream
  // positions p..p + 7 (rows 32 wg.. of each), m64n32k16, 4 k steps an atom.
  // RELEASE: each atom's stage released once the group that reads it
  // retires; else kept for the output product. The descriptors step on from
  // a base the compiler cannot hoist out of the column loop.
  auto products = [&](float (&d)[NS][4], const uint8_t* As, int p, auto release) {
    const uint64_t da = sw128_desc(As) + opaque(0);
    reg_fence(d);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) {
      mbar_wait(full + (p + a) % NBUF, parity(p + a));
      const uint64_t db = sw128_desc(stage(p + a) + wg * 32 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(d, da + (a * T::ATOM + 32 * kk) / 16, db + 2 * kk, a > 0 || kk > 0);
      wgmma_commit();
      if constexpr (decltype(release)::value)
        if (a > 0) {
          wgmma_wait<1>();  // the group of atom a - 1 retired
          mbar_arrive(empty + (p + a - 1) % NBUF);
        }
    }
    wgmma_wait<0>();
    reg_fence(d);
    if constexpr (decltype(release)::value) mbar_arrive(empty + (p + 7) % NBUF);
  };
  // P = exp2(X c - lse2), 0 past the columns' end; E = P (Y - dsum) scale (the
  // dv pass: E = P), rounded to bf16 into this warpgroup's 32 columns of the
  // 64 x 64 E tile in the 128-byte swizzle (chunk k of row r at k ^ (r % 8))
  auto write_e = [&](int j, uint8_t* E) {
    const bool ragged = (j + 1) * kBC > n_cols;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int col = 32 * wg + 8 * n + 2 * t;  // the tile's column of e = 0, 2 (e = 1, 3: + 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float e[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float le = BY_COL ? col_lse[n][h] : row_lse[r];
          float p = ex2(fmaf(x[n][2 * r + h], c, -le));
          if (ragged && j * kBC + col + h >= n_cols) p = 0.f;
          if constexpr (XY)
            e[h] = p * (y[n][2 * r + h] - (BY_COL ? col_dsum[n][h] : row_dsum[r])) * scale;
          else
            e[h] = p;
        }
        const int row = row0 + 8 * r;
        *reinterpret_cast<uint32_t*>(E + row * 128 + (((4 * wg + n) ^ (row & 7)) << 4) + 4 * t) =
            pack_bf16(e[0], e[1]);
      }
    }
  };
  // acc[a] += E B[:, 256 wg + 64 a ..] for the atoms at stream positions p +
  // 4 wg + a, read MN-major through the transpose bit, m64n64k16 over the
  // tile's 64 columns, E K-major from shared memory; each atom released once
  // its group retires
  auto out_product = [&](const uint8_t* E, int p) {
    const int own = p + 4 * wg;
    const uint64_t de = sw128_desc(E) + opaque(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) reg_fence(acc[a]);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const uint64_t db = sw128_desc(stage(own + a));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_tb(acc[a], de + 2 * kk, db + 128 * kk, 1);
      wgmma_commit();
    }
    wgmma_wait<3>();
    mbar_arrive(empty + own % NBUF);
    wgmma_wait<2>();
    mbar_arrive(empty + (own + 1) % NBUF);
    wgmma_wait<1>();
    mbar_arrive(empty + (own + 2) % NBUF);
    wgmma_wait<0>();
    mbar_arrive(empty + (own + 3) % NBUF);
#pragma unroll
    for (int a = 0; a < 4; ++a) reg_fence(acc[a]);
  };

  for (int j = 0; j < ntile; ++j) {
    const int p = 16 * j;
    uint8_t* E = Es + (j % 2) * T::ATOM;
    if constexpr (BY_COL) load_cols(j);
    if constexpr (XY) {
      products(y, A2s, p, std::true_type{});
      mbar_wait(a1_full, 0);  // at once after the first tile
      products(x, A1s, p + 8, std::false_type{});
    } else {
      products(x, A1s, p, std::true_type{});
      // B2's atoms, which the output product alone reads, waited on in
      // stream order where the XY passes' X waits on B1's: every thread sees
      // every phase of every stage, and both passes synchronize alike
#pragma unroll
      for (int a = 0; a < 8; ++a) mbar_wait(full + (p + 8 + a) % NBUF, parity(p + 8 + a));
    }
    // the other warpgroup's half of the kept atoms, which this one reads in
    // X alone (the dv pass: not at all). The code is the same in both
    // warpgroups, only addresses differ: a branch by warpgroup around waits
    // made ptxas serialize every wgmma (advisory C7520)
#pragma unroll
    for (int a = 0; a < 4; ++a) mbar_arrive(empty + (p + 8 + 4 * (1 - wg) + a) % NBUF);
    // E of tile j into its own tile: the one of tile j - 2, which it
    // overwrites, was read by output products that retired before either
    // warpgroup reached tile j - 1's barrier
    write_e(j, E);
    fence_proxy_async();
    named_barrier_sync<1, T::CONSUMERS>();
    out_product(E, p + 8);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(PASS == kPassDv ? args.out2 : args.out1) +
                       (size_t)bh * n_rows * 512;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row0 + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * 512 + 256 * wg + 64 * a + 8 * n +
                                           2 * t) =
            __floats2bfloat162_rn(acc[a][n][2 * r], acc[a][n][2 * r + 1]);
  }
}

template <int NBUF, int PASS>
__global__ void __launch_bounds__(WgD512Bwd<NBUF>::THREADS, 1)
flash_attn_bwd_wgmma_d512_kernel(const __grid_constant__ CUtensorMap ta1,
                                 const __grid_constant__ CUtensorMap ta2,
                                 const __grid_constant__ CUtensorMap tb1,
                                 const __grid_constant__ CUtensorMap tb2, const Args args) {
  using T = WgD512Bwd<NBUF>;
  constexpr bool dv = PASS == kPassDv;  // no A2, no Y
  // K4's dv pass may start once every CTA of its dk pass has started
  if constexpr (PASS == kPassDk) griddep_launch_dependents();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* A1s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [8][64][128 B]
  uint8_t* A2s = A1s + T::ATOMS * T::ATOM;
  uint8_t* Es = A2s + T::ATOMS * T::ATOM;   // [2][64][128 B]
  uint8_t* ring = Es + 2 * T::ATOM;         // [NBUF][64][128 B]
  // the A of the first product (A2 for Y; the dv pass's A1), then the XY
  // passes' A1, which lands after the first tile's B2 atoms
  uint64_t* a_full = reinterpret_cast<uint64_t*>(ring + NBUF * T::ATOM);
  uint64_t* full = a_full + 2;
  uint64_t* empty = full + NBUF;
  const int ntile = (args.n_cols + kBC - 1) / kBC;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_full + 1, 1);
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, T::CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= T::CONSUMERS) {  // the producer warpgroup
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS) {
      const int r0 = blockIdx.x * 64, bh = blockIdx.y;
      auto load_a = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar) {
        mbar_expect_tx(bar, T::ATOMS * T::ATOM);
        for (int a = 0; a < T::ATOMS; ++a) tma_load_3d(dst + a * T::ATOM, map, bar, 64 * a, r0, bh);
      };
      if (dv) load_a(A1s, &ta1, a_full);
      else load_a(A2s, &ta2, a_full);
      for (int pos = 0; pos < 16 * ntile; ++pos) {
        const int s = pos % NBUF, j = pos / 16, a = pos % 16;
        if (!dv && pos == 8) load_a(A1s, &ta1, a_full + 1);
        if (pos >= NBUF) mbar_wait(empty + s, ((pos / NBUF) & 1) ^ 1);  // pos - NBUF released
        mbar_expect_tx(full + s, T::ATOM);
        tma_load_3d(ring + s * T::ATOM, (a < 8) == dv ? &tb1 : &tb2, full + s, 64 * (a % 8),
                    j * kBC, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<T::CONSUMER_REGS>();
  mbar_wait(a_full, 0);
  bwd_d512_consumer<NBUF, PASS>(args, A1s, A2s, Es, ring, a_full + 1, full, empty, ntile);
  // the dv pass ends after the dk pass it may have overlapped, so that the
  // stream's next work sees both outputs
  if constexpr (PASS == kPassDv) griddep_wait();
}

// PDL: launched programmatically, to start while the stream's previous
// kernel runs, once all its CTAs have started
template <int NBUF, int PASS>
cudaError_t launch_d512_pass(const CUtensorMap (&m)[4], const Args& a, int bh, bool pdl,
                             cudaStream_t stream) {
  using T = WgD512Bwd<NBUF>;
  auto kern = flash_attn_bwd_wgmma_d512_kernel<NBUF, PASS>;
  // the shared-memory limit set once a device (bit d of `done`): at the
  // ragged lengths a call's host time is its time, and K4 launches twice
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::BYTES);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_rows + 63) / 64, bh);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, m[0], m[1], m[2], m[3], a);
}

// tma_map_bhsd at d = 512, memoized a thread: a map is a pure function of
// its arguments (the base address, not the data), and at the ragged
// lengths a call's host time, four encodes and two launches, is its time
bool tma_map_d512(CUtensorMap* map, const void* base, int rows, int bh, int box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    int rows, bh, box_rows;
  };
  thread_local Entry cache[8] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.rows == rows && e.bh == bh && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  if (!tma_map_bhsd(map, base, 512, rows, bh, box_rows)) return false;
  cache[next] = Entry{*map, base, rows, bh, box_rows};
  next = (next + 1) % 8;
  return true;
}

// K3: A = (q, dout) rows of sq, B = (k, v) rows of sk; K4 the other way
// round, its dk and dv passes as two kernels: as one kernel that picked its
// pass by grid z, ptxas serialized every wgmma of both (advisory C7520), and
// without that a dv CTA's column atoms stopped landing. PDL: the dv pass
// starts once every dk CTA has started and fills the dk pass's last wave (at
// small shapes the two run side by side: one launch's latency).
template <int NBUF, bool PDL, bool DKV>
cudaError_t launch_wgmma_d512(const Args& a, int bh, cudaStream_t stream) {
  CUtensorMap m[4];  // A1, A2, B1, B2
  if (!(tma_map_d512(&m[0], a.a1, a.n_rows, bh, 64) &&
        tma_map_d512(&m[1], a.a2, a.n_rows, bh, 64) &&
        tma_map_d512(&m[2], a.b1, a.n_cols, bh, kBC) &&
        tma_map_d512(&m[3], a.b2, a.n_cols, bh, kBC)))
    return cudaErrorInvalidValue;
  if constexpr (!DKV) {
    return launch_d512_pass<NBUF, kPassDq>(m, a, bh, false, stream);
  } else {
    const cudaError_t err = launch_d512_pass<NBUF, kPassDk>(m, a, bh, false, stream);
    return err != cudaSuccess ? err : launch_d512_pass<NBUF, kPassDv>(m, a, bh, PDL, stream);
  }
}

template <bool DKV>
cudaError_t dispatch(const Args& a, int bh, int d, int dtype, cudaStream_t s) {
  if (bh <= 0 || a.n_rows <= 0 || a.n_cols <= 0) return cudaErrorInvalidValue;
  // f32: <D, PARTS, SPLITS, BC, NBUF, APRE> (the file header), K3 then K4
  if (dtype == 0 && d == 64)
    return DKV ? launch_f32<64, 4, 1, 32, 2, true, true>(a, bh, s)
               : launch_f32<64, 4, 1, 32, 2, false, false>(a, bh, s);
  if (dtype == 0 && d == 512)
    return DKV ? launch_f32<512, 1, 8, 16, 2, false, true>(a, bh, s)
               : launch_f32<512, 1, 8, 16, 2, false, false>(a, bh, s);
  // bf16 d = 64: <NWG, NBUF>, K3 then K4; d = 512: <NBUF, PDL>, K3 then K4
  if (dtype == 1 && d == 64)
    return DKV ? launch_wgmma<2, 4, true>(a, bh, s) : launch_wgmma<1, 4, false>(a, bh, s);
  if (dtype == 1 && d == 512)
    return DKV ? launch_wgmma_d512<10, true, true>(a, bh, s)
               : launch_wgmma_d512<10, true, false>(a, bh, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* flash_attn_bwd_f32_body() {
  return "split TF32: 3xTF32 mma.sync m16n8k8, cp.async column-tile ring";
}

extern "C" const char* flash_attn_bwd_bf16_body() {
  return "wgmma m64n64k16, TMA ring of 64-column tiles, producer warpgroup, per-tile sums";
}

extern "C" const char* flash_attn_bwd_bf16_d512_body() {
  return "wgmma m64n32k16 and m64n64k16, two consumer warpgroups, TMA ring of 64-column atoms, "
         "K4 as dk and dv passes";
}

// q, dout, dq: (bh, sq, d); k, v, dk, dv: (bh, sk, d); all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); lse, dsum: (bh, sq) float32.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* dsum,
                                 void* dq, int bh, int sq, int sk, int d, float scale,
                                 int dtype, void* stream) {
  const Args a{q, dout, k, v, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dq, nullptr, sq, sk, scale};
  return (int)dispatch<false>(a, bh, d, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* dsum,
                                  void* dk, void* dv, int bh, int sq, int sk, int d,
                                  float scale, int dtype, void* stream) {
  const Args a{k, v, q, dout, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dk, dv, sk, sq, scale};
  return (int)dispatch<true>(a, bh, d, dtype, static_cast<cudaStream_t>(stream));
}
