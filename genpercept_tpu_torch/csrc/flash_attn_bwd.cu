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
// its dk and dv accumulators. No atomics: results
// repeat bit for bit from run to run.
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
// the tensor cores through mma.sync. Every warp owns 16 rows and a 64-wide
// slice of d; at d=512 the eight slices of a row group each write partial X
// and Y to shared memory and every warp sums the eight in one fixed order,
// so all eight hold identical P and dS (the d split K1 uses against the
// 227 KB limit), and each accumulates its slice of the outputs.
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
//   - bf16 (flash_attn_bwd_mma_kernel): mma.sync m16n8k16, f32 accumulate,
//     as K1. E1 and E2 go from the accumulator layout straight into A
//     operands, rounded to bf16. At d=64 (4 warps x 16 rows) B1, B2 and K4's
//     lse2 and dsum of a 64-column tile arrive by cp.async through a ring of
//     NBUF tiles (K3 4, K4 2, by measurement), so the next tiles load while
//     this one's products run, one barrier a tile; the d=512 instantiation
//     (8 warps share 16 rows) loads each tile with every thread, two
//     barriers a tile (NBUF 1).
// wgmma, TMA and warp specialisation are later work.

#include "common.cuh"

namespace {

using namespace gp;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBC = 64;  // cols per tile of the bf16 body
constexpr int kDC = 64;  // the slice of d a warp owns

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
// bf16 body: RG row groups of 16 rows, D/64 slices of d, one warp per pair;
// NBUF 1: B tiles loaded in rows by every thread, two barriers a tile;
// NBUF >= 2: a cp.async ring of NBUF (B1, B2, lse2, dsum) tiles, filled
// NBUF - 1 tiles ahead, one barrier a tile (pack_bf16, load_rows and
// cp_async_rows are common.cuh's)

constexpr int kPartLD = kBC + 8;  // partial X / Y row stride (floats)

// 4 bytes global -> shared (.ca: the 16-byte form needs 16-byte runs); zero
// where !valid (src must still be a mapped address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

template <int D, int RG, int NBUF>
struct MmaTiling {
  static constexpr int SPLIT = D / kDC;
  static constexpr int THREADS = 32 * RG * SPLIT;
  static constexpr int BR = 16 * RG;
  static constexpr int LD = D + 8;
  static constexpr int TILE = 2 * kBC * LD;  // B1 and B2 of one column tile (bf16)
  static constexpr size_t B_BYTES = (size_t)NBUF * TILE * sizeof(__nv_bfloat16);
  static constexpr size_t PART_BYTES =
      SPLIT > 1 ? (size_t)2 * SPLIT * BR * kPartLD * sizeof(float) : 0;
  static constexpr size_t BYTES = B_BYTES + PART_BYTES + NBUF * 2 * kBC * sizeof(float);
  static_assert(BR <= kBC, "A rows are staged through a B buffer");
};

template <int D, int RG, int NBUF, bool DKV>
__global__ void __launch_bounds__(MmaTiling<D, RG, NBUF>::THREADS)
flash_attn_bwd_mma_kernel(Args args) {
  using L = MmaTiling<D, RG, NBUF>;
  constexpr int LD = L::LD;
  constexpr int KD = kDC / 16;  // k-steps of X and Y over this warp's slice
  constexpr int NS = kBC / 8;   // 8-col tiles of X and Y
  constexpr int NO = kDC / 8;   // 8-wide tiles of this warp's output slice
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);  // [NBUF][B1, B2]
  __nv_bfloat16* B1s = ring;
  __nv_bfloat16* B2s = B1s + kBC * LD;
  float* Xp = reinterpret_cast<float*>(ring + NBUF * L::TILE);  // [SPLIT][BR][kPartLD]
  float* Yp = Xp + L::SPLIT * L::BR * kPartLD;
  float* colv = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + L::B_BYTES +
                                         L::PART_BYTES);  // [NBUF][lse2, dsum][kBC]
  float* col_lse = colv;
  float* col_dsum = col_lse + kBC;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % RG, slice = warp / RG;
  const int g = lane / 4, qd = lane % 4;  // accumulator row g (and g+8), cols 2qd, 2qd+1
  const int mi = lane / 8, mr = lane % 8; // ldmatrix: matrix index, row in matrix
  const int d0 = slice * kDC;
  const int n_rows = args.n_rows, n_cols = args.n_cols;
  const int r0 = blockIdx.x * L::BR;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* a1 = static_cast<const __nv_bfloat16*>(args.a1) + bh * n_rows * D;
  const __nv_bfloat16* a2 = static_cast<const __nv_bfloat16*>(args.a2) + bh * n_rows * D;
  const __nv_bfloat16* b1 = static_cast<const __nv_bfloat16*>(args.b1) + bh * n_cols * D;
  const __nv_bfloat16* b2 = static_cast<const __nv_bfloat16*>(args.b2) + bh * n_cols * D;
  const size_t sq = DKV ? n_cols : n_rows;
  const float* lse = args.lse + bh * sq;
  const float* dsum = args.dsum + bh * sq;
  const float scale = args.scale;
  const float c = scale * kLog2e;
  const int ntile = (n_cols + kBC - 1) / kBC;

  // ring: one commit group per column tile, empty past the last, so that
  // "tile j has landed" is always cp.async.wait_group NBUF - 2 at tile j
  auto load_tile = [&](int j) {
    if (j < ntile) {
      __nv_bfloat16* dst = ring + (j % NBUF) * L::TILE;
      cp_async_rows<D, kBC, L::THREADS>(dst, b1, j * kBC, n_cols);
      cp_async_rows<D, kBC, L::THREADS>(dst + kBC * LD, b2, j * kBC, n_cols);
      if (DKV)
        for (int i = threadIdx.x; i < 2 * kBC; i += L::THREADS) {
          const int col = j * kBC + i % kBC;
          const bool ok = col < n_cols;
          cp_async4(colv + (j % NBUF) * 2 * kBC + i, (i < kBC ? lse : dsum) + (ok ? col : 0),
                    ok);
        }
    }
    cp_async_commit();
  };

  // A1, A2 fragments of this warp's rows and slice, staged through B1s, B2s
  load_rows<D, L::THREADS>(B1s, a1, r0, n_rows, L::BR);
  load_rows<D, L::THREADS>(B2s, a2, r0, n_rows, L::BR);
  __syncthreads();
  uint32_t a1f[KD][4], a2f[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int off = (rg * 16 + mr + 8 * (mi % 2)) * LD + d0 + kd * 16 + 8 * (mi / 2);
    ldsm_x4(B1s + off, a1f[kd]);
    ldsm_x4(B2s + off, a2f[kd]);
  }
  if constexpr (NBUF > 1) {
    __syncthreads();  // every warp has its A fragments before tile 0 lands there
#pragma unroll
    for (int j = 0; j < NBUF - 1; ++j) load_tile(j);
  }
  float row_lse[2] = {0.f, 0.f}, row_dsum[2] = {0.f, 0.f};
  if (!DKV)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + rg * 16 + g + 8 * h;
      if (row < n_rows) {
        row_lse[h] = lse[row];
        row_dsum[h] = dsum[row];
      }
    }

  float acc1[NO][4], acc2[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[n][j] = acc2[n][j] = 0.f;

  for (int jt = 0; jt < ntile; ++jt) {
    const int c0 = jt * kBC;
    if constexpr (NBUF > 1) {
      cp_async_wait<NBUF - 2>();
      __syncthreads();  // tile jt is visible; every warp is done with tile jt - 1
      load_tile(jt + NBUF - 1);
      B1s = ring + (jt % NBUF) * L::TILE;
      B2s = B1s + kBC * LD;
      col_lse = colv + (jt % NBUF) * 2 * kBC;
      col_dsum = col_lse + kBC;
    } else {
      __syncthreads();  // staging, or the previous tile's B, partial and col reads, are done
      load_rows<D, L::THREADS>(B1s, b1, c0, n_cols, kBC);
      load_rows<D, L::THREADS>(B2s, b2, c0, n_cols, kBC);
      if (DKV)
        for (int j = threadIdx.x; j < kBC; j += L::THREADS) {
          const bool ok = c0 + j < n_cols;
          col_lse[j] = ok ? lse[c0 + j] : 0.f;
          col_dsum[j] = ok ? dsum[c0 + j] : 0.f;
        }
      __syncthreads();
    }

    float x[NS][4], y[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[n][j] = y[n][j] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        const int off = (n * 8 + mr + 8 * (mi / 2)) * LD + d0 + kd * 16 + 8 * (mi % 2);
        uint32_t b[4];
        ldsm_x4(B1s + off, b);
        mma_bf16(x[n], a1f[kd], b[0], b[1]);
        mma_bf16(x[n + 1], a1f[kd], b[2], b[3]);
        ldsm_x4(B2s + off, b);
        mma_bf16(y[n], a2f[kd], b[0], b[1]);
        mma_bf16(y[n + 1], a2f[kd], b[2], b[3]);
      }
    if constexpr (L::SPLIT > 1) {
      // partial sums over d slices: publish, then sum all in a fixed order
      float* xm = Xp + (slice * L::BR + rg * 16) * kPartLD;
      float* ym = Yp + (slice * L::BR + rg * 16) * kPartLD;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (g + 8 * h) * kPartLD + n * 8 + 2 * qd;
          *reinterpret_cast<float2*>(xm + off) = make_float2(x[n][2 * h], x[n][2 * h + 1]);
          *reinterpret_cast<float2*>(ym + off) = make_float2(y[n][2 * h], y[n][2 * h + 1]);
        }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (rg * 16 + g + 8 * h) * kPartLD + n * 8 + 2 * qd;
          float2 sx = make_float2(0.f, 0.f), sy = sx;
#pragma unroll
          for (int s = 0; s < L::SPLIT; ++s) {
            const float2 px = *reinterpret_cast<const float2*>(Xp + s * L::BR * kPartLD + off);
            const float2 py = *reinterpret_cast<const float2*>(Yp + s * L::BR * kPartLD + off);
            sx.x += px.x; sx.y += px.y;
            sy.x += py.x; sy.y += py.y;
          }
          x[n][2 * h] = sx.x; x[n][2 * h + 1] = sx.y;
          y[n][2 * h] = sy.x; y[n][2 * h + 1] = sy.y;
        }
    }

    // P; E1 = P (Y - dsum) scale and E2 = P, rounded to bf16 as A operands
    uint32_t e1f[NS / 2][4], e2f[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float e1[4], e2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n * 8 + 2 * qd + (j & 1);
        const float l2 = DKV ? col_lse[col] : row_lse[j / 2];
        const float ds = DKV ? col_dsum[col] : row_dsum[j / 2];
        const float p = (c0 + col < n_cols) ? exp2f(x[n][j] * c - l2) : 0.f;
        e1[j] = p * (y[n][j] - ds) * scale;
        e2[j] = p;
      }
      e1f[n / 2][(n % 2) * 2 + 0] = pack_bf16(e1[0], e1[1]);
      e1f[n / 2][(n % 2) * 2 + 1] = pack_bf16(e1[2], e1[3]);
      if (DKV) {
        e2f[n / 2][(n % 2) * 2 + 0] = pack_bf16(e2[0], e2[1]);
        e2f[n / 2][(n % 2) * 2 + 1] = pack_bf16(e2[2], e2[3]);
      }
    }
#pragma unroll
    for (int jk = 0; jk < NS / 2; ++jk)
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        const int off = (jk * 16 + mr + 8 * (mi % 2)) * LD + d0 + n * 8 + 8 * (mi / 2);
        uint32_t b[4];
        ldsm_x4_trans(B1s + off, b);
        mma_bf16(acc1[n], e1f[jk], b[0], b[1]);
        mma_bf16(acc1[n + 1], e1f[jk], b[2], b[3]);
        if (DKV) {
          ldsm_x4_trans(B2s + off, b);
          mma_bf16(acc2[n], e2f[jk], b[0], b[1]);
          mma_bf16(acc2[n + 1], e2f[jk], b[2], b[3]);
        }
      }
  }

  __nv_bfloat16* out1 = static_cast<__nv_bfloat16*>(args.out1) + bh * n_rows * D;
  __nv_bfloat16* out2 =
      DKV ? static_cast<__nv_bfloat16*>(args.out2) + bh * n_rows * D : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rg * 16 + g + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const size_t off = (size_t)row * D + d0 + n * 8 + 2 * qd;
      *reinterpret_cast<__nv_bfloat162*>(out1 + off) =
          __floats2bfloat162_rn(acc1[n][2 * h], acc1[n][2 * h + 1]);
      if (DKV)
        *reinterpret_cast<__nv_bfloat162*>(out2 + off) =
            __floats2bfloat162_rn(acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

template <int D, int RG, int NBUF, bool DKV>
cudaError_t launch_mma(const Args& a, int bh, cudaStream_t stream) {
  using L = MmaTiling<D, RG, NBUF>;
  auto kern = flash_attn_bwd_mma_kernel<D, RG, NBUF, DKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n_rows + L::BR - 1) / L::BR, bh);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(a);
  return cudaGetLastError();
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
  // bf16: <D, RG, NBUF>
  if (dtype == 1 && d == 64)
    return DKV ? launch_mma<64, 4, 2, true>(a, bh, s) : launch_mma<64, 4, 4, false>(a, bh, s);
  if (dtype == 1 && d == 512) return launch_mma<512, 1, 1, DKV>(a, bh, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* flash_attn_bwd_f32_body() {
  return "split TF32: 3xTF32 mma.sync m16n8k8, cp.async column-tile ring";
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
