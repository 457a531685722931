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
// and both recompute P. Two kernels, as on the TPU, so that no sum crosses
// CTAs: K3's CTA owns a q tile and loops over k tiles, K4's owns a k tile and
// loops over q tiles holding its dk and dv accumulators. No atomics: results
// repeat bit for bit from run to run.
//
// One body serves both kernels. A CTA owns a tile of "rows" and loops over
// tiles of 64 "cols":
//   K3: rows = queries, cols = keys;    A1 = Q, A2 = dO, B1 = K, B2 = V
//   K4: rows = keys,    cols = queries; A1 = K, A2 = V,  B1 = Q, B2 = dO
// X = A1 B1^T is S (K3) or S^T (K4), Y = A2 B2^T is dP or dP^T; lse2 and dsum
// belong to the query, the row's in K3 and the column's in K4; then
//   E1 = P (Y - dsum) scale,  out1 += E1 B1     (dq += dS K;  dk += dS^T Q)
//   E2 = P,                   out2 += E2 B2     (K4 only: dv += P^T dO)
// Rows past their length load zeros and are not stored; columns past theirs
// get P = 0, so ragged lengths need no padding.
//
// Bodies, for SD2.1's head dims 64 (UNet) and 512 (VAE mid block):
//   - f32: FFMA from shared memory (TF32 stays off: the 1e-4 contract).
//     A1^T and A2^T stay resident; B tiles stream in 64-wide d chunks, once
//     transposed for X and Y and once in rows for the output products, so the
//     d=512 tile needs 128 KB of shared memory, not the 2 x 128 KB of whole
//     K and V tiles. Rows per CTA: 64 at d=64, 16 at d=512 (the accumulators
//     are 2 x 16 x 512 f32 = 64 KB, spread over the registers of 256 threads).
//   - bf16: mma.sync m16n8k16, f32 accumulate, as K1. Every warp owns 16 rows
//     and a 64-wide slice of d: 4 warps x 16 rows at d=64; at d=512, 8 warps
//     share 16 rows, one slice each, write partial X and Y to shared memory
//     and sum the eight in a fixed order, so all eight hold identical P and
//     dS (the d split K1 uses against the 227 KB limit). E1 and E2 go from
//     the accumulator layout straight into A operands, rounded to bf16.
// wgmma, TMA and load/compute overlap are later work.

#include "common.cuh"

namespace {

using namespace gp;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBC = 64;  // cols per tile
constexpr int kDC = 64;  // d chunk (f32) and d slice per warp (bf16)

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

// ---------------------------------------------------------------------------
// f32 body

constexpr int kF32Threads = 256;

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

template <int D, int BR>
struct F32Tiling {
  static constexpr int TR = BR * kBC / (kF32Threads * 4);  // rows per thread; 4 cols each
  static constexpr int NCH = D / kDC;
  static constexpr int A_LD = BR + 4;   // A1^T, A2^T: [D][A_LD]
  static constexpr int B_LD = kBC + 4;  // a B chunk: [kDC][B_LD] transposed or [kBC][B_LD] rows
  static constexpr int E_LD = BR + 4;   // E1^T, E2^T: [kBC][E_LD]
  static constexpr int A1_OFF = 0;
  static constexpr int A2_OFF = A1_OFF + D * A_LD;
  static constexpr int B1_OFF = A2_OFF + D * A_LD;
  static constexpr int B2_OFF = B1_OFF + kDC * B_LD;
  static constexpr int E1_OFF = B2_OFF + kDC * B_LD;
  static constexpr int E2_OFF = E1_OFF + kBC * E_LD;
  static constexpr int RV_OFF = E2_OFF + kBC * E_LD;  // row lse2, dsum: [2][BR]
  static constexpr int CV_OFF = RV_OFF + 2 * BR;      // col lse2, dsum: [2][kBC]
  static constexpr int FLOATS = CV_OFF + 2 * kBC;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(kDC == kBC, "one B buffer holds a chunk either way");
  static_assert((BR / TR) * (kBC / 4) == kF32Threads, "tiling must use every thread");
  static_assert(TR == 1 || TR == 4, "rows per thread");
};

template <int TR>
__device__ __forceinline__ void load_col(const float* p, float (&v)[TR]) {
  if constexpr (TR == 4) {
    const float4 x = load4(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = p[0];
  }
}

template <int D, int BR, bool DKV>
__global__ void __launch_bounds__(kF32Threads) flash_attn_bwd_f32_kernel(Args args) {
  using L = F32Tiling<D, BR>;
  constexpr int TR = L::TR;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* A1t = smem + L::A1_OFF;
  float* A2t = smem + L::A2_OFF;
  float* B1 = smem + L::B1_OFF;
  float* B2 = smem + L::B2_OFF;
  float* E1t = smem + L::E1_OFF;
  float* E2t = smem + L::E2_OFF;
  float* row_lse = smem + L::RV_OFF;
  float* row_dsum = row_lse + BR;
  float* col_lse = smem + L::CV_OFF;
  float* col_dsum = col_lse + kBC;

  const int t = threadIdx.x;
  const int n_rows = args.n_rows, n_cols = args.n_cols;
  const int r0 = blockIdx.x * BR;
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

  // resident A1^T, A2^T, zeros past n_rows
  for (int idx = t; idx < BR * (D / 4); idx += kF32Threads) {
    const int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
    float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f), x2 = x1;
    if (r0 + r < n_rows) {
      x1 = load4(a1 + (size_t)(r0 + r) * D + d4);
      x2 = load4(a2 + (size_t)(r0 + r) * D + d4);
    }
    A1t[(d4 + 0) * L::A_LD + r] = x1.x; A2t[(d4 + 0) * L::A_LD + r] = x2.x;
    A1t[(d4 + 1) * L::A_LD + r] = x1.y; A2t[(d4 + 1) * L::A_LD + r] = x2.y;
    A1t[(d4 + 2) * L::A_LD + r] = x1.z; A2t[(d4 + 2) * L::A_LD + r] = x2.z;
    A1t[(d4 + 3) * L::A_LD + r] = x1.w; A2t[(d4 + 3) * L::A_LD + r] = x2.w;
  }
  if (!DKV)
    for (int r = t; r < BR; r += kF32Threads) {
      const bool ok = r0 + r < n_rows;
      row_lse[r] = ok ? lse[r0 + r] : 0.f;
      row_dsum[r] = ok ? dsum[r0 + r] : 0.f;
    }

  const int ty = t / (kBC / 4), tx = t % (kBC / 4);  // rows ty*TR.., cols tx*4..
  float acc1[L::NCH][TR][4], acc2[L::NCH][TR][4];
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc1[ch][i][j] = acc2[ch][i][j] = 0.f;

  for (int c0 = 0; c0 < n_cols; c0 += kBC) {
    if (DKV)
      for (int j = t; j < kBC; j += kF32Threads) {
        const bool ok = c0 + j < n_cols;
        col_lse[j] = ok ? lse[c0 + j] : 0.f;
        col_dsum[j] = ok ? dsum[c0 + j] : 0.f;
      }

    // X = A1 B1^T and Y = A2 B2^T over d chunks of B^T
    float x[TR][4], y[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // earlier readers of B1, B2 (and E, col vectors) are done
      for (int idx = t; idx < kBC * (kDC / 4); idx += kF32Threads) {
        const int j = idx / (kDC / 4), d4 = (idx % (kDC / 4)) * 4;
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f), w = u;
        if (c0 + j < n_cols) {
          u = load4(b1 + (size_t)(c0 + j) * D + d0 + d4);
          w = load4(b2 + (size_t)(c0 + j) * D + d0 + d4);
        }
        B1[(d4 + 0) * L::B_LD + j] = u.x; B2[(d4 + 0) * L::B_LD + j] = w.x;
        B1[(d4 + 1) * L::B_LD + j] = u.y; B2[(d4 + 1) * L::B_LD + j] = w.y;
        B1[(d4 + 2) * L::B_LD + j] = u.z; B2[(d4 + 2) * L::B_LD + j] = w.z;
        B1[(d4 + 3) * L::B_LD + j] = u.w; B2[(d4 + 3) * L::B_LD + j] = w.w;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kDC; ++dd) {
        float av[TR], vv[TR];
        load_col<TR>(A1t + (d0 + dd) * L::A_LD + ty * TR, av);
        load_col<TR>(A2t + (d0 + dd) * L::A_LD + ty * TR, vv);
        const float4 bu = load4(B1 + dd * L::B_LD + tx * 4);
        const float4 bw = load4(B2 + dd * L::B_LD + tx * 4);
        const float bun[4] = {bu.x, bu.y, bu.z, bu.w}, bwn[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[i][j] = fmaf(av[i], bun[j], x[i][j]);
            y[i][j] = fmaf(vv[i], bwn[j], y[i][j]);
          }
      }
    }

    // P, E1 = P (Y - dsum) scale and E2 = P, transposed into shared memory
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * TR + i, col = tx * 4 + j;
        const float l2 = DKV ? col_lse[col] : row_lse[row];
        const float ds = DKV ? col_dsum[col] : row_dsum[row];
        const float p = (c0 + col < n_cols) ? exp2f(x[i][j] * c - l2) : 0.f;
        E1t[col * L::E_LD + row] = p * (y[i][j] - ds) * scale;
        if (DKV) E2t[col * L::E_LD + row] = p;
      }

    // out1 += E1 B1 (and out2 += E2 B2) over d chunks of B in rows
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch) {
      __syncthreads();  // E written; the previous chunk's B reads are done
      for (int idx = t; idx < kBC * (kDC / 4); idx += kF32Threads) {
        const int j = idx / (kDC / 4), d4 = (idx % (kDC / 4)) * 4;
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f), w = u;
        if (c0 + j < n_cols) {
          u = load4(b1 + (size_t)(c0 + j) * D + ch * kDC + d4);
          if (DKV) w = load4(b2 + (size_t)(c0 + j) * D + ch * kDC + d4);
        }
        *reinterpret_cast<float4*>(B1 + j * L::B_LD + d4) = u;
        if (DKV) *reinterpret_cast<float4*>(B2 + j * L::B_LD + d4) = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kBC; ++jj) {
        float e1[TR], e2[TR];
        load_col<TR>(E1t + jj * L::E_LD + ty * TR, e1);
        const float4 bu = load4(B1 + jj * L::B_LD + tx * 4);
        const float bun[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[ch][i][j] = fmaf(e1[i], bun[j], acc1[ch][i][j]);
        if (DKV) {
          load_col<TR>(E2t + jj * L::E_LD + ty * TR, e2);
          const float4 bw = load4(B2 + jj * L::B_LD + tx * 4);
          const float bwn[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc2[ch][i][j] = fmaf(e2[i], bwn[j], acc2[ch][i][j]);
        }
      }
    }
  }

  float* out1 = static_cast<float*>(args.out1) + bh * n_rows * D;
  float* out2 = DKV ? static_cast<float*>(args.out2) + bh * n_rows * D : nullptr;
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = r0 + ty * TR + i;
      if (row >= n_rows) continue;
      const size_t off = (size_t)row * D + ch * kDC + tx * 4;
      *reinterpret_cast<float4*>(out1 + off) =
          make_float4(acc1[ch][i][0], acc1[ch][i][1], acc1[ch][i][2], acc1[ch][i][3]);
      if (DKV)
        *reinterpret_cast<float4*>(out2 + off) =
            make_float4(acc2[ch][i][0], acc2[ch][i][1], acc2[ch][i][2], acc2[ch][i][3]);
    }
}

template <int D, int BR, bool DKV>
cudaError_t launch_f32(const Args& a, int bh, cudaStream_t stream) {
  using L = F32Tiling<D, BR>;
  auto kern = flash_attn_bwd_f32_kernel<D, BR, DKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n_rows + BR - 1) / BR, bh);
  kern<<<grid, kF32Threads, L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: RG row groups of 16 rows, D/64 slices of d, one warp per pair
// (pack_bf16 and load_rows are common.cuh's)

constexpr int kPartLD = kBC + 8;  // partial X / Y row stride (floats)

template <int D, int RG>
struct MmaTiling {
  static constexpr int SPLIT = D / kDC;
  static constexpr int THREADS = 32 * RG * SPLIT;
  static constexpr int BR = 16 * RG;
  static constexpr int LD = D + 8;
  static constexpr size_t B_BYTES = (size_t)2 * kBC * LD * sizeof(__nv_bfloat16);
  static constexpr size_t PART_BYTES =
      SPLIT > 1 ? (size_t)2 * SPLIT * BR * kPartLD * sizeof(float) : 0;
  static constexpr size_t BYTES = B_BYTES + PART_BYTES + 2 * kBC * sizeof(float);
  static_assert(BR <= kBC, "A rows are staged through a B buffer");
};

template <int D, int RG, bool DKV>
__global__ void __launch_bounds__(MmaTiling<D, RG>::THREADS)
flash_attn_bwd_mma_kernel(Args args) {
  using L = MmaTiling<D, RG>;
  constexpr int LD = L::LD;
  constexpr int KD = kDC / 16;  // k-steps of X and Y over this warp's slice
  constexpr int NS = kBC / 8;   // 8-col tiles of X and Y
  constexpr int NO = kDC / 8;   // 8-wide tiles of this warp's output slice
  extern __shared__ float4 smem4[];
  __nv_bfloat16* B1s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* B2s = B1s + kBC * LD;
  float* Xp = reinterpret_cast<float*>(B2s + kBC * LD);  // [SPLIT][BR][kPartLD]
  float* Yp = Xp + L::SPLIT * L::BR * kPartLD;
  float* col_lse = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + L::B_BYTES +
                                            L::PART_BYTES);
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

  for (int c0 = 0; c0 < n_cols; c0 += kBC) {
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

template <int D, int RG, bool DKV>
cudaError_t launch_mma(const Args& a, int bh, cudaStream_t stream) {
  using L = MmaTiling<D, RG>;
  auto kern = flash_attn_bwd_mma_kernel<D, RG, DKV>;
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
  if (dtype == 0 && d == 64) return launch_f32<64, 64, DKV>(a, bh, s);
  if (dtype == 0 && d == 512) return launch_f32<512, 16, DKV>(a, bh, s);
  if (dtype == 1 && d == 64) return launch_mma<64, 4, DKV>(a, bh, s);
  if (dtype == 1 && d == 512) return launch_mma<512, 1, DKV>(a, bh, s);
  return cudaErrorInvalidValue;
}

}  // namespace

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
