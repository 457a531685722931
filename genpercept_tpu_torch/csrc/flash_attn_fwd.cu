// Non-causal flash-attention forward for Hopper (sm_90a), f32 or bf16 in.
//
// Replaces the TPU kernel genpercept_tpu/ops/flash_attention.py::_flash_kernel
// (reached through _flash_bhsd). It computes the same function:
//   s  = q . k^T                      raw logits, f32 accumulate
//   m  = running row max of s         (kept on RAW logits)
//   p  = exp2(s*c - m*c), c = scale*log2(e), ROUNDED to v's dtype
//   l  = running sum of the ROUNDED p (the sum that feeds PV)
//   o  = (sum p.v) / l,  lse2 = m*c + log2(l)   (base-2, scaled units)
// with the online-softmax rescale alpha = exp2((m_prev - m_new)*c) applied to
// the accumulator and to l when a k tile raises the max.
//
// What bounds it on the card: the (Sq x Sk) logits never touch device memory,
// so the kernel is bound by arithmetic on the two matrix products (d=64 at
// 9216 tokens is ~108 GFLOP per image and head group) and, at d=512, by the
// shared memory that one K or V tile needs. Head dims are those of SD2.1:
// 64 (the UNet's heads) and 512 (the VAE mid block). Three bodies, one
// contract:
//   - f32 (the pipeline default): FFMA from shared memory, below. It keeps
//     f32 products exact, as the TPU's f32 path does.
//   - bf16, d = 64: mma.sync tensor cores, f32 accumulate
//     (flash_attn_fwd_mma_kernel).
//   - bf16, d = 512: mma.sync with d split over warps
//     (flash_attn_fwd_split_kernel).
// wgmma, TMA and load/compute overlap are later work.
//
// Design: one CTA per (q tile, batch*head). On the TPU the k blocks were a
// sequential "arbitrary" grid axis carrying m, l and the accumulator in VMEM;
// here nothing carries across CTAs, so the CTA loops over k tiles itself.
// The FFMA body keeps m, l in shared memory and the output accumulator in
// registers, and runs three phases per k tile separated by barriers:
//   1. S = Q K^T into shared memory (d split over KS thread groups at large d);
//   2. one warp per row: max, exp2, round, row sum, alpha;
//   3. acc = acc*alpha + P V with V in the buffer that held K^T.
// At d=512 a 64-row f32 accumulator alone would be 128 KB, so the q tile is
// 16 rows and the d reduction of S is split four ways; the 16-row Q^T, one
// 64-row K^T or V tile and the partial S fit in 202 KB of shared memory.
// Rows past Sq are computed on zeros and not stored; columns past Sk get the
// -1e30 logit, so ragged lengths need no padding.

#include "common.cuh"

namespace {

using namespace gp;

constexpr int kThreads = 256;
constexpr int kBK = 64;            // keys per tile
constexpr float kNegInf = -1e30f;  // same sentinel as the TPU kernel

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

template <int D, int BQ>
struct Tiling {
  static constexpr int TX = kBK / 4;                 // S: 4 key columns each
  static constexpr int TY = BQ / 4;                  // S: 4 query rows each
  static constexpr int KS = kThreads / (TX * TY);    // d split of Q K^T
  static constexpr int DK = D / KS;
  static constexpr int OTY = BQ / 4;                 // O: 4 rows each
  static constexpr int OTX = kThreads / OTY;
  static constexpr int CO4 = D / (4 * OTX);          // O: float4 groups each
  static constexpr int QT_LD = BQ + 4;               // padded strides (floats)
  static constexpr int KT_LD = kBK + 4;
  static constexpr int P_LD = BQ + 4;
  // shared memory layout, in floats
  static constexpr int QT_OFF = 0;
  static constexpr int BUF_OFF = QT_OFF + D * QT_LD;
  static constexpr int S_OFF = BUF_OFF + D * KT_LD;  // >= kBK*D for V
  static constexpr int P_OFF = S_OFF + KS * BQ * kBK;
  static constexpr int M_OFF = P_OFF + kBK * P_LD;
  static constexpr int L_OFF = M_OFF + BQ;
  static constexpr int A_OFF = L_OFF + BQ;
  static constexpr int FLOATS = A_OFF + BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(TX * TY * KS == kThreads, "S tiling must use every thread");
  static_assert(OTY * OTX == kThreads && CO4 * 4 * OTX == D, "O tiling");
  static_assert(BQ % 8 == 0, "row pass: whole rows per warp");
};

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk, float scale) {
  using L = Tiling<D, BQ>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem + L::QT_OFF;   // [D][QT_LD]   Q^T
  float* buf = smem + L::BUF_OFF; // [D][KT_LD] K^T, then [kBK][D] V
  float* S = smem + L::S_OFF;     // [KS][BQ][kBK] partial logits
  float* P = smem + L::P_OFF;     // [kBK][P_LD] rounded p, transposed
  float* M = smem + L::M_OFF;     // [BQ] running max (raw logits)
  float* Lsum = smem + L::L_OFF;  // [BQ] running sum of rounded p
  float* Alpha = smem + L::A_OFF; // [BQ] this tile's rescale

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const float c = scale * 1.4426950408889634f;

  // Q^T tile, zeros past Sq
  for (int idx = t; idx < BQ * (D / 4); idx += kThreads) {
    int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) x = load4(qb + (size_t)(q0 + r) * D + d4);
    Qt[(d4 + 0) * L::QT_LD + r] = x.x;
    Qt[(d4 + 1) * L::QT_LD + r] = x.y;
    Qt[(d4 + 2) * L::QT_LD + r] = x.z;
    Qt[(d4 + 3) * L::QT_LD + r] = x.w;
  }
  for (int r = t; r < BQ; r += kThreads) {
    M[r] = kNegInf;
    Lsum[r] = 0.f;
  }

  // thread roles
  const int ks = t / (L::TX * L::TY);
  const int sr = t % (L::TX * L::TY);
  const int ty = sr / L::TX, tx = sr % L::TX;
  const int oty = t / L::OTX, otx = t % L::OTX;
  const int warp = t / 32, lane = t % 32;

  float acc[4][L::CO4 * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < L::CO4 * 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();  // previous tile's V and P reads are done
    // phase 0: K^T tile, zeros past Sk
    for (int idx = t; idx < kBK * (D / 4); idx += kThreads) {
      int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < sk) x = load4(kb + (size_t)(k0 + r) * D + d4);
      buf[(d4 + 0) * L::KT_LD + r] = x.x;
      buf[(d4 + 1) * L::KT_LD + r] = x.y;
      buf[(d4 + 2) * L::KT_LD + r] = x.z;
      buf[(d4 + 3) * L::KT_LD + r] = x.w;
    }
    __syncthreads();

    // phase 1: partial S over this thread group's slice of d
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const int d_lo = ks * L::DK;
#pragma unroll 4
      for (int d = d_lo; d < d_lo + L::DK; ++d) {
        float4 a = *reinterpret_cast<const float4*>(Qt + d * L::QT_LD + ty * 4);
        float4 b = *reinterpret_cast<const float4*>(buf + d * L::KT_LD + tx * 4);
        float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
      float* Sk = S + ks * BQ * kBK;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(Sk + (ty * 4 + i) * kBK + tx * 4) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // phase 2: online softmax, one warp per row; V load overlaps nothing yet
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float sv[kBK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        int col = lane + 32 * j;
        float x = 0.f;
#pragma unroll
        for (int g = 0; g < L::KS; ++g) x += S[(g * BQ + r) * kBK + col];
        if (k0 + col >= sk) x = kNegInf;
        sv[j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = M[r];
      const float m_new = fmaxf(m_prev, mx);
      const float mc = m_new * c;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const float p = exp2f(sv[j] * c - mc);  // rounding to f32: exact
        P[(lane + 32 * j) * L::P_LD + r] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = exp2f((m_prev - m_new) * c);
        Alpha[r] = alpha;
        M[r] = m_new;
        Lsum[r] = Lsum[r] * alpha + sum;
      }
    }
    // V tile into the K^T buffer (K^T reads ended at the barrier above)
    for (int idx = t; idx < kBK * (D / 4); idx += kThreads) {
      int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < sk) x = load4(vb + (size_t)(k0 + r) * D + d4);
      *reinterpret_cast<float4*>(buf + r * D + d4) = x;
    }
    __syncthreads();

    // phase 3: acc = acc*alpha + P V
    {
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = Alpha[oty * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < L::CO4 * 4; ++j) acc[i][j] *= al[i];
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float4 a = *reinterpret_cast<const float4*>(P + kk * L::P_LD + oty * 4);
        float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int g = 0; g < L::CO4; ++g) {
          float4 b = *reinterpret_cast<const float4*>(buf + kk * D + (g * L::OTX + otx) * 4);
          float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][g * 4 + j] = fmaf(av[i], bv[j], acc[i][g * 4 + j]);
        }
      }
    }
  }
  __syncthreads();

  // finish: o = acc / l, lse2 = m*c + log2(l)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = oty * 4 + i;
    if (q0 + r >= sq) continue;
    const float l = Lsum[r];
    float* orow = out + (bh * sq + q0 + r) * D;
#pragma unroll
    for (int g = 0; g < L::CO4; ++g) {
      const int col = (g * L::OTX + otx) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) orow[col + j] = acc[i][g * 4 + j] / l;
    }
  }
  for (int r = t; r < BQ; r += kThreads)
    if (q0 + r < sq) lse[bh * sq + q0 + r] = M[r] * c + log2f(Lsum[r]);
}

template <int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int sq, int sk, float scale,
                   cudaStream_t stream) {
  using L = Tiling<D, BQ>;
  auto kern = flash_attn_fwd_kernel<D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at d = 64: the same function on tensor cores (mma.sync m16n8k16,
// f32 accumulate). Four warps each own 16 query rows of a 64-row tile; K and
// V tiles of 64 keys sit in shared memory with rows padded by 16 bytes, so
// ldmatrix meets no bank conflicts. S, the rounded P and the output
// accumulator stay in registers: the m16n8 accumulator layout of two
// adjacent S tiles is the A-operand layout of PV, so P never touches shared
// memory. m is kept per row; each thread keeps a partial l over its columns
// and the four threads of a row sum them at the end.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;
constexpr int kMmaBK = 64;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0+rows) of a (n, D) bf16 matrix into a [rows][D+8] tile,
// zeros past n
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n, int rows) {
  constexpr int LD = D + 8;
  for (int idx = threadIdx.x; idx < rows * (D / 8); idx += kMmaThreads) {
    const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c8);
    *reinterpret_cast<uint4*>(dst + r * LD + c8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                          int sq, int sk, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int NS = kMmaBK / 8;   // 8-key column tiles of S
  constexpr int NO = D / 8;        // 8-wide column tiles of O
  static_assert(NS % 2 == 0 && NO % 2 == 0, "tiles are loaded in pairs");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + kMmaBQ * LD;
  __nv_bfloat16* Vs = Ks + kMmaBK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;  // accumulator row g (and g+8), cols 2qd, 2qd+1
  const int mi = lane / 8, mr = lane % 8; // ldmatrix: matrix index, row in matrix
  const int q0 = blockIdx.x * kMmaBQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const float c = scale * 1.4426950408889634f;

  load_rows<D>(Qs, qb, q0, sq, kMmaBQ);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(Qs + (warp * 16 + mr + 8 * (mi % 2)) * LD + kd * 16 + 8 * (mi / 2), qf[kd]);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += kMmaBK) {
    __syncthreads();  // the previous tile's K and V reads are done
    load_rows<D>(Ks, kb, k0, sk, kMmaBK);
    load_rows<D>(Vs, vb, k0, sk, kMmaBK);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t b[4];
        ldsm_x4(Ks + (n * 8 + mr + 8 * (mi / 2)) * LD + kd * 16 + 8 * (mi % 2), b);
        mma_bf16(s[n], qf[kd], b[0], b[1]);
        mma_bf16(s[n + 1], qf[kd], b[2], b[3]);
      }
    if (k0 + kMmaBK > sk) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + n * 8 + 2 * qd + (j & 1) >= sk) s[n][j] = kNegInf;
    }

    // online softmax on raw logits; rows g (j = 0, 1) and g + 8 (j = 2, 3)
    float tm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      tm[0] = fmaxf(tm[0], fmaxf(s[n][0], s[n][1]));
      tm[1] = fmaxf(tm[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
      const float m_new = fmaxf(m[r], tm[r]);
      alpha[r] = exp2f((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = m_new * c;
    }
    uint32_t pf[NS / 2][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = round_bf16(exp2f(s[n][j] * c - mc[j / 2]));
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NS / 2; ++j)
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(Vs + (j * 16 + mr + 8 * (mi % 2)) * LD + n * 8 + 8 * (mi / 2), b);
        mma_bf16(o[n], pf[j], b[0], b[1]);
        mma_bf16(o[n + 1], pf[j], b[2], b[3]);
      }
  }

  // finish: the row's four threads sum their partial l; o = acc / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + (bh * sq + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (qd == 0) lse[bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int bh, int sq, int sk, float scale,
                       cudaStream_t stream) {
  constexpr size_t bytes = (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8) * sizeof(__nv_bfloat16);
  auto kern = flash_attn_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kMmaBQ - 1) / kMmaBQ, bh);
  kern<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
      sq, sk, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at d = 512 (the VAE mid block): tensor cores with d split
// four ways. A 16-row accumulator over all of d=512 would need 256 f32
// registers a thread, so each of 8 warps owns one 16-row half of a 32-row q
// tile and one quarter of d: its Q fragments (32 registers at d=512) and its
// (16, d/4) output accumulator (64) stay in registers. Per 64-key tile the
// warps write partial S over their quarter of d to shared memory, and every
// warp then sums the four quarters in the same order, so the four warps of
// a row half hold identical S, m, l and rounded P, and run PV on their own
// quarter of V's columns.

constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitBQ = 32;
constexpr int kSplitSLD = kMmaBK + 8;  // partial-S row stride (floats)

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
flash_attn_fwd_split_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                            int sq, int sk, float scale) {
  constexpr int LD = D + 8;
  constexpr int DQ = D / 4;        // this warp's quarter of d
  constexpr int KD = DQ / 16;      // k-steps of its partial Q K^T
  constexpr int NS = kMmaBK / 8;
  constexpr int NO = DQ / 8;
  static_assert(NO % 2 == 0, "tiles are loaded in pairs");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + kMmaBK * LD;
  float* Sp = reinterpret_cast<float*>(Vs + kMmaBK * LD);  // [4][kSplitBQ][kSplitSLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp % 2, quarter = warp / 2;
  const int g = lane / 4, qd = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int q0 = blockIdx.x * kSplitBQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const float c = scale * 1.4426950408889634f;
  const int d0 = quarter * DQ;

  // Q tile staged through the K buffer
  for (int idx = threadIdx.x; idx < kSplitBQ * (D / 8); idx += kSplitThreads) {
    const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c8);
    *reinterpret_cast<uint4*>(Ks + r * LD + c8) = val;
  }
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(Ks + (half * 16 + mr + 8 * (mi % 2)) * LD + d0 + kd * 16 + 8 * (mi / 2), qf[kd]);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += kMmaBK) {
    __syncthreads();  // Q staging, or the previous tile's K, V and S reads, are done
    for (int idx = threadIdx.x; idx < kMmaBK * (D / 8); idx += kSplitThreads) {
      const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c8);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + c8) = vv;
    }
    __syncthreads();

    {  // partial S over this warp's quarter of d
      float sp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) sp[n][0] = sp[n][1] = sp[n][2] = sp[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t b[4];
          ldsm_x4(Ks + (n * 8 + mr + 8 * (mi / 2)) * LD + d0 + kd * 16 + 8 * (mi % 2), b);
          mma_bf16(sp[n], qf[kd], b[0], b[1]);
          mma_bf16(sp[n + 1], qf[kd], b[2], b[3]);
        }
      float* mine = Sp + (quarter * kSplitBQ + half * 16) * kSplitSLD;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        *reinterpret_cast<float2*>(mine + g * kSplitSLD + n * 8 + 2 * qd) =
            make_float2(sp[n][0], sp[n][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * kSplitSLD + n * 8 + 2 * qd) =
            make_float2(sp[n][2], sp[n][3]);
      }
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int row = half * 16 + g + 8 * (j / 2), col = n * 8 + 2 * qd;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {  // fixed order: identical in every warp
          const float2 part = *reinterpret_cast<const float2*>(
              Sp + (qq * kSplitBQ + row) * kSplitSLD + col);
          acc.x += part.x;
          acc.y += part.y;
        }
        s[n][j] = (k0 + col < sk) ? acc.x : kNegInf;
        s[n][j + 1] = (k0 + col + 1 < sk) ? acc.y : kNegInf;
      }

    float tm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      tm[0] = fmaxf(tm[0], fmaxf(s[n][0], s[n][1]));
      tm[1] = fmaxf(tm[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
      const float m_new = fmaxf(m[r], tm[r]);
      alpha[r] = exp2f((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = m_new * c;
    }
    uint32_t pf[NS / 2][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = round_bf16(exp2f(s[n][j] * c - mc[j / 2]));
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NS / 2; ++j)
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(Vs + (j * 16 + mr + 8 * (mi % 2)) * LD + d0 + n * 8 + 8 * (mi / 2), b);
        mma_bf16(o[n], pf[j], b[0], b[1]);
        mma_bf16(o[n + 1], pf[j], b[2], b[3]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + half * 16 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + (bh * sq + row) * D + d0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (quarter == 0 && qd == 0) lse[bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out,
                         float* lse, int bh, int sq, int sk, float scale,
                         cudaStream_t stream) {
  constexpr size_t bytes = (size_t)2 * kMmaBK * (D + 8) * sizeof(__nv_bfloat16) +
                           (size_t)4 * kSplitBQ * kSplitSLD * sizeof(float);
  static_assert((size_t)kSplitBQ * (D + 8) <= (size_t)kMmaBK * (D + 8), "Q staging fits");
  auto kern = flash_attn_fwd_split_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kSplitBQ - 1) / kSplitBQ, bh);
  kern<<<grid, kSplitThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
      sq, sk, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out,
                         float* lse, int bh, int sq, int sk, int d, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 64:  return launch<64, 64>(q, k, v, out, lse, bh, sq, sk, scale, stream);
    case 512: return launch<512, 16>(q, k, v, out, lse, bh, sq, sk, scale, stream);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, sq, d), k/v: (bh, sk, d), out: (bh, sq, d), all contiguous and of
// one dtype (0 = float32, 1 = bfloat16); lse: (bh, sq) float32.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int sq, int sk,
                              int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_f32(q, k, v, out, l, bh, sq, sk, d, scale, s);
  if (dtype == 1 && d == 64) return (int)launch_mma<64>(q, k, v, out, l, bh, sq, sk, scale, s);
  if (dtype == 1 && d == 512) return (int)launch_split<512>(q, k, v, out, l, bh, sq, sk, scale, s);
  return (int)cudaErrorInvalidValue;
}
