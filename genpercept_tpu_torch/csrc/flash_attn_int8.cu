// W8A8 flash attention (non-causal, one head of d = 512) for Hopper (sm_90a),
// f32 or bf16 out.
//
// Replaces the TPU kernel genpercept_tpu/ops/flash_attention.py::
// _flash_int8_kernel (reached through _flash_int8_bhsd). Inputs are int8 codes:
// q8, k8 with per-row f32 scales qs, ks and v8 (given transposed, (D, Sk),
// so that PV's B operand is k-contiguous) with per-column scales vs. Per k
// block of the TPU kernel's partition (k_blk keys; _blocks(sq, sk, d)[1]):
//   s     = s32(q8 . k8^T) * (qs * ks)          exact int32 sums, f32 logits
//   m_new = max(m, rowmax over the WHOLE block of s)
//   pq    = rint(exp2(s*c - m_new*c) * 127)      int8, c = scale * log2(e)
//   alpha = exp2((m - m_new) * c)
//   acc   = acc*alpha + f32(s32(pq . v8)),  l = l*alpha + sum(pq)
// and out = acc * vs / l. The same pq feeds PV and the row sum. pq is rounded
// against the running max at the end of a block, so the block partition is
// part of the function: the kernel takes the max over all k_blk logits of
// the block before it quantizes any p. Every f32 step is one rounded
// operation, as the plain version computes it.
//
// What bounds it on the card: two int8 products of 2*S*S*D operations per
// head; at the 768^2 path's (2, 9216, 512) that is 348 G operations, 176 us
// at 1,979 TOPS, against ~50 MB of codes and output (~15-20 us at 3.35
// TB/s): operations bound. The (S x S) logits never reach device memory.
//
// Design: one CTA (8 warps) per 16 query rows, int8 mma.sync m16n8k32. The
// Q codes stay in registers (each warp holds all 16 rows over d = 512). Per
// k block: (A) K streams through shared memory in 64-key tiles, each warp
// computing the logits of 8 keys into a (16, k_blk) f32 buffer in shared
// memory (96 KB at k_blk = 1536); (B) one warp per two rows takes the block's
// max, quantizes p into an int8 (16, k_blk) buffer and sums the codes;
// (C) V^T streams in 64-key tiles and each warp accumulates PV for its 64
// output columns in int32, folded into the f32 accumulator once per block.
// About 190 KB of shared memory: one CTA per SM. K and V are read once per
// 16 query rows, with no overlap of loads and products; wgmma, TMA and
// larger q tiles are later work.

#include "common.cuh"

namespace {

using namespace gp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;          // query rows per CTA
constexpr int kKT = 64;          // keys per K or V tile
constexpr int kD = 512;
constexpr int QLD = kD + 16;     // Q codes and K tile rows (bytes)
constexpr int VLD = kKT + 16;    // V^T tile rows, one per output column (bytes)
constexpr int kBuf = (kKT * QLD > kD * VLD) ? kKT * QLD : kD * VLD;
constexpr float kNegInf = -1e30f;
static_assert(kWarps * 8 == kKT, "one 8-key n-tile per warp in phase A");
static_assert(kWarps * 64 == kD, "64 output columns per warp in phase C");

struct Layout {
  int s_ld, p_ld;  // logits (floats) and pq (bytes) row strides
  int q, buf, s, p, m, l, alpha, bytes;
  __host__ __device__ explicit Layout(int k_blk) {
    s_ld = k_blk + 8;
    p_ld = k_blk + 16;
    q = 0;
    buf = q + kBQ * QLD;
    s = buf + kBuf;
    p = s + kBQ * s_ld * 4;
    m = p + kBQ * p_ld;
    l = m + kBQ * 4;
    alpha = l + kBQ * 4;
    bytes = alpha + kBQ * 4;
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void copy_rows(int8_t* dst, int dst_ld, const int8_t* src,
                                          size_t src_ld, int rows, int bytes, int valid) {
  const int vecs = bytes / 16;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int r = idx / vecs, v = (idx % vecs) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + v);
    *reinterpret_cast<uint4*>(dst + r * dst_ld + v) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ vt, const float* __restrict__ qs,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  T* __restrict__ out, int sq, int sk, int k_blk, float c) {
  const Layout L(k_blk);
  extern __shared__ float4 smem4[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem4);
  int8_t* Qs = smem + L.q;
  int8_t* Buf = smem + L.buf;
  float* S = reinterpret_cast<float*>(smem + L.s);
  int8_t* P = smem + L.p;
  float* M = reinterpret_cast<float*>(smem + L.m);
  float* Lsum = reinterpret_cast<float*>(smem + L.l);
  float* Alpha = reinterpret_cast<float*>(smem + L.alpha);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int8_t* kb = k8 + bh * sk * kD;
  const int8_t* vb = vt + bh * kD * sk;
  const float* ksb = ks + bh * sk;

  copy_rows(Qs, QLD, q8 + (bh * sq + q0) * kD, kD, kBQ, kD, sq - q0);
  if (threadIdx.x < kBQ) {
    M[threadIdx.x] = kNegInf;
    Lsum[threadIdx.x] = 0.f;
  }
  __syncthreads();
  uint32_t qf[kD / 32][4];
#pragma unroll
  for (int k = 0; k < kD / 32; ++k) load_a_s8(Qs, QLD, 0, 32 * k, lane, qf[k]);
  float qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + g + 8 * h;
    qrow[h] = r < sq ? qs[bh * sq + r] : 0.f;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb0 = 0; kb0 < sk; kb0 += k_blk) {
    // (A) logits of the block
    for (int k0 = kb0; k0 < kb0 + k_blk; k0 += kKT) {
      __syncthreads();  // the buffer's previous readers are done
      copy_rows(Buf, QLD, kb + (size_t)k0 * kD, kD, kKT, kD, kKT);
      __syncthreads();
      int sc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < kD / 32; ++k) {
        uint32_t b0, b1;
        load_b_s8(Buf, QLD, warp * 8, 32 * k, lane, b0, b1);
        mma_s8(sc, qf[k], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2), col = warp * 8 + 2 * t + (e & 1);
        S[row * L.s_ld + (k0 - kb0) + col] =
            __fmul_rn(static_cast<float>(sc[e]), __fmul_rn(qrow[e / 2], ksb[k0 + col]));
      }
    }
    __syncthreads();

    // (B) block max, pq, row sums: warp w takes rows 2w and 2w + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * warp + h;
      const float* srow = S + r * L.s_ld;
      float mx = kNegInf;
      for (int j = lane; j < k_blk; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = M[r];
      const float m_new = fmaxf(m_prev, mx);
      const float mc = __fmul_rn(m_new, c);
      int sum = 0;
      for (int j = lane; j < k_blk; j += 32) {
        const float p = exp2f(__fsub_rn(__fmul_rn(srow[j], c), mc));
        const int pq = static_cast<int>(rintf(__fmul_rn(p, 127.f)));
        P[r * L.p_ld + j] = static_cast<int8_t>(pq);
        sum += pq;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = exp2f(__fmul_rn(__fsub_rn(m_prev, m_new), c));
        Alpha[r] = alpha;
        M[r] = m_new;
        Lsum[r] = __fadd_rn(__fmul_rn(Lsum[r], alpha), static_cast<float>(sum));
      }
    }

    // (C) PV of the block, int32
    int pv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0;
    for (int k0 = kb0; k0 < kb0 + k_blk; k0 += kKT) {
      __syncthreads();  // pq written (first tile) or the previous V tile read
      copy_rows(Buf, VLD, vb + k0, sk, kD, kKT, kD);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 32) {
        uint32_t a[4];
        load_a_s8(P, L.p_ld, 0, (k0 - kb0) + kk, lane, a);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t b0, b1;
          load_b_s8(Buf, VLD, warp * 64 + n * 8, kk, lane, b0, b1);
          mma_s8(pv[n], a, b0, b1);
        }
      }
    }
    const float al[2] = {Alpha[g], Alpha[g + 8]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], al[e / 2]), static_cast<float>(pv[n][e]));
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2);
    if (q0 + row >= sq) continue;
    const float l = Lsum[row];
    T* orow = out + (bh * sq + q0 + row) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = warp * 64 + n * 8 + 2 * t + (e & 1);
      store(orow + col, __fdiv_rn(__fmul_rn(acc[n][e], vs[bh * kD + col]), l));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q8, const void* k8, const void* vt, const float* qs,
                   const float* ks, const float* vs, void* out, int bh, int sq, int sk,
                   int k_blk, float c, cudaStream_t stream) {
  const Layout L(k_blk);
  auto kern = flash_int8_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kern<<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(vt), qs, ks, vs, static_cast<T*>(out), sq, sk, k_blk, c);
  return cudaGetLastError();
}

}  // namespace

// q8: (bh, sq, d), k8: (bh, sk, d), vt: (bh, d, sk) int8; qs: (bh, sq), ks:
// (bh, sk), vs: (bh, d) float32; out: (bh, sq, d) of dtype 0 = float32 or
// 1 = bfloat16; all contiguous. d must be 512; k_blk divides sk and is a
// multiple of 64 (at most 1536: the logits buffer); c = scale * log2(e).
extern "C" int flash_attn_int8(const void* q8, const void* k8, const void* vt,
                               const void* qs, const void* ks, const void* vs, void* out,
                               int bh, int sq, int sk, int d, int k_blk, float c, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != kD || k_blk <= 0 || k_blk % kKT != 0 ||
      k_blk > 1536 || sk % k_blk != 0)
    return (int)cudaErrorInvalidValue;
  const float* fq = static_cast<const float*>(qs);
  const float* fk = static_cast<const float*>(ks);
  const float* fv = static_cast<const float*>(vs);
  if (dtype == 0) return (int)launch<float>(q8, k8, vt, fq, fk, fv, out, bh, sq, sk, k_blk, c, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q8, k8, vt, fq, fk, fv, out, bh, sq, sk, k_blk, c, s);
  return (int)cudaErrorInvalidValue;
}
