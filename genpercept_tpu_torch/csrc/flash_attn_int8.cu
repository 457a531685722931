// W8A8 flash attention (non-causal; d = 512, the VAE mid block's one head, or
// d = 64, the UNet's heads) for Hopper (sm_90a), f32 or bf16 out.
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
// At d = 64 (the profiling script's UNet shapes) the per-logit softmax and
// quantize work outweighs the two 64-deep products.
//
// Two bodies. d = 512, every call of the pipeline: flash_int8_wgmma_kernel
// (int8 wgmma fed by TMA, a max pass per k block; its design note is below).
// d = 64, only the profiling script: flash_int8_kernel, one CTA (8 warps) per
// 16 query rows on int8 mma.sync m16n8k32. Its Q codes stay in registers
// (each warp holds all 16 rows over d). Per k block: (A) K streams through
// shared memory in 64-key tiles, each warp computing the logits of 8 keys
// into a (16, k_blk) f32 buffer in shared memory (148 KB at k_blk = 2304);
// (B) one warp per two rows takes the block's max, quantizes p into an int8
// (16, k_blk) buffer and sums the codes; (C) V^T streams in 64-key tiles and
// each warp accumulates PV for its 8-column n-tile in int32, folded into the
// f32 accumulator once per block. K and V are read once per 16 query rows,
// with no overlap of loads and products.

#include <type_traits>

#include "common.cuh"

namespace {

using namespace gp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;          // query rows per CTA
constexpr int kKT = 64;          // keys per K or V tile
constexpr int VLD = kKT + 16;    // V^T tile rows, one per output column (bytes)
constexpr int kMaxSmem = 232448; // shared memory a block may use on Hopper
constexpr float kNegInf = -1e30f;
static_assert(kWarps * 8 == kKT, "one 8-key n-tile per warp in phase A");

template <int D>
struct Layout {
  static constexpr int QLD = D + 16;  // Q codes and K tile rows (bytes)
  static constexpr int BUF = (kKT * QLD > D * VLD) ? kKT * QLD : D * VLD;
  static_assert(D % (kWarps * 8) == 0, "whole 8-column n-tiles per warp in phase C");
  int s_ld, p_ld;  // logits (floats) and pq (bytes) row strides
  int q, buf, s, p, m, l, alpha, bytes;
  __host__ __device__ explicit Layout(int k_blk) {
    s_ld = k_blk + 8;
    p_ld = k_blk + 16;
    q = 0;
    buf = q + kBQ * QLD;
    s = buf + BUF;
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ vt, const float* __restrict__ qs,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  T* __restrict__ out, int sq, int sk, int k_blk, float c) {
  using LT = Layout<D>;
  constexpr int QLD = LT::QLD;
  constexpr int NW = D / kWarps / 8;  // phase C n-tiles per warp
  const LT L(k_blk);
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
  const int8_t* kb = k8 + bh * sk * D;
  const int8_t* vb = vt + bh * D * sk;
  const float* ksb = ks + bh * sk;

  copy_rows(Qs, QLD, q8 + (bh * sq + q0) * D, D, kBQ, D, sq - q0);
  if (threadIdx.x < kBQ) {
    M[threadIdx.x] = kNegInf;
    Lsum[threadIdx.x] = 0.f;
  }
  __syncthreads();
  uint32_t qf[D / 32][4];
#pragma unroll
  for (int k = 0; k < D / 32; ++k) load_a_s8(Qs, QLD, 0, 32 * k, lane, qf[k]);
  float qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + g + 8 * h;
    qrow[h] = r < sq ? qs[bh * sq + r] : 0.f;
  }

  float acc[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb0 = 0; kb0 < sk; kb0 += k_blk) {
    // (A) logits of the block
    for (int k0 = kb0; k0 < kb0 + k_blk; k0 += kKT) {
      __syncthreads();  // the buffer's previous readers are done
      copy_rows(Buf, QLD, kb + (size_t)k0 * D, D, kKT, D, kKT);
      __syncthreads();
      int sc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < D / 32; ++k) {
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
    int pv[NW][4];
#pragma unroll
    for (int n = 0; n < NW; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0;
    for (int k0 = kb0; k0 < kb0 + k_blk; k0 += kKT) {
      __syncthreads();  // pq written (first tile) or the previous V tile read
      copy_rows(Buf, VLD, vb + k0, sk, D, kKT, D);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 32) {
        uint32_t a[4];
        load_a_s8(P, L.p_ld, 0, (k0 - kb0) + kk, lane, a);
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          uint32_t b0, b1;
          load_b_s8(Buf, VLD, (warp * NW + n) * 8, kk, lane, b0, b1);
          mma_s8(pv[n], a, b0, b1);
        }
      }
    }
    const float al[2] = {Alpha[g], Alpha[g + 8]};
#pragma unroll
    for (int n = 0; n < NW; ++n)
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
    T* orow = out + (bh * sq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int col = (warp * NW + n) * 8 + 2 * t + (e & 1);
      store(orow + col, __fdiv_rn(__fmul_rn(acc[n][e], vs[bh * D + col]), l));
    }
  }
}

// ---------------------------------------------------------------------------
// d = 512 on int8 wgmma. Three things the function asks of the design:
//   - The max of a whole k block before any pq of it. A 64-row tile's
//     logits of a block (1536 keys) are 384 KB of f32: neither registers nor
//     shared memory hold them, and a key split would start from its own
//     running max. So each k block runs Q K^T twice: a max pass that keeps
//     only the row maxima, then a pass that recomputes the int32 logits (the
//     same bits: exact sums, the same f32 steps), forms pq against the
//     block's max and feeds P V: 1.5x the function's products, at (2, 9216,
//     512) 521.8 G int8 operations, a floor of 0.264 ms at 1,979 TOPS
//     against the function's 0.176.
//   - Two accumulators. P V sums a whole block in int32 (a block's |pv|
//     passes 2^24, so folding into f32 tile by tile is another function) and
//     the f32 running output takes acc * alpha + f32(pv) once a block. A
//     64-row tile over all of d = 512 is 32 K registers for either: half the
//     register file each. The int32 sums stay in registers (two consumer
//     warpgroups of 256 output columns: 128 registers a thread); the f32
//     output is parked in device memory between folds (the output itself
//     when it is f32, else an f32 scratch of bh * sq * 512 that the wrapper
//     allocates; none at one block). A block's fold runs at the start of the
//     next block, before its max pass: the parked values come back through
//     the ring as TMA boxes (16 KB a group of 32 columns of each half), so
//     no thread waits on a load from device memory, and the new ones are
//     stored by the threads that own them. The first fold is f32(pv) as it
//     stands (0 * alpha + f32(pv) in the plain version: the same bits); the
//     last writes acc * vs / l to the output. Parked in shared memory the
//     output would take 128 KB; read by the threads from device memory at
//     each fold it cost ~0.2 ms a call (loads waiting behind the ring's).
//   - Operand majors. 8-bit wgmma reads both operands K-major: Q and K as
//     they stand (rows of d), P as the consumers write it (rows of keys),
//     and V as V^T (D, Sk), which the wrapper builds, in rows of keys.
// The CTA: 64 query rows, two consumer warpgroups and a producer warpgroup
// (setmaxnreg 24 / 240). S is split by keys: warpgroup w computes the
// logits of keys 64 w.. of a 128-key tile, m64n64k32 x 16 k steps over d,
// A = Q (4 atoms of 64 rows x 128 bytes, loaded once) and B = the tile's K
// atoms (rows 64 w.. of each); a block whose k_blk is an odd multiple of 64
// ends on a 64-key tile that the warpgroups split 32 and 32 (m64n32k32, and
// P V in 2 k steps). P V is split by output columns: warpgroup w runs
// pv += P V^T[256 w.., keys]^T as m64n256k32, 4 k steps a tile, A = P and
// B = its 256 rows of V^T. The warpgroups exchange through shared memory:
// their row maxima once a block (both then take m_new in one order: the
// same bits), pq as int8 into a 64 x 128 P tile in the 128-byte swizzle
// (two buffers: one barrier a tile), and their row sums of pq once a block.
// The ring: 8 stages of 16 KB in stream order, which the two CTAs of a
// cluster (two q tiles of one head) share: each K / V^T stage is loaded once
// from L2 by one of them and multicast into both. Per k block, the parked
// values of the block before (8 stages, from the third block on), the 4 K
// atoms (128 keys x 128 bytes of d) of each tile for the max pass, then per
// tile its 4 K atoms and its 4 V^T units (128 rows of d x 128 keys),
// warpgroup w reading units 2 w and 2 w + 1, which lie on consecutive
// stages (positions and the stage count are even), one 32 KB operand. A
// tile's ks (512 bytes) rides with its last K atom into a side buffer of the
// stage. One producer thread a CTA issues the TMA copies of a stage (keys
// past Sk and rows past Sq arrive as zeros) once every consumer warp of the
// cluster has released it. A warpgroup releases K atoms as the group that
// reads them retires (the last once it has read the ks), its V^T units with
// the first group of the next tile's S (groups retire in order), and waits
// on the other warpgroup's units and releases them after issuing its P V (a
// parity wait tells only two phases apart, so no thread skips one).
// What was measured (scripts/tune_k6.py, PERF.md): at (2, 9216, 512) the
// ring's loads alone take ~0.6 ms and the products add little on top
// (without the max pass's or P V's products the time moves by < 5%); the
// softmax costs ~0.13 ms where it does not overlap them; the 2-CTA
// multicast gains 3-5% over a CTA loading its own (4 CTAs: less). Not kept:
// 10 stages (slower than 8), the max pass a whole tile a warpgroup over
// pairs of tiles (m64n128k32: spilled, no faster), the fold under the next
// block's max pass by loads from device memory (spilled), waits for each K
// atom inside S's chain (ptxas serialized every wgmma of the kernel, C7520).

namespace w8 {

constexpr int D = 512;
constexpr int BQ = 64;           // query rows of a CTA
constexpr int BK = 128;          // keys of a key tile
constexpr int UNIT = 128 * 128;  // bytes of a ring stage: a K atom or a V^T unit
constexpr int NBUF = 8;          // ring stages
constexpr int CLUSTER = 2;       // CTAs (q tiles) of a cluster sharing each K / V^T load
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int QATOM = BQ * 128;  // bytes of a Q atom: 64 rows x 128 codes of d
constexpr int PB = BQ * BK;      // bytes of a P buffer
constexpr int KSB = BK * 4;      // bytes of a tile's ks, beside its last K atom
constexpr int OFF_P = 4 * QATOM;
constexpr int OFF_RING = OFF_P + 2 * PB;
constexpr int OFF_KS = OFF_RING + NBUF * UNIT;  // [NBUF][128] f32: ks by stage
constexpr int OFF_RED = OFF_KS + NBUF * KSB;    // row maxima [2][64] f32, row sums [2][64] s32
constexpr int OFF_BAR = OFF_RED + 4 * BQ * 4;   // Q, full, empty
constexpr int BYTES = 1024 + OFF_BAR + 8 * (1 + 2 * NBUF);
// setmaxnreg: the registers the launch gives (65536 / 384 rounded down to 8)
// moved from the producer to the consumers; an inc past what the dec freed
// would hang
constexpr int REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// A block's fold of the parked output runs at the start of the next block,
// in groups of 4 of a thread's 32 column tiles (both its rows): 64 rows x 32
// columns of each warpgroup's half, 16 KB of f32, which the ring brings as
// one stage (a box of 32 columns x 64 rows a warpgroup)
constexpr int FOLD_GROUP = 4;
constexpr int NGROUP = 32 / FOLD_GROUP;
static_assert(2 * BQ * 8 * FOLD_GROUP * 4 == UNIT, "a fold group's parked values are one stage");
static_assert(NBUF % 2 == 0, "a warpgroup's two V^T units on consecutive stages");
// a tile's S waits for its 4 K atoms before it releases the tile before's
// V^T units: the ring must hold both tiles' 8 units (6 stages hung)
static_assert(NBUF >= 8, "K atoms of a tile beside the V^T units of the tile before");
static_assert(BYTES <= kMaxSmem, "shared memory of a CTA");
static_assert(CLUSTER >= 1 && CLUSTER <= 4, "a cluster's CTAs");
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * REGS, "setmaxnreg");

struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  float* ks;  // [NBUF][128]
  __device__ __forceinline__ uint8_t* stage(int pos) const { return base + (pos % NBUF) * UNIT; }
  // the ks of the tile whose last K atom is at pos
  __device__ __forceinline__ const float* tile_ks(int pos) const { return ks + (pos % NBUF) * BK; }
  __device__ __forceinline__ void wait(int pos) const {
    mbar_wait(full + pos % NBUF, (uint32_t)(pos / NBUF) & 1);
  }
  // a warp's release of the stage at pos, once every lane has read it, in
  // every CTA of the cluster (their producers refill it in all at once)
  __device__ __forceinline__ void release(int pos) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty + pos % NBUF, r);
  }
};

// S (64 x 8 NS, int32) = Q K^T over the K atoms at ring positions pos..pos + 3:
// rows koff / 128.. of each atom, 8 NS keys of the tile. S is zeroed first, so
// that its registers live from here only. All four atoms are waited for
// before the chain of 16 wgmma, which holds no wait loop (ptxas serialized
// every wgmma of the kernel, C7520, while the chain waited for each atom in
// turn). Atoms 0-2 are released as the groups reading them retire; atom 3's
// stage also holds the tile's ks, which the caller reads after the products
// and then releases. With REL also this warpgroup's V^T units of the tile
// before (vrel, vrel + 1), whose P V group retires before the first of these.
template <int NS, bool REL>
__device__ __forceinline__ void qk_tile(int (&s)[NS][4], const uint8_t* Qs, const Ring& ring,
                                        int pos, int koff, int vrel) {
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) ring.wait(pos + a);
  const uint64_t dq = sw128_desc(Qs) + opaque(0);
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const uint64_t dk = sw128_desc(ring.stage(pos + a) + koff);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8(s, dq + (a * QATOM + 32 * kk) / 16, dk + 2 * kk, a > 0 || kk > 0);
    wgmma_commit();
    if (a > 0) {
      wgmma_wait<1>();  // the group of atom a - 1 retired, and all before it
      ring.release(pos + a - 1);
      if (REL && a == 1) {
        ring.release(vrel);
        ring.release(vrel + 1);
      }
    }
  }
  wgmma_wait<0>();
  reg_fence(s);
}

// the logit s = f32(s32) * (qs * ks), two products rounded apart
__device__ __forceinline__ float logit(int s32, float qsr, float ksv) {
  return __fmul_rn(static_cast<float>(s32), __fmul_rn(qsr, ksv));
}

// this thread's keys' scales of a tile: column 8 n + 2 t at ks + 8 n + 2 t
template <int NS>
__device__ __forceinline__ void load_ks(float2 (&kv)[NS], const float* ks, int t) {
#pragma unroll
  for (int n = 0; n < NS; ++n) kv[n] = *reinterpret_cast<const float2*>(ks + 8 * n + 2 * t);
}

// the row maxima of this thread's logits of S (64 x 8 NS) into bm
template <int NS>
__device__ __forceinline__ void row_max(float (&bm)[2], const int (&s)[NS][4],
                                        const float2 (&kv)[NS], const float (&qsr)[2]) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bm[r] = fmaxf(bm[r], fmaxf(logit(s[n][2 * r], qsr[r], kv[n].x),
                                 logit(s[n][2 * r + 1], qsr[r], kv[n].y)));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the parked values of column tile n of a fold group at (row, 8 n + 2 t),
// from a warpgroup's box of 64 rows x 32 f32 in the 128-byte swizzle
__device__ __forceinline__ float2 parked_value(const uint8_t* box, int row, int n, int t) {
  return *reinterpret_cast<const float2*>(box + row * 128 + (((2 * n + t / 2) ^ (row & 7)) << 4) +
                                          8 * (t & 1));
}

// out and park alias where the output is f32 (no __restrict__)
template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tks,
                        const __grid_constant__ CUtensorMap tpark, const float* __restrict__ qs,
                        const float* __restrict__ vs, T* out, float* park, int sq, int sk,
                        int k_blk, float c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [4][64][128 B]
  uint8_t* Ps = Qs + OFF_P;                                                  // [2][64][128 B]
  float* red_max = reinterpret_cast<float*>(Qs + OFF_RED);                   // [2][64]
  int* red_sum = reinterpret_cast<int*>(red_max + 2 * BQ);                   // [2][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Qs + OFF_BAR);
  const Ring ring{Qs + OFF_RING, q_full + 1, q_full + 1 + NBUF,
                  reinterpret_cast<float*>(Qs + OFF_KS)};

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int ntile = (k_blk + BK - 1) / BK, nblk = sk / k_blk;
  const bool half_tile = k_blk % BK != 0;  // each block ends on a 64-key tile

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, CONSUMERS / 32 * CLUSTER);  // every consumer warp of the cluster
    }
    fence_mbarrier_init();
  }
  cluster_sync();  // every CTA's barriers set before any CTA reaches another's

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, 4 * QATOM);
      for (int a = 0; a < 4; ++a) tma_load_3d(Qs + a * QATOM, &tq, q_full, 128 * a, q0, bh);
      // The cluster's CTAs (q tiles of one head) take the same K / V^T
      // stream: position p is loaded once, by the CTA of rank p % CLUSTER,
      // into every CTA's stage (multicast), once every consumer warp of the
      // cluster has released it. Each producer counts the stage's bytes on
      // its own full barrier. The parked values are each CTA's own.
      const uint32_t rank = cluster_rank();
      const uint16_t all = (uint16_t)((1u << CLUSTER) - 1);
      int pos = 0;
      // one stage: its unit and, with a tile's last K atom, the tile's ks
      auto put = [&](const CUtensorMap* map, int c0, int c1, int ks0) {
        const int s = pos % NBUF;
        if (pos >= NBUF) mbar_wait(ring.empty + s, ((uint32_t)(pos / NBUF) & 1) ^ 1);
        mbar_expect_tx(ring.full + s, UNIT + (ks0 >= 0 ? KSB : 0));
        if (pos % CLUSTER == (int)rank) {
          tma_load_3d_mc(ring.base + s * UNIT, map, ring.full + s, c0, c1, bh, all);
          if (ks0 >= 0) tma_load_1d_mc(ring.ks + s * BK, &tks, ring.full + s, ks0, all);
        }
        ++pos;
      };
      // a fold group's parked values: columns 32 g.. of each warpgroup's
      // half, a box each
      auto put_park = [&](int g) {
        const int s = pos % NBUF;
        if (pos >= NBUF) mbar_wait(ring.empty + s, ((uint32_t)(pos / NBUF) & 1) ^ 1);
        mbar_expect_tx(ring.full + s, UNIT);
        for (int w = 0; w < 2; ++w)
          tma_load_3d(ring.base + s * UNIT + w * (UNIT / 2), &tpark, ring.full + s,
                      256 * w + 8 * FOLD_GROUP * g, q0, bh);
        ++pos;
      };
      for (int b = 0; b < nblk; ++b) {
        // block b starts with the fold of block b - 1's sums onto the
        // parked output of block b - 2
        if (b >= 2)
          for (int g = 0; g < NGROUP; ++g) put_park(g);
        for (int pass = 0; pass < 2; ++pass)
          for (int i = 0; i < ntile; ++i) {
            const int key0 = b * k_blk + i * BK;
            for (int a = 0; a < 4; ++a) put(&tk, 128 * a, key0, a == 3 ? bh * sk + key0 : -1);
            if (pass == 1)
              for (int u = 0; u < 4; ++u) put(&tv, key0, 128 * u, -1);
          }
      }
      if (nblk >= 2)  // the output's fold, onto the parked output of the block before
        for (int g = 0; g < NGROUP; ++g) put_park(g);
      // the last releases: no consumer of the cluster arrives on this CTA's
      // barriers, and no load writes into it, once this thread leaves
      for (int q = pos < NBUF ? NBUF : pos; q < pos + NBUF; ++q)
        mbar_wait(ring.empty + q % NBUF, ((uint32_t)(q / NBUF) & 1) ^ 1);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;                 // columns 2t, 2t + 1 of each 8-column tile
  const int row0 = warp * 16 + lane / 4;  // this thread's rows row0 and row0 + 8 of the tile
  float qsr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    qsr[r] = row < sq ? qs[(size_t)bh * sq + row] : 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int s[8][4], pv[32][4];  // S of a tile (its first 4 column tiles on a 64-key one); P V
  int pos = 0, ptile = 0;  // ring position; pass-2 tiles so far (P buffer)

  // this thread's two rows of the parked output and of out: the offset of
  // its first column (256 wg + 2 t), and whether the row lies before Sq
  // (rows past it are folded on nothing: their stores skipped)
  bool ok[2];
  size_t at[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    ok[r] = row < sq;
    at[r] = ((size_t)bh * sq + (ok[r] ? row : 0)) * D + 256 * wg + 2 * t;
  }
  float fold_alpha[2] = {0.f, 0.f};  // alpha of the block whose fold is pending

  // the max pass over one tile, split between the warpgroups as S is in the
  // second pass: this warpgroup's keys' row maxima into bm
  auto max_tile = [&](auto ns, float (&bm)[2]) {
    constexpr int NS = decltype(ns)::value;
    auto& sn = reinterpret_cast<int(&)[NS][4]>(s);
    qk_tile<NS, false>(sn, Qs, ring, pos, wg * 8 * NS * 128, 0);
    float2 kv[NS];
    load_ks(kv, ring.tile_ks(pos + 3) + wg * 8 * NS, t);
    ring.release(pos + 3);
    row_max(bm, sn, kv, qsr);
    pos += 4;
  };

  // the second pass over one tile: the logits again, pq into P, the row sums
  // of pq, then P V issued (it retires under the next tile's S). P V's sums
  // are zeroed before a block's first tile, so that they live from there.
  auto pv_tile = [&](auto ns, auto rel, const float (&mc)[2], int (&rs)[2], bool first) {
    constexpr int NS = decltype(ns)::value;
    auto& sn = reinterpret_cast<int(&)[NS][4]>(s);
    qk_tile<NS, decltype(rel)::value>(sn, Qs, ring, pos, wg * 8 * NS * 128, pos - 4 + 2 * wg);
    float2 kv[NS];
    load_ks(kv, ring.tile_ks(pos + 3) + wg * 8 * NS, t);
    ring.release(pos + 3);  // the last K atom and the tile's ks
    uint8_t* Pb = Ps + (ptile & 1) * PB;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int pq[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float sv = logit(sn[n][2 * r + j], qsr[r], j ? kv[n].y : kv[n].x);
          const float p = exp2f(__fsub_rn(__fmul_rn(sv, c), mc[r]));
          pq[j] = __float2int_rn(__fmul_rn(p, 127.f));
        }
        rs[r] += pq[0] + pq[1];
        const int row = row0 + 8 * r, key = wg * 8 * NS + 8 * n + 2 * t;
        *reinterpret_cast<uint16_t*>(Pb + row * 128 + (((key >> 4) ^ (row & 7)) << 4) +
                                     (key & 15)) = (uint16_t)((pq[0] & 0xFF) | (pq[1] << 8));
      }
    }
    fence_proxy_async();
    named_barrier_sync<1, CONSUMERS>();  // P whole; the buffer's last readers retired

    // the tile's V^T units v0..v0 + 3, warpgroup w's at v0 + 2 w: every
    // thread waits on its own two, issues P V, then waits on the other
    // warpgroup's and releases them (no branch by warpgroup around the chain)
    const int v0 = pos + 4, own = v0 + 2 * wg, other = v0 + 2 - 2 * wg;
    ring.wait(own);
    ring.wait(own + 1);
    const uint64_t dp = sw128_desc(Pb) + opaque(0);
    const uint64_t dv = sw128_desc(ring.stage(own));
    if (first) {
#pragma unroll
      for (int n = 0; n < 32; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0;
    }
    reg_fence(pv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) wgmma_s8(pv, dp + 2 * kk, dv + 2 * kk, 1);
    wgmma_commit();
    ring.wait(other);
    ring.wait(other + 1);
    ring.release(other);
    ring.release(other + 1);
    pos += 8;
    ++ptile;
  };

  using Full = std::integral_constant<int, 8>;
  using Half = std::integral_constant<int, 4>;
  using Rel = std::true_type;
  using NoRel = std::false_type;
  mbar_wait(q_full, 0);
  for (int b = 0; b < nblk; ++b) {
    const int nfull = k_blk / BK;
    // The fold of the block before, acc = park * alpha + f32(pv), parked,
    // group by group; the parked values read through the ring from the
    // second fold on (at the first, f32(pv) alone: 0 * alpha + f32(pv) in
    // the plain version, the same bits). Then the max pass: this
    // warpgroup's row maxima over its keys of the block.
    if (b >= 1) {
      const bool parked = b >= 2;
#pragma unroll
      for (int g = 0; g < NGROUP; ++g) {
        const uint8_t* box = ring.stage(pos) + wg * (UNIT / 2);
        if (parked) ring.wait(pos);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n = 0; n < FOLD_GROUP; ++n) {
            const int tn = g * FOLD_GROUP + n;
            float2 o = make_float2(static_cast<float>(pv[tn][2 * r]),
                                   static_cast<float>(pv[tn][2 * r + 1]));
            if (parked) {
              const float2 a = parked_value(box, row0 + 8 * r, n, t);
              o = make_float2(__fadd_rn(__fmul_rn(a.x, fold_alpha[r]), o.x),
                              __fadd_rn(__fmul_rn(a.y, fold_alpha[r]), o.y));
            }
            if (ok[r]) store2(park + at[r] + 8 * tn, o.x, o.y);
          }
        if (parked) {
          ring.release(pos);
          ++pos;
        }
      }
      fence_proxy_async_global();  // the parked output, stored, before TMA reads it
    }
    float bm[2] = {kNegInf, kNegInf};
    for (int i = 0; i < nfull; ++i) max_tile(Full{}, bm);
    if (half_tile) max_tile(Half{}, bm);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
      bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
      if (t == 0) red_max[wg * BQ + row0 + 8 * r] = bm[r];
    }
    named_barrier_sync<1, CONSUMERS>();
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // one order in both warpgroups: the same bits
      const float m_new =
          fmaxf(m[r], fmaxf(red_max[row0 + 8 * r], red_max[BQ + row0 + 8 * r]));
      alpha[r] = exp2f(__fmul_rn(__fsub_rn(m[r], m_new), c));
      m[r] = m_new;
      mc[r] = __fmul_rn(m_new, c);
    }

    // the second pass: pq, P V in int32 over the block, the row sums
    int rs[2] = {0, 0};
    for (int i = 0; i < nfull; ++i) {
      if (i == 0)
        pv_tile(Full{}, NoRel{}, mc, rs, true);
      else
        pv_tile(Full{}, Rel{}, mc, rs, false);
    }
    if (half_tile) {
      if (nfull == 0)
        pv_tile(Half{}, NoRel{}, mc, rs, true);
      else
        pv_tile(Half{}, Rel{}, mc, rs, false);
    }
    wgmma_wait<0>();
    reg_fence(pv);
    ring.release(pos - 4 + 2 * wg);  // this warpgroup's V^T units of the block's last tile
    ring.release(pos - 3 + 2 * wg);

    // l over both halves' row sums (exact ints), then the fold
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      if (t == 0) red_sum[wg * BQ + row0 + 8 * r] = rs[r];
    }
    named_barrier_sync<1, CONSUMERS>();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]),
                       static_cast<float>(red_sum[row0 + 8 * r] + red_sum[BQ + row0 + 8 * r]));
    if (b < nblk - 1) {  // folded at the start of the next block
      fold_alpha[0] = alpha[0];
      fold_alpha[1] = alpha[1];
      continue;
    }
    // the last block: out = (park * alpha + f32(pv)) * vs / l
    const float* vsb = vs + (size_t)bh * D + 256 * wg + 2 * t;
    const bool parked = nblk >= 2;
#pragma unroll
    for (int g = 0; g < NGROUP; ++g) {
      const uint8_t* box = ring.stage(pos) + wg * (UNIT / 2);
      if (parked) ring.wait(pos);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < FOLD_GROUP; ++n) {
          const int tn = g * FOLD_GROUP + n;
          float2 o = make_float2(static_cast<float>(pv[tn][2 * r]),
                                 static_cast<float>(pv[tn][2 * r + 1]));
          if (parked) {
            const float2 a = parked_value(box, row0 + 8 * r, n, t);
            o = make_float2(__fadd_rn(__fmul_rn(a.x, alpha[r]), o.x),
                            __fadd_rn(__fmul_rn(a.y, alpha[r]), o.y));
          }
          const float2 v = *reinterpret_cast<const float2*>(vsb + 8 * tn);
          if (ok[r])
            store2(out + at[r] + 8 * tn, __fdiv_rn(__fmul_rn(o.x, v.x), l[r]),
                   __fdiv_rn(__fmul_rn(o.y, v.y), l[r]));
        }
      if (parked) {
        ring.release(pos);
        ++pos;
      }
    }
  }
}

// Host: a 3-D tensor map over a contiguous (bh, rows, inner) int8 tensor,
// boxes of (128, box_rows, 1) in the 128-byte swizzle: one box is a
// 128-byte-wide atom of box_rows rows. Rows past `rows` read as zeros.
bool tma_map_s8(CUtensorMap* map, const void* base, int inner, int rows, int bh, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)inner, (cuuint64_t)rows * inner};
  const cuuint32_t box[3] = {128, (cuuint32_t)box_rows, 1};
  return tma_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

// bytes of the parked f32 output a call takes: none where the output is f32
// (parked in place) or the keys are one block
size_t park_bytes(int bh, int sq, int sk, int k_blk, int dtype) {
  return dtype == 1 && sk / k_blk > 1 ? (size_t)bh * sq * D * sizeof(float) : 0;
}

template <typename T>
cudaError_t launch(const void* q8, const void* k8, const void* vt, const float* qs,
                   const float* ks, const float* vs, void* out, float* park, int bh, int sq,
                   int sk, int k_blk, float c, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tks, tpark = {};
  if (!(tma_map_s8(&tq, q8, D, sq, bh, BQ) && tma_map_s8(&tk, k8, D, sk, bh, BK) &&
        tma_map_s8(&tv, vt, sk, D, bh, 128) &&
        tma_map_f32_1d(&tks, ks, (size_t)bh * sk, BK)))
    return cudaErrorInvalidValue;
  // the parked output (f32, (bh, sq, 512)), boxes of 32 columns x 64 rows in
  // the 128-byte swizzle; rows past sq read as zeros. Unread at one block.
  if (sk / k_blk > 1) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)sq, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)sq * D * 4};
    const cuuint32_t box[3] = {8 * FOLD_GROUP, BQ, 1};
    if (park == nullptr || !tma_map(&tpark, park, 3, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return cudaErrorInvalidValue;
  }
  auto kern = flash_int8_wgmma_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return err;
  // whole clusters: a q tile past Sq computes on zeros and stores nothing
  dim3 grid(((sq + BQ - 1) / BQ + CLUSTER - 1) / CLUSTER * CLUSTER, bh);
  kern<<<grid, THREADS, BYTES, stream>>>(tq, tk, tv, tks, tpark, qs, vs, static_cast<T*>(out),
                                         park, sq, sk, k_blk, c);
  return cudaGetLastError();
}

}  // namespace w8

template <typename T>
cudaError_t launch_d64(const void* q8, const void* k8, const void* vt, const float* qs,
                       const float* ks, const float* vs, void* out, int bh, int sq, int sk,
                       int k_blk, float c, cudaStream_t stream) {
  const Layout<64> L(k_blk);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;  // the logits buffer
  auto kern = flash_int8_kernel<64, T>;
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

// The body flash_attn_int8 runs at d = 512, for the record of a run.
extern "C" const char* flash_attn_int8_d512_body() {
  return "wgmma m64nNk32 s8, max pass per k block, TMA ring of 16 KB K/V^T units, "
         "BQ 64 x BK 128, f32 output parked in device memory";
}

// Bytes of scratch flash_attn_int8 takes for these arguments (0: none): the
// d = 512 body's parked f32 output where the output is bf16.
extern "C" long long flash_attn_int8_scratch_bytes(int bh, int sq, int sk, int d, int k_blk,
                                                   int dtype) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || k_blk <= 0 || d != 512) return 0;
  return (long long)w8::park_bytes(bh, sq, sk, k_blk, dtype);
}

// q8: (bh, sq, d), k8: (bh, sk, d), vt: (bh, d, sk) int8; qs: (bh, sq), ks:
// (bh, sk), vs: (bh, d) float32; out: (bh, sq, d) of dtype 0 = float32 or
// 1 = bfloat16; all contiguous; scratch: flash_attn_int8_scratch_bytes of
// device memory (or null where that is 0). d is 64 or 512; k_blk divides sk
// and is a multiple of 64 (at d = 64 one whose logits buffer fits shared
// memory: up to 2304); c = scale * log2(e).
extern "C" int flash_attn_int8(const void* q8, const void* k8, const void* vt,
                               const void* qs, const void* ks, const void* vs, void* out,
                               void* scratch, int bh, int sq, int sk, int d, int k_blk, float c,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || k_blk <= 0 || k_blk % kKT != 0 || sk % k_blk != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* fq = static_cast<const float*>(qs);
  const float* fk = static_cast<const float*>(ks);
  const float* fv = static_cast<const float*>(vs);
  if (d == 64) {
    auto launch = dtype == 0 ? launch_d64<float> : launch_d64<__nv_bfloat16>;
    return (int)launch(q8, k8, vt, fq, fk, fv, out, bh, sq, sk, k_blk, c, s);
  }
  if (d == 512) {
    float* park = dtype == 0 ? static_cast<float*>(out) : static_cast<float*>(scratch);
    if (park == nullptr && w8::park_bytes(bh, sq, sk, k_blk, dtype) > 0)
      return (int)cudaErrorInvalidValue;
    auto launch = dtype == 0 ? w8::launch<float> : w8::launch<__nv_bfloat16>;
    return (int)launch(q8, k8, vt, fq, fk, fv, out, park, bh, sq, sk, k_blk, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
