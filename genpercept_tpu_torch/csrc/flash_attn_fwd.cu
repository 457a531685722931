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
// 9216 tokens is ~108 GFLOP per image and head group). Head dims are those of
// SD2.1: 64 (the UNet's heads) and 512 (the VAE mid block). Three bodies, one
// contract, all on the tensor cores:
//   - f32 (the pipeline default): split TF32 on mma.sync
//     (flash_attn_fwd_f32_kernel, below). Each product is three tf32 mma, so
//     its bound is the two products at a third of the TF32 rate (495 / 3 =
//     165 TFLOP/s).
//   - bf16, d = 64: wgmma for both products, K/V tiles through a TMA ring
//     fed by a producer warpgroup (flash_attn_fwd_wgmma_kernel).
//   - bf16, d = 512: mma.sync with d split over warps
//     (flash_attn_fwd_split_kernel).
// The profiling scripts run K1's function on the mma.sync bodies at
// caller-chosen CTA tiles, out only, through flash_attn_fwd_tiled: S1
// (scripts/profile_unet.py flash_with_blocks) on the d = 64 mma.sync body
// (flash_attn_fwd_mma_kernel, K1's d = 64 body before the wgmma one), S3
// (scripts/profile_attn_boundary.py part "sweep512") on the d = 512 body,
// which is also a template over how l is summed (FOLD).
// The d = 64 mma.sync body is also a template over its softmax step, for
// the scripts' two other variants, out only, reached through their own entries:
//   S2 flash_bf16_softmax  scripts/profile_unet.py::kernel_bf (main(), part
//      "bf16softmax"): the softmax chain in bf16. Per key tile:
//        s     = bf16(q . k^T)                 f32 accumulate, rounded once
//        c     = bf16(scale * log2 e)
//        m_new = max(m, rowmax(s))             bf16 (the max is exact)
//        e     = bf16(bf16(s - m_new) * c)
//        p     = bf16(exp(bf16(ln2 * e)))       jnp.exp2 of a bf16 array
//        alpha = exp2(f32(bf16(bf16(m - m_new) * c)))
//      jnp.exp2 of a bf16 array is exp(ln2 * x) with ln2 = bf16(ln 2) =
//      0.6914 and the product rounded to bf16: that is the TPU kernel's p
//      (about 1.7% from 2^x at x = -10), and so it is here. The subtraction
//      and the two products run as packed bf16x2 arithmetic (__hsub2,
//      __hmul2); the exponential runs in f32 (expf) and is rounded once, as
//      in the plain version, since ex2.approx.ftz.bf16x2 takes 2^x of a bf16
//      argument and would round the argument once more. p is rounded against
//      the running max of the key tiles seen so far, so the key partition is
//      part of the function: the plain version takes it (k_blk = BK).
//   S4 flash_nomax  scripts/profile_attn_boundary.py::kernel (main(), part
//      "nomax"): no running max. p = bf16(exp2(min(s * c, 110))) with s and
//      c in f32; the clamp keeps every p and the sums of 9216 keys below
//      bf16's and f32's range, so nothing is rescaled.
// The d = 64 mma.sync body carries l as the ones n-tile of PV (S1, S2 and S4
// alike), as the TPU kernels append a ones-column to v.
// The f32 and the d = 512 bodies stage their tiles by cp.async or by every
// thread; TMA and wgmma there are later work.
//
// Design: one CTA per (q tile, batch*head). On the TPU the k blocks were a
// sequential "arbitrary" grid axis carrying m, l and the accumulator in VMEM;
// here nothing carries across CTAs, so the CTA loops over k tiles itself.
// Rows past Sq are computed on zeros and not stored; columns past Sk get the
// -1e30 logit, so ragged lengths need no padding.

#include <type_traits>

#include "common.cuh"

namespace {

using namespace gp;

constexpr float kNegInf = -1e30f;  // same sentinel as the TPU kernel

// ---------------------------------------------------------------------------
// f32 on the tensor cores through split TF32 (3xTF32), as PyTorch's
// memory-efficient attention computes f32 on sm80+ (CUTLASS's
// OpMultiplyAddFastF32). Every operand x of both products is split into
// hi = tf32(x), rounded to nearest with ties away from zero (cvt.rna's
// rounding), and lo = x - hi truncated to tf32 (common.cuh split_tf32), and
// each tile product is lo.hi + hi.lo + hi.hi, small terms first, into one f32
// accumulator of mma.sync m16n8k8; lo.lo (~2^-21 relative) is dropped. The
// products keep the f32 contract (the card holds out and lse2 to 1e-4 of the
// exact-f32 plain version), and the TF32 flags in torch.backends do not
// govern this kernel: it always takes three passes. In f32 the rounding of p
// to v's dtype is the identity.
//
// What bounds it: the two products at the split-TF32 rate, three tf32 mma
// each; beside them the operand splits (an add, two masks and a subtraction
// per element and warp; cvt.rna.tf32.f32 itself lowers to four instructions
// on sm_90a, with a finite check, and is slower: PERF.md), the softmax and
// the fragment reads are FP32-pipe and shared-memory work. What the design
// does about it:
//   - S and P stay in registers. S accumulates in the m16n8 C layout, the
//     online softmax runs on it there, and the four threads of a row reduce
//     max and sum with __shfl_xor_sync. C gives a thread keys 2t, 2t+1 of
//     each 8-key group where the tf32 A layout of PV wants k positions t,
//     t+4: P is not shuffled, the key order inside each group is relabelled
//     (key 2t -> position t, key 2t+1 -> t+4) and V's B rows are read in the
//     same order. B fragments of 32-bit types are plain lds, so the
//     permutation costs nothing.
//   - K and V tiles of BK keys run through a ring of NBUF shared-memory
//     buffers in the order K0, V0, K1, V1, ... by cp.async (16 bytes, .cg):
//     tile i + NBUF - 1 loads while tile i's products run, one commit group
//     and one barrier per tile. Rows are padded to D + 4 floats, so the
//     fragment reads of both products (key rows g or 2t, 2t+1; d or value
//     columns t or g) meet no bank conflict.
//   - Each pass of mma_3xtf32 runs over several n tiles, so consecutive mma
//     never wait on each other's accumulator.
//   - Each warp owns a 16-row part of the BQ = 16 * PARTS-row q tile and a
//     1/SPLITS slice of d.
//       d = 64: 4 warps, SPLITS 1, 32 keys a tile, NBUF 4 (two K and V
//         stages, 34 KB); Q's hi/lo fragments stay in registers (64 a
//         thread), loaded once per CTA.
//       d = 512, the VAE mid block, carries over the bf16 split body's
//         structure: 8 warps, 2 row parts x 4 quarters of d, each with its
//         (16, 128) accumulator (64 registers). Q's hi/lo for a quarter would
//         take 128 more, so Q stays in shared memory and is split at each k
//         step. Partial S over the quarters goes to shared memory and every
//         warp sums the four in one order, so the four warps of a row part
//         hold identical S, m, l and P; each runs PV on its quarter of V's
//         columns. f32 doubles every tile, so 32 keys a tile (64.5 KB), NBUF
//         2, Q (64.5 KB) and the partial S (20 KB): 213.5 KB of 227.

template <int D, int PARTS, int SPLITS, int BK, int NBUF>
struct F32Tile {
  static constexpr int THREADS = 32 * PARTS * SPLITS;
  static constexpr int BQ = 16 * PARTS;
  static constexpr int LD = D + 4;             // tile row stride (floats)
  static constexpr int SLD = BK + 8;           // partial-S row stride
  static constexpr bool QREG = SPLITS == 1;    // Q's fragments in registers
  static constexpr int RING = NBUF * BK * LD;  // shared memory, in floats
  static constexpr int QS = QREG ? 0 : BQ * LD;
  static constexpr int SP = SPLITS == 1 ? 0 : SPLITS * BQ * SLD;
  static constexpr size_t BYTES = (size_t)(RING + QS + SP) * sizeof(float);
};

template <int D, int PARTS, int SPLITS, int BK, int NBUF>
__global__ void __launch_bounds__(32 * PARTS * SPLITS)
flash_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, int sq, int sk, float scale) {
  using T = F32Tile<D, PARTS, SPLITS, BK, NBUF>;
  constexpr int LD = T::LD;
  constexpr int DS = D / SPLITS;   // this warp's slice of d
  constexpr int KD = DS / 8;       // k steps of its Q K^T
  constexpr int NS = BK / 8;       // 8-key column tiles of S
  constexpr int NO = DS / 8;       // 8-wide column tiles of its O
  constexpr int kPvTiles = 4;      // O column tiles per pass of PV's products
  static_assert(NBUF >= 2 && NO % kPvTiles == 0 && BK % 8 == 0, "ring and fragments");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [NBUF][BK][LD]
  float* Qs = ring + T::RING;                     // [BQ][LD], SPLITS > 1
  float* Sp = Qs + T::QS;                         // [SPLITS][BQ][SLD], SPLITS > 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp % PARTS, slice = warp / PARTS;
  const int g = lane / 4, t = lane % 4;
  const int r0 = part * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  const int d0 = slice * DS;
  const int q0 = blockIdx.x * T::BQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const float c = scale * 1.4426950408889634f;
  const int ntile = 2 * ((sk + BK - 1) / BK);  // K0, V0, K1, V1, ...

  // one commit group per tile, empty past the last, so that "tile i has
  // landed" is always cp.async.wait_group NBUF - 2 at tile i
  auto load_tile = [&](int tile) {
    if (tile < ntile)
      cp_async_rows<D, BK, T::THREADS>(ring + (tile % NBUF) * BK * LD, tile % 2 ? vb : kb,
                                       (tile / 2) * BK, sk);
    cp_async_commit();
  };

  uint32_t qh[T::QREG ? KD : 1][4], ql[T::QREG ? KD : 1][4];
  if constexpr (T::QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r0 + 8 * (i % 2);
        const float x = row < sq ? qb[(size_t)row * D + d0 + kd * 8 + t + 4 * (i / 2)] : 0.f;
        split_tf32(x, qh[kd][i], ql[kd][i]);
      }
  } else {
    cp_async_rows<D, T::BQ, T::THREADS>(Qs, qb, q0, sq);  // lands with tile 0
  }
#pragma unroll
  for (int tile = 0; tile < NBUF - 1; ++tile) load_tile(tile);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows r0, r0 + 8

  for (int k0 = 0, tile = 0; k0 < sk; k0 += BK, tile += 2) {
    // K tile: S = Q K^T over this warp's slice of d
    cp_async_wait<NBUF - 2>();
    __syncthreads();  // the tile is visible; every warp is done with the tile before
    load_tile(tile + NBUF - 1);
    const float* Kt = ring + (tile % NBUF) * BK * LD;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (T::QREG) {
          ah[i] = qh[kd][i];
          al[i] = ql[kd][i];
        } else {
          split_tf32(Qs[(r0 + 8 * (i % 2)) * LD + d0 + kd * 8 + t + 4 * (i / 2)], ah[i], al[i]);
        }
      }
      uint32_t kh[NS][2], kl[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* kp = Kt + (n * 8 + g) * LD + d0 + kd * 8 + t;  // key n*8+g, d t and t+4
        split_tf32(kp[0], kh[n][0], kl[n][0]);
        split_tf32(kp[4], kh[n][1], kl[n][1]);
      }
      mma_3xtf32<NS>(s, ah, al, kh, kl);
    }
    if constexpr (SPLITS > 1) {  // sum the slices' partial S in one fixed order
      float* mine = Sp + (slice * T::BQ + part * 16) * T::SLD;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        *reinterpret_cast<float2*>(mine + g * T::SLD + n * 8 + 2 * t) =
            make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * T::SLD + n * 8 + 2 * t) =
            make_float2(s[n][2], s[n][3]);
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int sl = 0; sl < SPLITS; ++sl) {
            const float2 ps = *reinterpret_cast<const float2*>(
                Sp + (sl * T::BQ + r0 + 4 * j) * T::SLD + n * 8 + 2 * t);
            acc.x += ps.x;
            acc.y += ps.y;
          }
          s[n][j] = acc.x;
          s[n][j + 1] = acc.y;
        }
    }
    if (k0 + BK > sk) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + n * 8 + 2 * t + (j & 1) >= sk) s[n][j] = kNegInf;
    }

    // online softmax in registers; rows r0 (j = 0, 1) and r0 + 8 (j = 2, 3)
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
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = exp2f(s[n][j] * c - mc[j / 2]);  // p, in s
      rs[0] += s[n][0] + s[n][1];
      rs[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // V tile: O += P V over this warp's slice of V's columns
    cp_async_wait<NBUF - 2>();
    __syncthreads();
    load_tile(tile + NBUF);
    const float* Vt = ring + ((tile + 1) % NBUF) * BK * LD;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // key 2t of group j at k position t, key 2t + 1 at t + 4
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* vp = Vt + (j * 8 + 2 * t) * LD + d0 + g;  // keys 2t, 2t+1, column g
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += kPvTiles) {
        uint32_t vh[kPvTiles][2], vl[kPvTiles][2];
#pragma unroll
        for (int n = 0; n < kPvTiles; ++n) {
          split_tf32(vp[(n0 + n) * 8], vh[n][0], vl[n][0]);
          split_tf32(vp[LD + (n0 + n) * 8], vh[n][1], vl[n][1]);
        }
        mma_3xtf32<kPvTiles>(o + n0, ah, al, vh, vl);
      }
    }
  }

  // finish: l of the row from its four threads; o = acc / l; lse2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= sq) continue;
    float* orow = out + (bh * sq + row) * D + d0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (slice == 0 && t == 0) lse[bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int D, int PARTS, int SPLITS, int BK, int NBUF>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int bh, int sq, int sk, float scale, cudaStream_t stream) {
  using T = F32Tile<D, PARTS, SPLITS, BK, NBUF>;
  auto kern = flash_attn_fwd_f32_kernel<D, PARTS, SPLITS, BK, NBUF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + T::BQ - 1) / T::BQ, bh);
  kern<<<grid, T::THREADS, T::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at d = 64: K1's body, on wgmma. What bounds it: the two products at
// the bf16 tensor rate (4 * 64 = 256 flop a logit), and beside them the
// softmax's exponentials, one a logit on the 16-a-clock MUFU of an SM: at
// d = 64 they take about as long as the products, so the design keeps the
// softmax's instructions few and runs it while the tensor cores work.
//   - Each consumer warpgroup owns 64 q rows of a BQ = 64 * NWG-row tile.
//     S = Q K^T is wgmma m64nBKk16, four k steps over d: A is Q from shared
//     memory (loaded once), B the K tile as stored, rows [key][d] with d
//     contiguous (K-major). O += P V is m64n64k16, BK / 16 k steps: A is P
//     from registers and B the V tile [key][d], MN-major, read through the
//     transpose bit. Each 64-element row is one 128-byte swizzle row; Q, K
//     and V tiles all sit in the 128-byte swizzle that sw128_desc names.
//   - S accumulates in registers in the m16n8 C layout per warp, the online
//     softmax runs on it there (the four threads of a row reduce the max
//     with __shfl_xor_sync), and P, packed to bf16 pairs, is at once the
//     register A operand of PV: it never touches shared memory. l is a
//     per-thread f32 sum of the packed (rounded) p, unpacked by a shift and
//     a mask, summed over the row's four threads at the end. exp2 is
//     ex2.approx.ftz: exp2f's extra steps for subnormal results would double
//     the softmax's instructions, and flushing p < 2^-126 to zero moves no
//     sum.
//   - K and V tiles run through a ring of NBUF stages by TMA: a producer
//     warpgroup, whose one thread issues 3-D tensor-map copies (rows past Sk
//     and past Sq arrive as zeros) onto a "full" mbarrier a tile and stage,
//     waits on the stage's "empty" mbarrier, which every consumer thread
//     arrives on once the tile's PV product has retired. setmaxnreg gives
//     the producer's registers to the consumers.
//   - Within a warpgroup, each pipeline stage issues tile i + 1's Q K^T and
//     tile i's P V together; once the first retires (wgmma.wait_group 1) the
//     softmax's max and exponentials of tile i + 1 run while the second is
//     still on the tensor cores. Then the second retires, the stage's K and
//     V are released, O is rescaled by tile i + 1's alpha, and the new p are
//     packed into P. A stage is straight-line code from its first wgmma to
//     its last wait, the waits for its tiles before it and the mask of the
//     last tile compiled into its own copy: where ptxas cannot follow a
//     stage it waits after every wgmma (advisory C7514).
// Keys past Sk take the -1e30 logit (their zero rows would give 0); rows past
// Sq are computed on zeros and not stored.

template <int NWG, int BK, int NBUF>
struct WgTile {
  static constexpr int BQ = 64 * NWG;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int QB = 64 * 128;              // bytes of a warpgroup's Q
  static constexpr int TILE = BK * 128;            // bytes of a K or V tile
  static constexpr int NBAR = 1 + 3 * NBUF;        // Q, full K, full V, empty
  static constexpr size_t BYTES = 1024 + (size_t)NWG * QB + 2 * NBUF * TILE + 8 * NBAR;
  // CTAs a SM: two at one consumer warpgroup, so that one CTA's softmax runs
  // beside the other's products. A kernel that runs setmaxnreg starts with
  // the registers its launch bounds give each thread, 64K / (THREADS * MINB)
  // rounded down to 8; the producer keeps 40 and the consumers share the rest
  // (an increase past what the producer frees would wait forever).
  static constexpr int MINB = NWG == 1 ? 2 : 1;
  static constexpr int REGS = 65536 / (THREADS * MINB) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) / NWG / 8 * 8;
  static_assert((BK == 64 || BK == 128) && NBUF >= 2, "tile and ring");
  static_assert(REGS <= 248 && CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NWG, int BK, int NBUF>
__global__ void __launch_bounds__(WgTile<NWG, BK, NBUF>::THREADS, WgTile<NWG, BK, NBUF>::MINB)
flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                            int sq, int sk, float scale) {
  using T = WgTile<NWG, BK, NBUF>;
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int NO = 8;        // 8-wide column tiles of O
  constexpr int KP = BK / 16;  // k steps of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [NWG][64][128 B]
  uint8_t* Ks = Qs + NWG * T::QB;       // [NBUF][BK][128 B]
  uint8_t* Vs = Ks + NBUF * T::TILE;    // [NBUF][BK][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + NBUF * T::TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NBUF;
  uint64_t* empty = v_full + NBUF;

  const int q0 = blockIdx.x * T::BQ;
  const int bh = blockIdx.y;
  const int ntile = (sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, T::CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= T::CONSUMERS) {  // the producer warpgroup
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS) {
      mbar_expect_tx(q_full, NWG * T::QB);
      for (int w = 0; w < NWG; ++w) tma_load_3d(Qs + w * T::QB, &tq, q_full, 0, q0 + 64 * w, bh);
      for (int i = 0; i < ntile; ++i) {
        const int s = i % NBUF;
        if (i >= NBUF) mbar_wait(empty + s, (i / NBUF - 1) & 1);  // tile i - NBUF released
        mbar_expect_tx(k_full + s, T::TILE);
        tma_load_3d(Ks + s * T::TILE, &tk, k_full + s, 0, i * BK, bh);
        mbar_expect_tx(v_full + s, T::TILE);
        tma_load_3d(Vs + s * T::TILE, &tv, v_full + s, 0, i * BK, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<T::CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;  // rows lane / 4 and lane / 4 + 8 of the warp's 16, columns 2t, 2t + 1
  const uint8_t* Qw = Qs + wg * T::QB;
  const float c = scale * 1.4426950408889634f;

  float o[NO][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pf[KP][4];  // P of the tile whose P V is next

  // S = Q K^T of tile i into s, and P V of tile i into o, issued
  auto issue_qk = [&](int i) {
    const uint8_t* Kt = Ks + (i % NBUF) * T::TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, sw128_desc(Qw + 32 * kk), sw128_desc(Kt + 32 * kk), kk);
  };
  auto issue_pv = [&](int i) {
    const uint8_t* Vt = Vs + (i % NBUF) * T::TILE;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) wgmma_rs(o, pf[kk], sw128_desc(Vt + 2048 * kk), 1);
  };
  // The softmax of tile i's S, in two steps. exps: the mask of keys past Sk
  // (MASK: the last tile), the running max of rows lane / 4 (j = 0, 1) and
  // lane / 4 + 8 (j = 2, 3), alpha, and p = exp2(s * c - m * c) in place of
  // s. pack: p rounded to bf16 pairs into P, the A operand of P V, and l
  // rescaled plus the sum of the rounded p.
  auto exps = [&](int i, auto mask) {
    if (decltype(mask)::value) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i * BK + n * 8 + 2 * t + (j & 1) >= sk) s[n][j] = kNegInf;
    }
    float tm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      tm[0] = fmaxf(tm[0], fmaxf(s[n][0], s[n][1]));
      tm[1] = fmaxf(tm[1], fmaxf(s[n][2], s[n][3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
      const float m_new = fmaxf(m[r], tm[r]);
      alpha[r] = ex2((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = m_new * c;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = ex2(fmaf(s[n][j], c, -mc[j / 2]));
  };
  auto pack = [&]() {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t pk = pack_bf16(s[n][2 * r], s[n][2 * r + 1]);
        pf[n / 2][(n % 2) * 2 + r] = pk;
        rs[r] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xFFFF0000u);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  };
  // One pipeline stage, straight-line from its first wgmma to its last wait
  // (ptxas serializes every wgmma when it cannot follow a stage): Q K^T of
  // tile i + 1 and P V of tile i on the tensor cores, the exps of tile i + 1
  // while the second is in flight; then O rescaled and P packed.
  auto stage = [&](int i, auto mask) {
    mbar_wait(k_full + (i + 1) % NBUF, ((i + 1) / NBUF) & 1);
    mbar_wait(v_full + i % NBUF, (i / NBUF) & 1);
    reg_fence(s);
    reg_fence(o);
    reg_fence(pf);
    wgmma_fence();
    issue_qk(i + 1);
    wgmma_commit();
    issue_pv(i);
    wgmma_commit();
    wgmma_wait<1>();  // Q K^T retired; P V in flight
    reg_fence(s);
    exps(i + 1, mask);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    mbar_arrive(empty + i % NBUF);  // tile i's K and V are read
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    pack();
  };

  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  reg_fence(s);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  if (BK > sk) exps(0, std::true_type{});
  else exps(0, std::false_type{});
  pack();
  for (int i = 0; i + 2 < ntile; ++i) stage(i, std::false_type{});
  if (ntile > 1) stage(ntile - 2, std::true_type{});  // the last tile may be partial
  mbar_wait(v_full + (ntile - 1) % NBUF, ((ntile - 1) / NBUF) & 1);
  reg_fence(o);
  reg_fence(pf);
  wgmma_fence();
  issue_pv(ntile - 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);
  reg_fence(pf);

  // finish: l of the row from its four threads; o = acc / l; lse2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * sq + row) * 64;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (t == 0) lse[(size_t)bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int NWG, int BK, int NBUF>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int bh, int sq, int sk, float scale, cudaStream_t stream) {
  using T = WgTile<NWG, BK, NBUF>;
  CUtensorMap tq, tk, tv;
  if (!(tma_map_bhsd64(&tq, q, sq, bh, 64) && tma_map_bhsd64(&tk, k, sk, bh, BK) &&
        tma_map_bhsd64(&tv, v, sk, bh, BK)))
    return cudaErrorInvalidValue;
  auto kern = flash_attn_fwd_wgmma_kernel<NWG, BK, NBUF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + T::BQ - 1) / T::BQ, bh);
  kern<<<grid, T::THREADS, T::BYTES, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse,
                                               sq, sk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at d = 64 on mma.sync m16n8k16, f32 accumulate: K1's d = 64 body until
// the wgmma one (above), now the profiling scripts' (S1's tile sweep, S2,
// S4). WARPS warps each own 16 query rows of a BQ = 16*WARPS-row tile; K and
// V tiles of BK keys are loaded by every thread, synchronously, into shared
// memory with rows padded by 16 bytes, so ldmatrix meets no bank conflicts.
// S, the rounded P and the output accumulator stay in registers: the m16n8
// accumulator layout of two adjacent S tiles is the A-operand layout of PV,
// so P never touches shared memory. m is kept per row. l, the sum of the
// rounded p, is one more mma n-tile whose B operand is all ones, riding the
// PV product as the TPU kernel's appended ones-column. K1 ran <4 warps, 64
// keys> with l summed apart, per thread, instead.

// the softmax step of the d = 64 body (the file header gives each)
enum Softmax {
  kF32Max = 0,     // K1, S1: running max of the f32 logits
  kBf16Chain = 1,  // S2: the softmax chain in bf16
  kNoMax = 2,      // S4: no max, exp2 clamped at 110, no rescale
};

// bf16(exp(x)) of two bf16 lanes, the exponential in f32
__device__ __forceinline__ uint32_t exp_bf16x2(__nv_bfloat162 x) {
  return pack_bf16(expf(__low2float(x)), expf(__high2float(x)));
}

template <int D, int WARPS, int BK, int SOFTMAX>
__global__ void __launch_bounds__(32 * WARPS)
flash_attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                          int sq, int sk, float scale) {
  constexpr int THREADS = 32 * WARPS;
  constexpr int BQ = 16 * WARPS;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int NS = BK / 8;       // 8-key column tiles of S
  constexpr int NO = D / 8;        // 8-wide column tiles of O
  static_assert(NS % 2 == 0 && NO % 2 == 0, "tiles are loaded in pairs");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;  // accumulator row g (and g+8), cols 2qd, 2qd+1
  const int mi = lane / 8, mr = lane % 8; // ldmatrix: matrix index, row in matrix
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const float c = scale * 1.4426950408889634f;
  const __nv_bfloat16 cb = __float2bfloat16(c);  // S2's bf16 constants
  const __nv_bfloat162 cb2 = __halves2bfloat162(cb, cb);
  const __nv_bfloat162 ln2 = __float2bfloat162_rn(0.6931471805599453f);

  load_rows<D, THREADS>(Qs, qb, q0, sq, BQ);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(Qs + (warp * 16 + mr + 8 * (mi % 2)) * LD + kd * 16 + 8 * (mi / 2), qf[kd]);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // S2 keeps m as a bf16 value held in a float
  const float m0 = SOFTMAX == kBf16Chain ? round_bf16(kNegInf) : kNegInf;
  float m[2] = {m0, m0};
  float lf[4] = {0.f, 0.f, 0.f, 0.f};  // the ones n-tile: every column is l

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous tile's K and V reads are done
    load_rows<D, THREADS>(Ks, kb, k0, sk, BK);
    load_rows<D, THREADS>(Vs, vb, k0, sk, BK);
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
    if (k0 + BK > sk) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + n * 8 + 2 * qd + (j & 1) >= sk) s[n][j] = kNegInf;
    }

    // online softmax; rows g (j = 0, 1) and g + 8 (j = 2, 3). alpha stays 1
    // without a max (S4)
    uint32_t pf[NS / 2][4];
    float alpha[2] = {1.f, 1.f};
    if (SOFTMAX == kBf16Chain) {
      // logits rounded to bf16 once; the row max over the rounded logits
      __nv_bfloat162 sb[NS][2];  // [n][0]: row g, [n][1]: row g + 8
      float tm[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        sb[n][0] = __floats2bfloat162_rn(s[n][0], s[n][1]);
        sb[n][1] = __floats2bfloat162_rn(s[n][2], s[n][3]);
        tm[0] = fmaxf(tm[0], fmaxf(__low2float(sb[n][0]), __high2float(sb[n][0])));
        tm[1] = fmaxf(tm[1], fmaxf(__low2float(sb[n][1]), __high2float(sb[n][1])));
      }
      __nv_bfloat162 mn2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
        tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
        const float m_new = fmaxf(m[r], tm[r]);  // bf16 values: exact
        const __nv_bfloat16 mp = __float2bfloat16(m[r]), mn = __float2bfloat16(m_new);
        alpha[r] = exp2f(__bfloat162float(__hmul(__hsub(mp, mn), cb)));
        m[r] = m_new;
        mn2[r] = __halves2bfloat162(mn, mn);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pf[n / 2][(n % 2) * 2 + r] =
              exp_bf16x2(__hmul2(__hmul2(__hsub2(sb[n][r], mn2[r]), cb2), ln2));
    } else {
      float mc[2] = {0.f, 0.f};
      if (SOFTMAX == kF32Max) {  // the max of the raw logits
        float tm[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          tm[0] = fmaxf(tm[0], fmaxf(s[n][0], s[n][1]));
          tm[1] = fmaxf(tm[1], fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
          tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
          const float m_new = fmaxf(m[r], tm[r]);
          alpha[r] = exp2f((m[r] - m_new) * c);
          m[r] = m_new;
          mc[r] = m_new * c;
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)  // rounded once, by pack_bf16
          p[j] = SOFTMAX == kNoMax ? exp2f(fminf(s[n][j] * c, 110.f))
                                   : exp2f(s[n][j] * c - mc[j / 2]);
        pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }
    lf[0] *= alpha[0]; lf[1] *= alpha[0];
    lf[2] *= alpha[1]; lf[3] *= alpha[1];
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) mma_bf16(lf, pf[j], kOnesBF16x2, kOnesBF16x2);
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

  // finish: l of the row from the ones n-tile; o = acc / l; lse2 for K1's
  // softmax only (S2 and S4 are out only)
  const float l[2] = {lf[0], lf[2]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + (bh * sq + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (SOFTMAX == kF32Max && qd == 0) lse[bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int D, int WARPS, int BK, int SOFTMAX = kF32Max>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int bh, int sq, int sk, float scale,
                       cudaStream_t stream) {
  constexpr int BQ = 16 * WARPS;
  constexpr size_t bytes = (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  auto kern = flash_attn_fwd_mma_kernel<D, WARPS, BK, SOFTMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, 32 * WARPS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
      sq, sk, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at d = 512 (the VAE mid block): tensor cores with d split
// four ways. A 16-row accumulator over all of d=512 would need 256 f32
// registers a thread, so each of 4*BQ/16 warps owns one 16-row part of a
// BQ-row q tile and one quarter of d: its Q fragments (32 registers at
// d=512) and its (16, d/4) output accumulator (64) stay in registers. Per
// BK-key tile the warps write partial S over their quarter of d to shared
// memory, and every warp then sums the four quarters in the same order, so
// the four warps of a row part hold identical S, m, l and rounded P, and run
// PV on their own quarter of V's columns. l is either a per-thread partial
// over the thread's columns that the four threads of a row add at the end
// (FOLD false) or the ones n-tile of the d = 64 mma.sync body (FOLD true). K1
// runs <32 rows, 64 keys, FOLD false>; the other instantiations are the
// profiling scripts' sweep (S1 at d = 512, S3).

template <int D, int BQ, int BK, bool FOLD>
__global__ void __launch_bounds__(32 * 4 * (BQ / 16))
flash_attn_fwd_split_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                            int sq, int sk, float scale) {
  constexpr int PARTS = BQ / 16;   // 16-row parts of the q tile
  constexpr int THREADS = 32 * 4 * PARTS;
  constexpr int SLD = BK + 8;      // partial-S row stride (floats)
  constexpr int LD = D + 8;
  constexpr int DQ = D / 4;        // this warp's quarter of d
  constexpr int KD = DQ / 16;      // k-steps of its partial Q K^T
  constexpr int NS = BK / 8;
  constexpr int NO = DQ / 8;
  static_assert(NS % 2 == 0 && NO % 2 == 0, "tiles are loaded in pairs");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + BK * LD;
  float* Sp = reinterpret_cast<float*>(Vs + BK * LD);  // [4][BQ][SLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp % PARTS, quarter = warp / PARTS;
  const int g = lane / 4, qd = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const float c = scale * 1.4426950408889634f;
  const int d0 = quarter * DQ;

  // Q tile staged through the K buffer
  load_rows<D, THREADS>(Ks, qb, q0, sq, BQ);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(Ks + (part * 16 + mr + 8 * (mi % 2)) * LD + d0 + kd * 16 + 8 * (mi / 2), qf[kd]);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float lf[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // Q staging, or the previous tile's K, V and S reads, are done
    for (int idx = threadIdx.x; idx < BK * (D / 8); idx += THREADS) {
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
      float* mine = Sp + (quarter * BQ + part * 16) * SLD;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        *reinterpret_cast<float2*>(mine + g * SLD + n * 8 + 2 * qd) =
            make_float2(sp[n][0], sp[n][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * SLD + n * 8 + 2 * qd) =
            make_float2(sp[n][2], sp[n][3]);
      }
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int row = part * 16 + g + 8 * (j / 2), col = n * 8 + 2 * qd;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {  // fixed order: identical in every warp
          const float2 part_s = *reinterpret_cast<const float2*>(
              Sp + (qq * BQ + row) * SLD + col);
          acc.x += part_s.x;
          acc.y += part_s.y;
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
      if (!FOLD) {
        rs[0] += p[0] + p[1];
        rs[1] += p[2] + p[3];
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    if (FOLD) {
      lf[0] *= alpha[0]; lf[1] *= alpha[0];
      lf[2] *= alpha[1]; lf[3] *= alpha[1];
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) mma_bf16(lf, pf[j], kOnesBF16x2, kOnesBF16x2);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    }
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

  if (FOLD) {
    l[0] = lf[0];
    l[1] = lf[2];
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + part * 16 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + (bh * sq + row) * D + d0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (quarter == 0 && qd == 0) lse[bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int D, int BQ, int BK, bool FOLD>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out,
                         float* lse, int bh, int sq, int sk, float scale,
                         cudaStream_t stream) {
  constexpr size_t bytes = (size_t)2 * BK * (D + 8) * sizeof(__nv_bfloat16) +
                           (size_t)4 * BQ * (BK + 8) * sizeof(float);
  static_assert(BQ <= BK, "the Q tile is staged through the K buffer");
  auto kern = flash_attn_fwd_split_kernel<D, BQ, BK, FOLD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, 32 * 4 * (BQ / 16), bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
      sq, sk, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out,
                         float* lse, int bh, int sq, int sk, int d, float scale,
                         cudaStream_t stream) {
  switch (d) {
    // <D, row parts, d slices, keys a tile, ring buffers>: the f32 body's
    // two instantiations (its note above)
    case 64:  return launch_f32<64, 4, 1, 32, 4>(q, k, v, out, lse, bh, sq, sk, scale, stream);
    case 512: return launch_f32<512, 2, 4, 32, 2>(q, k, v, out, lse, bh, sq, sk, scale, stream);
    default:  return cudaErrorInvalidValue;
  }
}

// K1's bf16 body at d = 64: launch_wgmma<consumer warpgroups of 64 q rows,
// keys a tile, ring stages>. One tile for every length: one consumer
// warpgroup (BQ 64), 128 keys a tile and 3 stages (105 KB), two CTAs a SM.
// Timed against 2 and 3 warpgroups a CTA, 64-key tiles and other ring depths
// at the five d = 64 shapes of the main paths (scripts/tune_k1.py), it was
// fastest or within 3% at each, so no second instantiation is dispatched.
cudaError_t dispatch_bf16_d64(const void* q, const void* k, const void* v, void* out,
                              float* lse, int bh, int sq, int sk, float scale,
                              cudaStream_t stream) {
  return launch_wgmma<1, 128, 3>(q, k, v, out, lse, bh, sq, sk, scale, stream);
}

// the d = 64 CTA tiles (query rows, keys) of the profiling scripts' sweep
#define GP_D64_TILES(X) X(64, 32) X(64, 64) X(64, 128) X(128, 64) X(128, 128)

// S2 or S4 at d = 64 and tile (bq, bk), out only
template <int SOFTMAX>
cudaError_t dispatch_variant(const void* q, const void* k, const void* v, void* out, int bh,
                             int sq, int sk, int d, float scale, int bq, int bk,
                             cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != 64) return cudaErrorInvalidValue;
#define GP_TILE(BQ, BK)                                                               \
  if (bq == BQ && bk == BK)                                                           \
    return launch_mma<64, BQ / 16, BK, SOFTMAX>(q, k, v, out, nullptr, bh, sq, sk, scale, \
                                                 stream);
  GP_D64_TILES(GP_TILE)
#undef GP_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// The f32 body flash_attn_fwd runs, for the record of a run.
extern "C" const char* flash_attn_fwd_f32_body() {
  return "split TF32: 3xTF32 mma.sync m16n8k8, cp.async K/V ring";
}

// The bf16 body it runs at d = 64 (dispatch_bf16_d64).
extern "C" const char* flash_attn_fwd_bf16_body() {
  return "wgmma m64nNk16, TMA K/V ring, BQ 64 x BK 128";
}

// q: (bh, sq, d), k/v: (bh, sk, d), out: (bh, sq, d), all contiguous and of
// one dtype (0 = float32, 1 = bfloat16); lse: (bh, sq) float32.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int sq, int sk,
                              int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_f32(q, k, v, out, l, bh, sq, sk, d, scale, s);
  if (dtype == 1 && d == 64) return (int)dispatch_bf16_d64(q, k, v, out, l, bh, sq, sk, scale, s);
  if (dtype == 1 && d == 512)
    return (int)launch_split<512, 32, 64, false>(q, k, v, out, l, bh, sq, sk, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The same function, bf16 only, with a caller-chosen CTA tile: bq query rows
// by bk keys per step, and the row sum folded into PV (fold = 1) or summed
// apart (0). The instantiated sets (the profiling scripts' sweep; the Python
// constants D64_TILES and D512_TILES list them): d = 64 with fold = 1 at
// (64, 32), (64, 64), (64, 128), (128, 64), (128, 128); d = 512 with either
// fold at (16, 32), (16, 64), (32, 32), (32, 64). Any other set returns
// cudaErrorInvalidValue. Arguments as flash_attn_fwd's.
extern "C" int flash_attn_fwd_tiled(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int bh, int sq, int sk,
                                    int d, float scale, int bq, int bk, int fold,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
#define GP_D64(BQ, BK)                                                              \
  if (d == 64 && fold == 1 && bq == BQ && bk == BK)                                 \
    return (int)launch_mma<64, BQ / 16, BK>(q, k, v, out, l, bh, sq, sk, scale, s);
  GP_D64_TILES(GP_D64)
#undef GP_D64
#define GP_D512(BQ, BK)                                                             \
  if (d == 512 && bq == BQ && bk == BK)                                             \
    return (int)(fold == 1 ? launch_split<512, BQ, BK, true>(q, k, v, out, l, bh, sq, sk, scale, s) \
                           : launch_split<512, BQ, BK, false>(q, k, v, out, l, bh, sq, sk, scale, s));
  if (fold == 0 || fold == 1) {
    GP_D512(16, 32) GP_D512(16, 64) GP_D512(32, 32) GP_D512(32, 64)
  }
#undef GP_D512
  return (int)cudaErrorInvalidValue;
}

// S2 and S4 (the file header): q: (bh, sq, 64), k/v: (bh, sk, 64), out:
// (bh, sq, 64), all bf16 and contiguous; no lse. (bq, bk) is one of the
// d = 64 tiles above (D64_TILES); any other returns cudaErrorInvalidValue.
extern "C" int flash_bf16_softmax(const void* q, const void* k, const void* v, void* out,
                                  int bh, int sq, int sk, int d, float scale, int bq, int bk,
                                  void* stream) {
  return (int)dispatch_variant<kBf16Chain>(q, k, v, out, bh, sq, sk, d, scale, bq, bk,
                                           static_cast<cudaStream_t>(stream));
}

extern "C" int flash_nomax(const void* q, const void* k, const void* v, void* out, int bh,
                           int sq, int sk, int d, float scale, int bq, int bk, void* stream) {
  return (int)dispatch_variant<kNoMax>(q, k, v, out, bh, sq, sk, d, scale, bq, bk,
                                       static_cast<cudaStream_t>(stream));
}
