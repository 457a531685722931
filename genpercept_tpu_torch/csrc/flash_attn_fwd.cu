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
//   - bf16, d = 512: wgmma for both products over two consumer warpgroups,
//     K/V as 64-column atoms through a TMA ring fed by a producer warpgroup,
//     the key axis split over CTAs where the grid's last wave would idle
//     (flash_attn_fwd_wgmma_d512_kernel, and flash_attn_fwd_combine_kernel).
// The profiling scripts run K1's function, out only, on these same wgmma
// bodies at caller-chosen CTA tiles (the tile sets GP_D64_TILES and
// GP_D512_TILES, below) through flash_attn_fwd_tiled: S1
// (scripts/profile_unet.py flash_with_blocks) at d = 64 and d = 512 and S3
// (scripts/profile_attn_boundary.py part "sweep512") at d = 512. Both bodies
// are templates over how l is summed (FOLD: the ones n-tile of the TPU
// kernels' appended ones-column, or per-thread sums), and the d = 64 body
// also over its softmax step (SOFTMAX), for the scripts' two other variants,
// out only, reached through their own entries:
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
//      __hmul2); the exponential runs in f32, as 2^(x log2 e) by
//      ex2.approx.ftz, and is rounded once, as in the plain version
//      (ex2.approx.ftz.bf16x2 takes 2^x of a bf16 argument and would round
//      the argument once more). p is rounded against the running max of the
//      key tiles seen so far, so the key partition is part of the function:
//      the plain version takes it (k_blk = BK).
//   S4 flash_nomax  scripts/profile_attn_boundary.py::kernel (main(), part
//      "nomax"): no running max. p = bf16(exp2(min(s * c, 110))) with s and
//      c in f32; the clamp keeps every p and the sums of 9216 keys below
//      bf16's and f32's range, so nothing is rescaled.
// The f32 body stages its tiles by cp.async; the bf16 wgmma bodies by TMA.
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
//   - Each key tile's P V sums from zero in accumulators of its own (four
//     column tiles at a time, P's hi and lo kept in registers), added to
//     the rescaled O by f32 adds: the tensor cores truncate every sum into
//     an accumulator, so O's error stays flat over the key count.
//   - Each warp owns a 16-row part of the BQ = 16 * PARTS-row q tile and a
//     1/SPLITS slice of d.
//       d = 64: 4 warps, SPLITS 1, 64 keys a tile, NBUF 3 (52 KB); Q's
//         hi/lo fragments stay in registers (64 a thread), loaded once per
//         CTA. With the per-tile P V accumulators, 64 keys a tile ran 2-6%
//         faster than 32 with 4 buffers (the per-tile adds and barriers
//         halve; PERF.md).
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

    // V tile: O += P V over this warp's slice of V's columns; key 2t of
    // group j at k position t, key 2t + 1 at t + 4. The tile's products sum
    // into accumulators of their own, from zero, which are added to the
    // rescaled O once per tile: the tensor cores truncate each sum into an
    // accumulator, and over thousands of keys in one accumulator that bias
    // grew with the length (7.8e-5 of max|plain| at 9216 keys). Column
    // groups run outside the keys, so P's hi and lo stay live across them.
    cp_async_wait<NBUF - 2>();
    __syncthreads();
    load_tile(tile + NBUF);
    const float* Vt = ring + ((tile + 1) % NBUF) * BK * LD;
    uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      split_tf32(s[j][0], ph[j][0], pl[j][0]);
      split_tf32(s[j][2], ph[j][1], pl[j][1]);
      split_tf32(s[j][1], ph[j][2], pl[j][2]);
      split_tf32(s[j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += kPvTiles) {
      float part[kPvTiles][4];
#pragma unroll
      for (int n = 0; n < kPvTiles; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float* vp = Vt + (j * 8 + 2 * t) * LD + d0 + g;  // keys 2t, 2t+1, column g
        uint32_t vh[kPvTiles][2], vl[kPvTiles][2];
#pragma unroll
        for (int n = 0; n < kPvTiles; ++n) {
          split_tf32(vp[(n0 + n) * 8], vh[n][0], vl[n][0]);
          split_tf32(vp[LD + (n0 + n) * 8], vh[n][1], vl[n][1]);
        }
        mma_3xtf32<kPvTiles>(part, ph[j], pl[j], vh, vl);
      }
#pragma unroll
      for (int n = 0; n < kPvTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + n][e] += part[n][e];
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
// bf16 at d = 64: K1's body, on wgmma, and the profiling scripts' S1 (at
// d = 64), S2 and S4. What bounds it: the two products at the bf16 tensor
// rate (4 * 64 = 256 flop a logit), and beside them the softmax's
// exponentials, one a logit on the 16-a-clock MUFU of an SM: at d = 64 they
// take about as long as the products, so the design keeps the softmax's
// instructions few and runs it while the tensor cores work.
//   - Each consumer warpgroup owns 64 q rows of a BQ = 64 * NWG-row tile.
//     S = Q K^T is wgmma m64nBKk16 (BK = 32, 64 or 128 keys), four k steps
//     over d: A is Q from shared memory (loaded once), B the K tile as stored,
//     rows [key][d] with d contiguous (K-major). O += P V is m64n64k16, BK /
//     16 k steps: A is P from registers and B the V tile [key][d], MN-major,
//     read through the transpose bit. Each 64-element row is one 128-byte
//     swizzle row; Q, K and V tiles all sit in the 128-byte swizzle that
//     sw128_desc names.
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
// The softmax step (SOFTMAX, the file header gives each) and the row sum
// (FOLD) are template arguments; K1 is <kF32Max, l summed apart>, the S
// bodies fold l into P V, as the TPU kernels append a ones-column to v:
// the per-thread unpacking and adds of the rounded p leave the FP32 pipe,
// which at d = 64 the exponentials and the rescale already load, for the
// tensor cores. The fold widens P V to m64n72k16: its columns 64..71 are
// read from a 16-row atom of bf16 ones that the V descriptor's leading
// byte offset reaches from every stage, so column tile 8 of O is l. A
// second wgmma m64n8k16 a k step with B the ones atom, into an accumulator
// of its own, was the other form: at (10, 9216, 64) its best tile ran 0.561
// ms against the wide form's 0.461 (S1; S2 0.622 against 0.539, S4 0.476
// against 0.456) on an H100: one more instruction and pass over P's
// registers a k step for 8 columns (scripts/tune_s14.py, PERF.md §6).
// Keys past Sk take the -1e30 logit (their zero rows would give 0); rows past
// Sq are computed on zeros and not stored.

// the softmax step of the d = 64 body (the file header gives each)
enum Softmax {
  kF32Max = 0,     // K1, S1: running max of the f32 logits
  kBf16Chain = 1,  // S2: the softmax chain in bf16
  kNoMax = 2,      // S4: no max, exp2 clamped at 110, no rescale
};

// a bf16 pair as the bits of a float register (S2 keeps its pairs in S's
// accumulator registers), and back
__device__ __forceinline__ float bf162_bits(__nv_bfloat162 v) {
  return __uint_as_float(*reinterpret_cast<const uint32_t*>(&v));
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(float bits) {
  const uint32_t u = __float_as_uint(bits);
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

template <int NWG, int BK, int NBUF, bool FOLD = false>
struct WgTile {
  static constexpr int BQ = 64 * NWG;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int QB = 64 * 128;              // bytes of a warpgroup's Q
  static constexpr int TILE = BK * 128;            // bytes of a K or V tile
  static constexpr int ONES = FOLD ? 16 * 128 : 0; // a 16-row atom of bf16 ones
  static constexpr int NBAR = 1 + 3 * NBUF;        // Q, full K, full V, empty
  static constexpr size_t BYTES =
      1024 + (size_t)NWG * QB + 2 * NBUF * TILE + ONES + 8 * NBAR;
  // CTAs a SM: two at one consumer warpgroup, so that one CTA's softmax runs
  // beside the other's products. A kernel that runs setmaxnreg starts with
  // the registers its launch bounds give each thread, 64K / (THREADS * MINB)
  // rounded down to 8; the producer keeps 40 and the consumers share the rest
  // (an increase past what the producer frees would wait forever).
  static constexpr int MINB = NWG == 1 ? 2 : 1;
  static constexpr int REGS = 65536 / (THREADS * MINB) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) / NWG / 8 * 8;
  static_assert((BK == 32 || BK == 64 || BK == 128) && NBUF >= 2, "tile and ring");
  static_assert(REGS <= 248 && CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
  static_assert(MINB * (BYTES + 1024) <= 233472, "shared memory of the CTAs of a SM");
};

template <int NWG, int BK, int NBUF, int SOFTMAX = kF32Max, bool FOLD = false>
__global__ void __launch_bounds__(WgTile<NWG, BK, NBUF, FOLD>::THREADS,
                                  WgTile<NWG, BK, NBUF, FOLD>::MINB)
flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                            int sq, int sk, float scale) {
  using T = WgTile<NWG, BK, NBUF, FOLD>;
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int NO = 8;        // 8-wide column tiles of O
  constexpr int KP = BK / 16;  // k steps of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [NWG][64][128 B]
  uint8_t* Ks = Qs + NWG * T::QB;       // [NBUF][BK][128 B]
  uint8_t* Vs = Ks + NBUF * T::TILE;    // [NBUF][BK][128 B]
  uint8_t* Ones = Vs + NBUF * T::TILE;  // [16][128 B] of bf16 1.0, FOLD
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Ones + T::ONES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NBUF;
  uint64_t* empty = v_full + NBUF;

  const int q0 = blockIdx.x * T::BQ;
  const int bh = blockIdx.y;
  const int ntile = (sk + BK - 1) / BK;

  if constexpr (FOLD) {  // written before the barrier, read by wgmma after it
    for (int i = threadIdx.x; i < T::ONES / 4; i += T::THREADS)
      reinterpret_cast<uint32_t*>(Ones)[i] = kOnesBF16x2;
    fence_proxy_async();
  }
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
  const __nv_bfloat162 cb2 = __float2bfloat162_rn(c);  // S2's bf16 constants
  const __nv_bfloat162 ln2 = __float2bfloat162_rn(0.6931471805599453f);

  float o[NO + FOLD][4], s[NS][4];  // FOLD: o[NO] the ones column tile, every column l
#pragma unroll
  for (int n = 0; n < NO + FOLD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // S2 keeps m as a bf16 value held in a float
  const float m0 = SOFTMAX == kBf16Chain ? round_bf16(kNegInf) : kNegInf;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  uint32_t pf[KP][4];  // P of the tile whose P V is next

  // S = Q K^T of tile i into s, and P V of tile i into o (and the row sum
  // of P into o's ones column tile, FOLD), put in flight
  auto issue_qk = [&](int i) {
    const uint8_t* Kt = Ks + (i % NBUF) * T::TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, sw128_desc(Qw + 32 * kk), sw128_desc(Kt + 32 * kk), kk);
  };
  auto issue_pv = [&](int i) {
    const uint8_t* Vt = Vs + (i % NBUF) * T::TILE;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      if constexpr (FOLD)  // columns 64..71 from the ones atom, lbo bytes on
        wgmma_rs(o, pf[kk],
                 sw128_desc(Vt + 2048 * kk, (uint32_t)(Ones - (Vt + 2048 * kk))), 1);
      else
        wgmma_rs(o, pf[kk], sw128_desc(Vt + 2048 * kk), 1);
    }
  };
  // The softmax of tile i's S, in two steps. exps: the mask of keys past Sk
  // (MASK: the last tile), the running max of rows lane / 4 (j = 0, 1) and
  // lane / 4 + 8 (j = 2, 3), alpha, and p in place of s. pack: p rounded to
  // bf16 pairs into P, the A operand of P V, and, l summed apart, l rescaled
  // plus the sum of the rounded p.
  auto exps = [&](int i, auto mask) {
    if (decltype(mask)::value) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i * BK + n * 8 + 2 * t + (j & 1) >= sk) s[n][j] = kNegInf;
    }
    if constexpr (SOFTMAX == kNoMax) {  // p = exp2(min(s c, 110)); alpha stays 1
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = ex2(fminf(s[n][j] * c, 110.f));
    } else if constexpr (SOFTMAX == kBf16Chain) {
      // in place: s[n][2r] takes row r's pair of logits rounded to bf16, then
      // s[n][2r..2r+1] the pair's exponentials. The row max over the rounded
      // logits (a bf16x2 max: exact); e = bf16(bf16(s - m_new) c), p =
      // bf16(exp(f32(bf16(ln2 e)))), the exponential in f32 as 2^(x log2 e)
      // by ex2.approx, rounded by pack as K1's. (p packed here, where S's
      // registers hold it, serialized every wgmma: ptxas gave the pair to P V's
      // A operand in place, C7511.)
      __nv_bfloat162 tm2[2] = {__float2bfloat162_rn(kNegInf), __float2bfloat162_rn(kNegInf)};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(s[n][2 * r], s[n][2 * r + 1]);
          s[n][2 * r] = bf162_bits(b);
          tm2[r] = __hmax2(tm2[r], b);
        }
      __nv_bfloat162 mn2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm = fmaxf(__low2float(tm2[r]), __high2float(tm2[r]));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float m_new = fmaxf(m[r], tm);  // bf16 values: exact
        mn2[r] = __float2bfloat162_rn(m_new);
        alpha[r] = ex2(__low2float(__hmul2(__hsub2(__float2bfloat162_rn(m[r]), mn2[r]), cb2)));
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 e = __hmul2(__hmul2(__hsub2(as_bf162(s[n][2 * r]), mn2[r]), cb2),
                                           ln2);
          s[n][2 * r] = ex2(__low2float(e) * 1.4426950408889634f);
          s[n][2 * r + 1] = ex2(__high2float(e) * 1.4426950408889634f);
        }
    } else {
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
    }
  };
  auto pack = [&]() {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t pk = pack_bf16(s[n][2 * r], s[n][2 * r + 1]);
        pf[n / 2][(n % 2) * 2 + r] = pk;
        if constexpr (!FOLD)
          rs[r] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xFFFF0000u);
      }
    if constexpr (!FOLD) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = SOFTMAX == kNoMax ? l[r] + rs[r] : l[r] * alpha[r] + rs[r];
    }
  };
  // O (and with it a folded l) rescaled by alpha
  auto rescale = [&]() {
    if constexpr (SOFTMAX != kNoMax) {
#pragma unroll
      for (int n = 0; n < NO + FOLD; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
    }
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
    rescale();
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

  // finish: l of the row from its four threads (or its folded column); o =
  // acc / l; lse2 for K1's softmax only (S2 and S4 are out only)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (FOLD) {
      l[r] = o[FOLD ? NO : 0][2 * r];
    } else {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
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
    if (SOFTMAX == kF32Max && t == 0) lse[(size_t)bh * sq + row] = m[r] * c + log2f(l[r]);
  }
}

template <int NWG, int BK, int NBUF, int SOFTMAX = kF32Max, bool FOLD = false>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int bh, int sq, int sk, float scale, cudaStream_t stream) {
  using T = WgTile<NWG, BK, NBUF, FOLD>;
  CUtensorMap tq, tk, tv;
  if (!(tma_map_bhsd(&tq, q, 64, sq, bh, 64) && tma_map_bhsd(&tk, k, 64, sk, bh, BK) &&
        tma_map_bhsd(&tv, v, 64, sk, bh, BK)))
    return cudaErrorInvalidValue;
  auto kern = flash_attn_fwd_wgmma_kernel<NWG, BK, NBUF, SOFTMAX, FOLD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + T::BQ - 1) / T::BQ, bh);
  kern<<<grid, T::THREADS, T::BYTES, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse,
                                               sq, sk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at d = 512 (the VAE mid block): K1's body, on wgmma, and the
// profiling scripts' S1 (at d = 512) and S3. What bounds it: the two
// products at the bf16 tensor rate (4 * 512 = 2048 flop a logit, eight times
// d = 64's), so the softmax's one exponential a logit is small beside them;
// what the design must manage is where the operands live.
//   - A 64-row O over all of d = 512 is 256 f32 registers a thread, more than
//     a warpgroup holds, so a CTA runs two consumer warpgroups on one 64-row
//     q tile (BQ = 64), and the work of a BK-key tile (BK = 64 or 128) is
//     split between them:
//       S by keys: warpgroup w computes S_w = Q K_w^T for its BK / 2 keys
//         over all of d, 32 k steps of wgmma m64n(BK / 2)k16, A = Q from
//         shared memory (loaded once, 64 KB) and B = the K tile, K-major;
//       O by columns: warpgroup w owns O[:, 256 w : 256 w + 256] (128
//         registers) and runs O += P V[:, its half] as m64n256k16, BK / 16
//         k steps, A = P from shared memory (K-major) and B = V through the
//         transpose bit (MN-major).
//     Between the two, the warpgroups exchange through shared memory: each
//     writes its 64 row maxima, and both take m_new = max(m, max(max_0,
//     max_1)) read in one order, so both hold the same m and alpha bit for
//     bit (O's two halves are rescaled alike); each writes its p, rounded to
//     bf16, into its half of a 64 x BK P tile in the 128-byte swizzle, which
//     both then read whole. l stays a per-thread sum of the rounded p over
//     the thread's keys, combined across the two halves once at the end; or,
//     FOLD (S1 at d = 512 does not, S3 either way), each warpgroup sums the
//     whole P tile's rows with one more wgmma m64n8k16 a k step, B an atom of
//     bf16 ones, into an accumulator of its own: each then holds l, with no
//     branch by warpgroup around a wgmma (which serialized K3/K4's, C7520)
//     and no exchange of l.
//     The alternative, both products split by d with partial S summed
//     through shared memory, moves 64 x BK f32 partial sums a tile where
//     this one moves 64 x BK bf16 p and 64 maxima, and runs every
//     exponential twice.
//   - K and V stream as 64-column atoms: a tile of BK rows is 8 atoms of
//     BK x 128 bytes, each its own 1024-byte-aligned unit in the 128-byte
//     swizzle (chunk c of row r at chunk c ^ (r % 8)), as Q is 8 atoms of 64
//     rows. A k step of Q K^T (16 columns of d) lies inside one atom, 32
//     bytes on per step; the 256 columns of a warpgroup's V half are 4
//     atoms that lie one ring stage apart, the descriptor's leading byte
//     offset. Tile i's atoms take stream positions 16 i + j (K atom j) and
//     16 i + 8 + j (V atom j) in a ring of NBUF atom stages, stage = position
//     % NBUF; with NBUF a multiple of 4 the 4 V atoms of a half always take
//     4 consecutive stages. 208 KB at BK = 128, NBUF = 8: Q 64, P 16, the
//     ring 128; the ring holds 128 KB at BK = 64 too (NBUF = 16).
//   - TMA: a producer warpgroup, one thread of which issues one 3-D
//     tensor-map copy an atom (the map over (512, s, bh), boxes of (64, BK,
//     1); rows past s arrive as zeros) onto the stage's "full" mbarrier and
//     waits on its "empty" one, on which every consumer thread arrives once
//     the atom is read (K atoms after their Q K^T group retires, so that V's
//     atoms stream in under Q K^T; V atoms after P V). A warpgroup also waits
//     on and releases the other half's V atoms, in stream order around its
//     own: a parity wait cannot tell a phase from the one two before it, so
//     no thread may skip one. setmaxnreg gives the producer's registers to
//     the consumers (40 and 232 of the 168 a thread the launch bounds give at
//     384 threads). The first step of this body staged each tile's K atoms,
//     then its V atoms, by cp.async from the 256 consumer threads with a
//     barrier on each side: twice the time (PERF.md).
//   - Named barriers (bar.sync 1, 256) join the two consumer warpgroups,
//     never the producer: after the maxima are written and after P is.
//     Writes of P by st.shared are fenced into the async proxy before
//     wgmma reads them.
// Keys past Sk take the -1e30 logit (their zero rows would give 0); rows past
// Sq are computed on zeros and not stored.

template <int BK, int NBUF, bool FOLD = false>
struct WgD512Tile {
  static constexpr int ATOMS = 8;                  // 64-column atoms of a 512 row
  static constexpr int BQ = 64;
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int QATOM = 64 * 128;           // bytes of a Q atom
  static constexpr int ATOM = BK * 128;            // bytes of a K or V atom
  static constexpr int PB = 64 * BK * 2;           // bytes of P
  static constexpr int ONES = FOLD ? 8 * 128 : 0;  // 8 rows of bf16 ones
  static constexpr int NBAR = 1 + 2 * NBUF;        // Q, full, empty
  static constexpr size_t BYTES = 1024 + ATOMS * QATOM + PB + (size_t)NBUF * ATOM + ONES +
                                  4 * 64 * sizeof(float) + 8 * NBAR;
  // setmaxnreg as WgTile's: 65536 / 384 rounded down to 8 at launch
  static constexpr int REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) / 2 / 8 * 8;
  // S: m64n64k16 at BK = 128, m64n32k16 at 64
  static_assert((BK == 64 || BK == 128) && NBUF % 4 == 0, "tile and ring");
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
  static_assert(BYTES <= 232448, "shared memory of a CTA");
};

template <int BK, int NBUF, bool FOLD = false>
__global__ void __launch_bounds__(WgD512Tile<BK, NBUF, FOLD>::THREADS, 1)
flash_attn_fwd_wgmma_d512_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                 float* __restrict__ o_part, float* __restrict__ lse_part,
                                 int sq, int sk, float scale) {
  using T = WgD512Tile<BK, NBUF, FOLD>;
  constexpr int HALF = BK / 2;  // keys of a warpgroup's S
  constexpr int NS = HALF / 8;  // 8-key column tiles of its S
  constexpr int NO = 32;        // 8-wide column tiles of its 256 columns of O
  constexpr int KP = BK / 16;   // k steps of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [8][64][128 B]
  uint8_t* Ps = Qs + T::ATOMS * T::QATOM;  // [BK / 64][64][128 B]
  uint8_t* ring = Ps + T::PB;               // [NBUF][BK][128 B]
  uint8_t* Ones = ring + NBUF * T::ATOM;    // [8][128 B] of bf16 1.0, FOLD
  float* red_max = reinterpret_cast<float*>(Ones + T::ONES);  // [2][64]
  float* red_l = red_max + 2 * 64;                            // [2][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(red_l + 2 * 64);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NBUF;

  const int q0 = blockIdx.x * T::BQ;
  const int bh = blockIdx.y;
  // split z of gridDim.z runs key tiles [t0, t0 + ntile) of all of them
  const int nall = (sk + BK - 1) / BK, z = blockIdx.z;
  const int t0 = nall * z / gridDim.z, ntile = nall * (z + 1) / gridDim.z - t0;
  auto stage = [&](int pos) { return ring + (pos % NBUF) * T::ATOM; };
  auto parity = [&](int pos) { return (uint32_t)(pos / NBUF) & 1; };

  if constexpr (FOLD) {  // written before the barrier, read by wgmma after it
    for (int i = threadIdx.x; i < T::ONES / 4; i += T::THREADS)
      reinterpret_cast<uint32_t*>(Ones)[i] = kOnesBF16x2;
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, T::ATOMS * T::QATOM);
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load_3d(Qs + a * T::QATOM, &tq, q_full, 64 * a, q0, bh);
      for (int pos = 0; pos < 16 * ntile; ++pos) {
        const int s = pos % NBUF, j = pos % 16;
        if (pos >= NBUF) mbar_wait(empty + s, parity(pos) ^ 1);  // position pos - NBUF read
        mbar_expect_tx(full + s, T::ATOM);
        tma_load_3d(ring + s * T::ATOM, j < 8 ? &tk : &tv, full + s, 64 * (j % 8),
                    (t0 + pos / 16) * BK, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<T::CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;  // rows lane / 4 and lane / 4 + 8 of the warp's 16, columns 2t, 2t + 1
  const int row0 = warp * 16 + lane / 4;  // this thread's rows row0 and row0 + 8 of the tile
  const float c = scale * 1.4426950408889634f;

  float o[NO][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float lf[1][4] = {{0.f, 0.f, 0.f, 0.f}};  // FOLD: the ones n-tile, every column l

  mbar_wait(q_full, 0);
  for (int il = 0; il < ntile; ++il) {
    const int i = t0 + il;  // the key tile; il its place in this CTA's stream
    // S = Q K^T over the 8 K atoms, this warpgroup's half of the keys, each
    // atom released once the group that reads it retires
    if constexpr (BK != 128) {  // waits inside the chain serialized its wgmma here (C7520)
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) mbar_wait(full + (16 * il + a) % NBUF, parity(16 * il + a));
    }
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) {
      const int pos = 16 * il + a;
      if constexpr (BK == 128) mbar_wait(full + pos % NBUF, parity(pos));
      const uint8_t* Ka = stage(pos) + wg * HALF * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, sw128_desc(Qs + a * T::QATOM + 32 * kk), sw128_desc(Ka + 32 * kk),
                 a > 0 || kk > 0);
      wgmma_commit();
      if (a > 0) {
        wgmma_wait<1>();  // the group of atom a - 1 retired
        mbar_arrive(empty + (pos - 1) % NBUF);
      }
    }
    wgmma_wait<0>();
    reg_fence(s);
    mbar_arrive(empty + (16 * il + 7) % NBUF);

    // the mask of keys past Sk, the tile's row maxima over both halves
    if (i * BK + BK > sk) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i * BK + wg * HALF + n * 8 + 2 * t + (j & 1) >= sk) s[n][j] = kNegInf;
    }
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
      if (t == 0) red_max[wg * 64 + row0 + 8 * r] = tm[r];
    }
    named_barrier_sync<1, T::CONSUMERS>();
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // one order in both warpgroups: the same bits
      const float m_new = fmaxf(m[r], fmaxf(red_max[row0 + 8 * r], red_max[64 + row0 + 8 * r]));
      alpha[r] = ex2((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = m_new * c;
    }
    // p rounded to bf16 pairs into this half of P; l over the rounded p
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int col = wg * HALF + n * 8;  // the tile's key of this 8-key group
      uint8_t* Pa = Ps + (col / 64) * T::QATOM;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t pk = pack_bf16(ex2(fmaf(s[n][2 * r], c, -mc[r])),
                                      ex2(fmaf(s[n][2 * r + 1], c, -mc[r])));
        if constexpr (!FOLD)
          rs[r] += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xFFFF0000u);
        const int row = row0 + 8 * r;
        *reinterpret_cast<uint32_t*>(Pa + row * 128 + ((((col % 64) / 8) ^ (row & 7)) << 4) +
                                     4 * t) = pk;
      }
    }
    if constexpr (FOLD) {
      lf[0][0] *= alpha[0]; lf[0][1] *= alpha[0];
      lf[0][2] *= alpha[1]; lf[0][3] *= alpha[1];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    fence_proxy_async();
    named_barrier_sync<1, T::CONSUMERS>();

    // O[:, this half] += P V[:, this half]. A parity wait tells only the
    // last two phases of a stage apart, so every consumer thread sees every
    // phase of every stage: the other half's V atoms are waited on and
    // released too, in stream order around this half's own.
    const int v0 = 16 * il + 8 + 4 * wg;   // position of this half's first V atom
    const int vx = 16 * il + 12 - 4 * wg;  // and of the other half's
    auto pass = [&](int pos) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        mbar_wait(full + (pos + a) % NBUF, parity(pos + a));
        mbar_arrive(empty + (pos + a) % NBUF);
      }
    };
    if (wg == 1) pass(vx);
#pragma unroll
    for (int a = 0; a < 4; ++a) mbar_wait(full + (v0 + a) % NBUF, parity(v0 + a));
    reg_fence(o);
    if constexpr (FOLD) reg_fence(lf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      wgmma_ss_tb(o, sw128_desc(Ps + (kk / 4) * T::QATOM + 32 * (kk % 4)),
                  sw128_desc(stage(v0) + 2048 * kk, T::ATOM), 1);
    if constexpr (FOLD) {
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss(lf, sw128_desc(Ps + (kk / 4) * T::QATOM + 32 * (kk % 4)), sw128_desc(Ones), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if constexpr (FOLD) reg_fence(lf);
#pragma unroll
    for (int a = 0; a < 4; ++a) mbar_arrive(empty + (v0 + a) % NBUF);
    if (wg == 0) pass(vx);
  }

  // finish: l of the row from its four threads and both halves (or its
  // folded column); o = acc / l in bf16 and lse2, or, split, o in f32 and
  // lse2 of this split's keys for the combine pass
  if constexpr (!FOLD) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (t == 0) red_l[wg * 64 + row0 + 8 * r] = l[r];
    }
    named_barrier_sync<1, T::CONSUMERS>();
  }
  const size_t rows = (size_t)gridDim.y * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= sq) continue;
    const float lt = FOLD ? lf[0][2 * r] : red_l[row0 + 8 * r] + red_l[64 + row0 + 8 * r];
    const size_t at = (size_t)bh * sq + row;
    if (gridDim.z == 1) {
      __nv_bfloat16* orow = out + at * 512 + 256 * wg;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * r] / lt, o[n][2 * r + 1] / lt);
      if (wg == 0 && t == 0) lse[at] = m[r] * c + log2f(lt);
    } else {
      float* orow = o_part + (z * rows + at) * 512 + 256 * wg;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
            make_float2(o[n][2 * r] / lt, o[n][2 * r + 1] / lt);
      if (wg == 0 && t == 0) lse_part[z * rows + at] = m[r] * c + log2f(lt);
    }
  }
}


// The combine pass of a split call: per row, lse2 = log2 sum_z 2^lse2_z and
// out = sum_z 2^(lse2_z - lse2) o_z over the splits' f32 partial outputs o_z
// (each normalized by its own l) and lse2_z, rounded to bf16 once. 64
// threads a row, 8 columns each; bound by its bytes (S f32 rows in, a bf16
// row out).
constexpr int kMaxSplits = 4;

__global__ void __launch_bounds__(256)
flash_attn_fwd_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                              int rows, int nsplit) {
  const int row = blockIdx.x * 4 + threadIdx.x / 64, col = threadIdx.x % 64 * 8;
  if (row >= rows) return;
  float lz[kMaxSplits], mx = kNegInf;
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z)
    if (z < nsplit) mx = fmaxf(mx, lz[z] = lse_part[(size_t)z * rows + row]);
  float sum = 0.f;
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z)
    if (z < nsplit) sum += lz[z] = exp2f(lz[z] - mx);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z) {
    if (z >= nsplit) break;
    const float w = lz[z] / sum;
    const float4* op = reinterpret_cast<const float4*>(o_part + ((size_t)z * rows + row) * 512 + col);
    const float4 a = op[0], b = op[1];
    acc[0] += w * a.x; acc[1] += w * a.y; acc[2] += w * a.z; acc[3] += w * a.w;
    acc[4] += w * b.x; acc[5] += w * b.y; acc[6] += w * b.z; acc[7] += w * b.w;
  }
  uint4 packed;
  packed.x = pack_bf16(acc[0], acc[1]);
  packed.y = pack_bf16(acc[2], acc[3]);
  packed.z = pack_bf16(acc[4], acc[5]);
  packed.w = pack_bf16(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(out + (size_t)row * 512 + col) = packed;
  if (col == 0) lse[row] = mx + log2f(sum);
}

// The key splits of a bf16 d = 512 call, each a CTA of its own (1: no
// combine pass, no scratch). One CTA a SM, so a grid of C q-tile CTAs takes
// ceil(C / SMs) waves of one CTA's time; S splits take ceil(C S / SMs) waves
// of 1/S of it. The rule takes the S of 1..4 (and at most the key tiles)
// with the fewest such waves, but splits only where that cuts the waves by a
// fifth or more: each split writes its partial output in f32 and the
// combine pass reads them all back, which lost at the recipe's
// (8, 4800, 512) (600 CTAs, 5 waves, 4.67 at S = 3: 0.83 ms against 0.71)
// and won at (1, 9216, 512) (144 CTAs, 2 waves, 1.25 at S = 4: 0.39 ms
// against 0.53) and (2, 9216, 512) (3 waves, 2.25 at S = 4: 0.70 against
// 0.79) on an H100 (scripts/tune_k1.py).
int d512_splits(int bh, int sq, int sk) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const int ctas = bh * ((sq + 63) / 64), ntile = (sk + 127) / 128;
  const double whole = (double)((ctas + sms - 1) / sms);
  int best = 1;
  double best_t = 0.8 * whole;
  for (int s = 2; s <= kMaxSplits && s <= ntile; ++s) {
    const double t = (double)((ctas * s + sms - 1) / sms) / s;
    if (t <= best_t) best = s, best_t = t;
  }
  return best;
}

// bytes of scratch a bf16 d = 512 call takes: the splits' f32 partial
// outputs and lse2
size_t d512_scratch_bytes(int bh, int sq, int sk) {
  const int n = d512_splits(bh, sq, sk);
  return n == 1 ? 0 : (size_t)n * bh * sq * (512 + 1) * sizeof(float);
}

template <int BK, int NBUF, bool FOLD = false>
cudaError_t launch_wgmma_d512(const void* q, const void* k, const void* v, void* out, float* lse,
                              void* scratch, int bh, int sq, int sk, float scale,
                              cudaStream_t stream) {
  using T = WgD512Tile<BK, NBUF, FOLD>;
  const int nsplit = d512_splits(bh, sq, sk);
  if (nsplit < 1 || nsplit > kMaxSplits || nsplit > (sk + BK - 1) / BK ||
      (nsplit > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  float* o_part = static_cast<float*>(scratch);
  float* lse_part = o_part + (size_t)nsplit * bh * sq * 512;
  CUtensorMap tq, tk, tv;
  if (!(tma_map_bhsd(&tq, q, 512, sq, bh, 64) && tma_map_bhsd(&tk, k, 512, sk, bh, BK) &&
        tma_map_bhsd(&tv, v, 512, sk, bh, BK)))
    return cudaErrorInvalidValue;
  auto kern = flash_attn_fwd_wgmma_d512_kernel<BK, NBUF, FOLD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + T::BQ - 1) / T::BQ, bh, nsplit);
  kern<<<grid, T::THREADS, T::BYTES, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                               lse, o_part, lse_part, sq, sk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int rows = bh * sq;
  flash_attn_fwd_combine_kernel<<<(rows + 3) / 4, 256, 0, stream>>>(
      o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse, rows, nsplit);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out,
                         float* lse, int bh, int sq, int sk, int d, float scale,
                         cudaStream_t stream) {
  switch (d) {
    // <D, row parts, d slices, keys a tile, ring buffers>: the f32 body's
    // two instantiations (its note above)
    case 64:  return launch_f32<64, 4, 1, 64, 3>(q, k, v, out, lse, bh, sq, sk, scale, stream);
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

// K1's bf16 body at d = 512: launch_wgmma_d512<keys a tile, ring stages of
// one 64-column atom>. One tile for every length: 128 keys, 8 stages (64
// keys, whose Q K^T runs m64n32k16, measured 1.5-2x slower: PERF.md).
cudaError_t dispatch_bf16_d512(const void* q, const void* k, const void* v, void* out,
                               float* lse, void* scratch, int bh, int sq, int sk, float scale,
                               cudaStream_t stream) {
  return launch_wgmma_d512<128, 8>(q, k, v, out, lse, scratch, bh, sq, sk, scale, stream);
}

// The CTA tiles (query rows, keys) of the profiling scripts' sweep, each
// with its ring stages; the Python constants D64_TILES and D512_TILES list
// the tiles. d = 64: 64 query rows a consumer warpgroup, the ring holding
// 384 keys at every tile, as K1's <1, 128, 3>. d = 512: 64 query rows, the
// ring 128 KB of atoms, as K1's <128, 8>; key splits and the combine pass by
// K1's rule (d512_splits).
#define GP_D64_TILES(X) X(64, 32, 12) X(64, 64, 6) X(64, 128, 3) X(128, 64, 6) X(128, 128, 3)
#define GP_D512_TILES(X) X(64, 64, 16) X(64, 128, 8)

// S1 (kF32Max), S2 or S4 at d = 64 and tile (bq, bk), the row sum folded
template <int SOFTMAX>
cudaError_t dispatch_s_d64(const void* q, const void* k, const void* v, void* out, float* lse,
                           int bh, int sq, int sk, float scale, int bq, int bk,
                           cudaStream_t stream) {
#define GP_TILE(BQ, BK, NBUF)                                                                   \
  if (bq == BQ && bk == BK)                                                                     \
    return launch_wgmma<BQ / 64, BK, NBUF, SOFTMAX, true>(q, k, v, out, lse, bh, sq, sk, scale, \
                                                          stream);
  GP_D64_TILES(GP_TILE)
#undef GP_TILE
  return cudaErrorInvalidValue;
}

// S1 or S3 at d = 512 and tile (bq, bk), the row sum folded (FOLD) or not
template <bool FOLD>
cudaError_t dispatch_s_d512(const void* q, const void* k, const void* v, void* out, float* lse,
                            void* scratch, int bh, int sq, int sk, float scale, int bq, int bk,
                            cudaStream_t stream) {
#define GP_TILE(BQ, BK, NBUF)                                                               \
  if (bq == BQ && bk == BK)                                                                 \
    return launch_wgmma_d512<BK, NBUF, FOLD>(q, k, v, out, lse, scratch, bh, sq, sk, scale, \
                                             stream);
  GP_D512_TILES(GP_TILE)
#undef GP_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// The f32 body flash_attn_fwd runs, for the record of a run.
extern "C" const char* flash_attn_fwd_f32_body() {
  return "split TF32: 3xTF32 mma.sync m16n8k8, cp.async K/V ring, per-tile P.V accumulators";
}

// The bf16 body it runs at d = 64 (dispatch_bf16_d64).
extern "C" const char* flash_attn_fwd_bf16_body() {
  return "wgmma m64nNk16, TMA K/V ring, BQ 64 x BK 128";
}

// The bf16 body it runs at d = 512 (dispatch_bf16_d512).
extern "C" const char* flash_attn_fwd_bf16_d512_body() {
  return "wgmma m64nNk16, two consumer warpgroups, TMA ring of 64-column K/V atoms, "
         "BQ 64 x BK 128";
}

// Bytes of scratch flash_attn_fwd takes for these arguments (0: none); so
// does flash_attn_fwd_tiled at d = 512, whose key splits follow the same rule.
extern "C" long long flash_attn_fwd_scratch_bytes(int bh, int sq, int sk, int d, int dtype) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  return dtype == 1 && d == 512 ? (long long)d512_scratch_bytes(bh, sq, sk) : 0;
}

// q: (bh, sq, d), k/v: (bh, sk, d), out: (bh, sq, d), all contiguous and of
// one dtype (0 = float32, 1 = bfloat16); lse: (bh, sq) float32; scratch:
// flash_attn_fwd_scratch_bytes of device memory, 16-byte aligned (or null
// where that is 0).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, void* scratch, int bh, int sq, int sk,
                              int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_f32(q, k, v, out, l, bh, sq, sk, d, scale, s);
  if (dtype == 1 && d == 64) return (int)dispatch_bf16_d64(q, k, v, out, l, bh, sq, sk, scale, s);
  if (dtype == 1 && d == 512)
    return (int)dispatch_bf16_d512(q, k, v, out, l, scratch, bh, sq, sk, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The same function, bf16 only, with a caller-chosen CTA tile: bq query rows
// by bk keys per step, and the row sum folded into PV (fold = 1) or summed
// apart (0), on K1's bodies. The instantiated sets (GP_D64_TILES,
// GP_D512_TILES; the Python constants D64_TILES and D512_TILES list them):
// d = 64 with fold = 1 at (64, 32), (64, 64), (64, 128), (128, 64), (128,
// 128); d = 512 with either fold at (64, 64), (64, 128). Any other set
// returns cudaErrorInvalidValue. Arguments as flash_attn_fwd's; scratch as
// flash_attn_fwd_scratch_bytes(bh, sq, sk, d, 1) gives it. At d = 512,
// (64, 128) without the fold is K1's own launch.
extern "C" int flash_attn_fwd_tiled(const void* q, const void* k, const void* v,
                                    void* out, void* lse, void* scratch, int bh, int sq, int sk,
                                    int d, float scale, int bq, int bk, int fold,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (d == 64 && fold == 1)
    return (int)dispatch_s_d64<kF32Max>(q, k, v, out, l, bh, sq, sk, scale, bq, bk, s);
  if (d == 512 && fold == 1)
    return (int)dispatch_s_d512<true>(q, k, v, out, l, scratch, bh, sq, sk, scale, bq, bk, s);
  if (d == 512 && fold == 0)
    return (int)dispatch_s_d512<false>(q, k, v, out, l, scratch, bh, sq, sk, scale, bq, bk, s);
  return (int)cudaErrorInvalidValue;
}

// S2 and S4 (the file header): q: (bh, sq, 64), k/v: (bh, sk, 64), out:
// (bh, sq, 64), all bf16 and contiguous; no lse. (bq, bk) is one of the
// d = 64 tiles above (D64_TILES); any other returns cudaErrorInvalidValue.
extern "C" int flash_bf16_softmax(const void* q, const void* k, const void* v, void* out,
                                  int bh, int sq, int sk, int d, float scale, int bq, int bk,
                                  void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != 64) return (int)cudaErrorInvalidValue;
  return (int)dispatch_s_d64<kBf16Chain>(q, k, v, out, nullptr, bh, sq, sk, scale, bq, bk,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int flash_nomax(const void* q, const void* k, const void* v, void* out, int bh,
                           int sq, int sk, int d, float scale, int bq, int bk, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != 64) return (int)cudaErrorInvalidValue;
  return (int)dispatch_s_d64<kNoMax>(q, k, v, out, nullptr, bh, sq, sk, scale, bq, bk,
                                     static_cast<cudaStream_t>(stream));
}
