// W8A8 conv3x3 (stride 1, zero padding 1) with the input quantized in the
// kernel, for Hopper (sm_90a); f32 or bf16 in and out, NCHW.
//
// Replaces the TPU kernel genpercept_tpu/ops/quant_conv.py::_kernel (reached
// through quantized_conv3x3). Symmetric per-input-channel quantization, as
// the TPU kernel:
//   code = clip(rint(x * inv_a[c]), -127, 127)     int8; 0 outside the image
//   acc  = sum over taps and channels of code * w   int32, exact
//   out  = acc * o_scale[co] + bias[co]             f32, each step rounded
//                                                   once, then cast to T
// Every f32 step is one rounded operation (__fmul_rn / __fadd_rn: no FMA
// contraction), as the plain version (ops/quant.py::qconv_apply) computes it
// op by op, and the int32 sums are exact in any order: the kernel is
// bit-identical to its plain version.
//
// What bounds it on the card: 2*9*H*W*C*Co int8 operations per image; at the
// 768^2@128 VAE level (batch 2) 347.9 G, 0.176 ms at 1,979 TOPS, against
// 0.180 ms for its bf16 input and output at 3.35 TB/s: bytes bound at C = 128
// (the contraction is shallow), operations bound at C = 512. Beside them sit
// the quantize (a multiply, a clamp and a rounding on the CUDA cores for
// every staged value, and a tile stages its halo again for each block of
// output channels) and the weights' L2 traffic (a pixel tile reads all 9 C
// Co of them: 1.36 GB a call at each deep level with 128-pixel tiles).
//
// Design (qconv_wgmma_kernel<T, BN, MB>): the implicit GEMM of K8's bf16 body
// (fused_gn_silu_conv3x3.cu) on int8 wgmma; M = output pixels, N = Co,
// K = 9 C, in chunks of 64 input channels (two k steps of 32 a tap).
//   - Tiles: 8 x 16 pixels x 256 output channels (MB 1), 16 x 16 x 128 where
//     Co is no multiple of 256 (MB 2: the 768^2 level's Co = 128), 8 x 16 x
//     160 where Co is a multiple of 160 only (the UNet's level-0 320), else
//     16 x 16 x 64. A tile stages its halo once for BN output channels (the
//     first body staged it once for every 64), and each of two consumer
//     warpgroups holds at most 128 int32 sums a thread (MB m blocks of
//     wgmma m64nBNk32).
//   - A, the codes, comes from registers: a tap's shift is a one-pixel
//     offset into the staged halo, which a shared-memory descriptor cannot
//     express, so each warp loads its fragments by ldmatrix (the mma.sync
//     m16n8k32 A layout, which int8 wgmma takes from registers). B, the
//     weights, from a TMA ring of up to 6 slots, one tap of one chunk each
//     (BN rows of 64 int8 in the 64-byte swizzle; the wrapper lays the
//     weights out as (9, Co, C) once a call).
//   - 2-CTA clusters: the two CTAs of a cluster take neighbouring pixel
//     tiles of the same output channels and walk their chunks in step; each
//     weight slot is loaded by one of them (alternately) into both by
//     multicast and released by the consumer warps of both. That halves the
//     weights read from L2: 0.68 GB a deep-level call, 0.34 at 768^2@128
//     with its 256-pixel tiles (one CTA a ring: 14-28% slower; 4-CTA
//     clusters: no faster, PERF.md). An odd count of pixel tiles leaves the
//     last cluster's second CTA its partner's tile to compute again and not
//     store.
//   - Staging: a producer warpgroup. Warp 0 issues the weight taps and each
//     unit's o_scale and bias (bulk copies into a ring of two). Warps 1-3
//     quantize each chunk's halo from raw x that TMA brings into a ring of
//     two slots of 32 channels (boxes of 32 channels x (TH + 2) rows x 32
//     bf16 or 24 f32 columns from (w0 - 8 or w0 - 4, h0 - 1): a box's first
//     column on a 16-byte boundary, else an illegal instruction): per value
//     a multiply, the clamp to +-127 and a rounding by adding 1.5 * 2^23 (the
//     f32 grid is then the integers: rint's ties to even, no conversion
//     instruction), whose low byte is the code. Codes of pixels outside the
//     image are 0 by position: TMA's zero fill alone would give code 0 only
//     for a finite inv_a (0 * inf is NaN). They store 16-byte units of 16
//     codes, XOR-swizzled by the pixel (conflict-free for the stores and for
//     ldmatrix at every tap offset), into a ring of two A slots.
//   - A chunk is 9 taps x 2 k steps: wgmma groups of one tap (one commit
//     each); a tap's A fragments load while the tap before it is on the
//     tensor cores, and its weight slot is released once its group retires.
//     The stage is straight-line code (ptxas serializes every wgmma where it
//     is not, C7514/C7520): waits trap instead of hanging, and the release to
//     both CTAs is predicated, not branched. One int32 accumulator over all
//     of K: exact in any order.
//   - Epilogue: acc * o_scale + bias in f32, one cast to T. bf16: each warp
//     puts its tile rows into shared memory in the 32-byte swizzle
//     (stmatrix.trans) and sends them after the next tile's first chunk, 16
//     bytes a lane (a warp's store: 16 whole 32-byte runs of NCHW rows);
//     nothing waits for the stores. The first chunk of a tile is its own
//     copy of the chain: sent at once from the plain chunk loop the rows cost
//     0.44 against 0.38 ms (384^2@256, batch 2, PERF.md), sent at once beside
//     the peeled chunk about the same as now. TMA stores need a wait on their
//     reads of shared memory: in the consumers it made ptxas serialize every
//     wgmma (C7512), at the head of a tile it waited out each tile's stores,
//     and in stager 0 it slowed the staging. f32: each thread stores its
//     values, a warp writing whole 32-byte sectors (8 pixels of 4 channels);
//     staged rows would take the shared memory the raw ring holds.
//   - Nothing runs after the consumers' walk: code there (a wait for stores,
//     the last tile's sends) made ptxas serialize every wgmma (C7512), as in
//     K2's wide body; the last tile's rows go out inside it.
//   - A persistent grid of the clusters that fit (cudaOccupancyMax
//     ActiveClusters) walks (pixel-tile pair, channel block) units, the
//     channel blocks of a pair one after the other, so its x stays in L2.
//   - Registers: 168 at launch; setmaxnreg leaves the producer 88 and gives
//     the consumers 208.
// Fixed order of sums, no atomics: two calls give the same bits.
// Not kept: int8 mma.sync m16n8k32 over 8 x 16-pixel tiles of 64 output
// channels with all 256 threads staging, then all multiplying (the first
// body); deeper weight or raw rings, which shared memory allows only beside
// fewer of the other (no faster, PERF.md).
//
// Weight layout (prepared by the wrapper): (9, Co, C) int8, each tap's
// (Co, C) slice, input channels contiguous.

#include "common.cuh"

namespace {

using namespace gp;

constexpr int TW = 16;            // tile columns
constexpr int HC = TW + 2;        // halo columns
constexpr int KC = 64;            // input channels a chunk: 64 codes a pixel, two k steps
constexpr int kPiece = 32;        // input channels a raw box: half a chunk
constexpr int kMaxRaw = 2;        // raw boxes in flight, where shared memory allows
constexpr int kMinNB = 4;         // weight slots kept before the raw ring deepens
constexpr int kStagers = 96;      // producer warps 1-3 quantize the halo
constexpr int kCL = 2;            // CTAs a cluster, sharing every weight tap
constexpr int kMaxNB = 6;         // weight slots, where shared memory allows
constexpr int kConsumers = 256;   // two warpgroups of 64 MB pixels
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kSmem = 232448;     // shared memory of a CTA

// the weight slots that fit beside `base` bytes and `raw` raw slots
constexpr int weight_slots(int base, int raw_bytes, int b_bytes, int raw) {
  return (kSmem - base - raw * (raw_bytes + 8)) / (b_bytes + 16);
}

// the raw slots: up to kMaxRaw, as long as kMinNB weight slots fit beside them
constexpr int raw_slots(int base, int raw_bytes, int b_bytes) {
  int r = kMaxRaw;
  while (r > 2 && weight_slots(base, raw_bytes, b_bytes, r) < kMinNB) --r;
  return r;
}

template <typename T, int BN_, int MB_>
struct QConvTile {
  static constexpr int BN = BN_, MB = MB_;                // output channels, m blocks a warpgroup
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int TH = 8 * MB;                       // tile rows of TW columns
  static constexpr int HR = TH + 2;                       // halo rows
  static constexpr int NPIX = HR * HC;                    // halo pixels
  static constexpr int PIECE_ITEMS = 2 * NPIX;            // 16-byte units of a raw box's codes
  static constexpr int STAGE_ITEMS = (PIECE_ITEMS + kStagers - 1) / kStagers;  // a stager's
  static constexpr int A_BYTES = NPIX * KC;               // a chunk's codes of the halo
  static constexpr int RAW_W = F32 ? 24 : 32;             // raw box columns from w0 - RAW_X0
  static constexpr int RAW_X0 = F32 ? 4 : 8;
  static constexpr int RAW_BYTES = kPiece * HR * RAW_W * (int)sizeof(T);
  static constexpr int B_BYTES = BN * KC;                 // a weight slot: one tap, BN rows
  static constexpr int NOUT = F32 ? 0 : 8 * MB;           // bf16 output buffers: MB a warp
  static constexpr int OUT_BYTES = BN * TW * 2;           // one tile row, all BN channels
  static constexpr int VEC_BYTES = 2 * BN * 4;             // a unit's o_scale and bias
  static constexpr int BASE =
      1024 + NOUT * OUT_BYTES + 2 * A_BYTES + 2 * VEC_BYTES + 8 * 16 /* sends */ + 8 * 8;
  static constexpr int RAW = raw_slots(BASE, RAW_BYTES, B_BYTES);  // raw slots
  static constexpr int FIXED = BASE + RAW * (RAW_BYTES + 8);
  static constexpr int FIT = weight_slots(BASE, RAW_BYTES, B_BYTES, RAW);
  static constexpr int NB = FIT < kMaxNB ? FIT : kMaxNB;  // weight slots
  static constexpr int BYTES = FIXED + NB * (B_BYTES + 16);
  // setmaxnreg as K8's bf16 body: 168 at launch, the producer keeps 88, the
  // consumers take what it frees (208: 128 sums, two buffers of A fragments)
  static constexpr int REGS = 65536 / kThreads / 8 * 8;
  static constexpr int PRODUCER_REGS = 88;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) / 2 / 8 * 8;
  static_assert(MB * BN <= 256 && (BN == 64 || BN == 128 || BN == 160 || BN == 256),
                "at most 128 int32 sums a consumer thread, a wgmma width");
  static_assert(NB >= 2 && BYTES <= kSmem, "the weight ring and shared memory of a CTA");
  static_assert(B_BYTES % 1024 == 0 && (2 * A_BYTES) % 128 == 0 && RAW_BYTES % 128 == 0,
                "the swizzled slots' and the TMA boxes' alignment");
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
  static_assert(128 * PRODUCER_REGS + kConsumers * CONSUMER_REGS <= kThreads * REGS,
                "the registers the producer frees");
};

// unit v of the walk, for the CTA of rank `rank` in its cluster: output
// channels (v % cblocks) BN.. of pixel tile kCL (v / cblocks) + rank (TH x
// TW pixels, columns first, then rows, then images). Past the last tile (an
// odd count) the CTA takes the last tile's inputs and stores nothing.
template <int BN, int TH>
struct QTileOf {
  int n, co0, h0, w0;
  bool store;
  __device__ QTileOf(int v, int rank, int cblocks, int tiles_w, int tiles_h, int ntiles) {
    co0 = (v % cblocks) * BN;
    int px = (v / cblocks) * kCL + rank;
    store = px < ntiles;
    if (!store) px = ntiles - 1;
    w0 = (px % tiles_w) * TW;
    px /= tiles_w;
    h0 = (px % tiles_h) * TH;
    n = px / tiles_h;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// clip(rint(v * inv_a), -127, 127) as f32 bits whose low byte is the int8
// code: the clamp first (rint is monotonic and the bounds are whole), then
// rint by adding 1.5 * 2^23, where the f32 grid is the integers (ties to
// even, as rintf), without the conversion pipe
__device__ __forceinline__ uint32_t code_bits(float v, float inv_a) {
  const float q = fminf(fmaxf(__fmul_rn(v, inv_a), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// the low bytes of four code_bits, lowest channel in the low byte
__device__ __forceinline__ uint32_t pack_codes4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <typename T, int BN, int MB>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
qconv_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                   const float* __restrict__ inv_a,
                   const float* __restrict__ o_scale, const float* __restrict__ bias,
                   T* __restrict__ out, int C, int Co, int H, int W, int tiles_w, int tiles_h,
                   int ntiles, int nunits) {
  using Q = QConvTile<T, BN, MB>;
  using Tile = QTileOf<BN, Q::TH>;
  constexpr int NB = Q::NB;
  extern __shared__ uint8_t smem_raw[];
  // [NB][BN][64 B] in the 64-byte swizzle, 1024-byte aligned (the same offset
  // in both CTAs of the cluster: the multicast writes there)
  uint8_t* bs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* os = bs + NB * Q::B_BYTES;          // bf16: [NOUT][BN][32 B] in the 32-byte swizzle
  uint8_t* as = os + Q::NOUT * Q::OUT_BYTES;   // [2][NPIX][64 B]
  uint8_t* rs = as + 2 * Q::A_BYTES;           // [RAW][32][HR][RAW_W] raw x
  float* vs = reinterpret_cast<float*>(rs + Q::RAW * Q::RAW_BYTES);  // [2][o_scale, bias][BN]
  int* sends = reinterpret_cast<int*>(vs + 2 * 2 * BN);  // [8 warps][plane, row, w0, -]
  uint64_t* a_full = reinterpret_cast<uint64_t*>(sends + 8 * 4);
  uint64_t* a_empty = a_full + 2;
  uint64_t* raw_full = a_empty + 2;
  uint64_t* b_full = raw_full + Q::RAW;
  uint64_t* b_empty = b_full + NB;
  uint64_t* vec_full = b_empty + NB;
  uint64_t* vec_empty = vec_full + 2;
  const int chunks = C / KC, cblocks = Co / BN;
  const int rank = (int)blockIdx.x % kCL, ci = (int)blockIdx.x / kCL;
  const int nclusters = (int)gridDim.x / kCL;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(a_full + s, kStagers);
      mbar_init(a_empty + s, kConsumers);
    }
    for (int s = 0; s < Q::RAW; ++s) mbar_init(raw_full + s, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(vec_full + s, 1);
      mbar_init(vec_empty + s, kConsumers / 32);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(b_full + s, 1);
      mbar_init(b_empty + s, kConsumers / 32 * kCL);  // every consumer warp of the cluster
    }
    fence_mbarrier_init();
  }
  cluster_sync();  // every CTA's barriers set before any CTA reaches another's

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    setmaxnreg_dec<Q::PRODUCER_REGS>();
    const int ptid = threadIdx.x - kConsumers;
    if (ptid < 32) {
      // warp 0: the weights, one tap of one chunk a slot. Slot q of the ring
      // is loaded by the cluster's CTA of rank q % kCL into every CTA's slot
      // (multicast), once every consumer warp of the cluster has released it;
      // each CTA counts the bytes on its own full barrier.
      if (ptid == 0) {
        const uint16_t all = (uint16_t)((1u << kCL) - 1);
        int qb = 0, qu = 0;
        for (int v = ci; v < nunits; v += nclusters, ++qu) {
          const int co0 = (v % cblocks) * BN;
          // the unit's o_scale and bias, for its epilogue, into a ring of two
          const int sv = qu % 2;
          if (qu >= 2) mbar_wait_or_trap(vec_empty + sv, (qu / 2 - 1) & 1);
          mbar_expect_tx(vec_full + sv, Q::VEC_BYTES);
          bulk_load(vs + sv * 2 * BN, o_scale + co0, 4 * BN, vec_full + sv);
          bulk_load(vs + sv * 2 * BN + BN, bias + co0, 4 * BN, vec_full + sv);
          for (int ch = 0; ch < chunks; ++ch)
            for (int tap = 0; tap < 9; ++tap, ++qb) {
              const int s = qb % NB;
              if (qb >= NB) mbar_wait_or_trap(b_empty + s, (qb / NB - 1) & 1);
              mbar_expect_tx(b_full + s, Q::B_BYTES);
              if (qb % kCL == rank)
                tma_load_3d_mc(bs + s * Q::B_BYTES, &tw, b_full + s, ch * KC, co0, tap, all);
            }
        }
        // the last releases: no consumer of the cluster arrives on this CTA's
        // barriers, and no load writes into it, once this thread leaves
        for (int q = qb > NB ? qb - NB : 0; q < qb; ++q)
          mbar_wait_or_trap(b_empty + q % NB, (q / NB) & 1);
      }
      return;
    }
    // warps 1-3: the codes of each chunk's halo, from its raw x, which TMA
    // brings into a ring of two slots, one a half chunk (piece): once every
    // stager has read a piece, stager 0 asks for the one two pieces on (qr:
    // the CTA's pieces in walk order; piece qr is half qr % 2 of chunk qr / 2,
    // in slot qr % 2). A piece's codes are 2 NPIX 16-byte units (16 channels
    // of a pixel): unit kk of pixel p is item kk NPIX + p, stager sid takes
    // items sid + 96 m, a warp's lanes consecutive pixels of one unit. For
    // each it reads the 16 raw values, quantizes them, zeroes a pixel
    // outside the image and stores unit k = 2 half + kk at index k ^ ((p >>
    // 1) & 3) of pixel p: eight consecutive pixels of one unit lie in eight
    // distinct bank groups, for these stores and for the consumers'
    // ldmatrix at every tap offset.
    const int sid = ptid - 32;
    auto load_raw = [&](int qr) {
      const int q = qr / 2;
      const int v = ci + q / chunks * nclusters;
      if (v >= nunits) return;
      const Tile tile(v, rank, cblocks, tiles_w, tiles_h, ntiles);
      const int r = qr % Q::RAW;
      mbar_expect_tx(raw_full + r, Q::RAW_BYTES);
      tma_load_3d(rs + r * Q::RAW_BYTES, &tx, raw_full + r, tile.w0 - Q::RAW_X0, tile.h0 - 1,
                  tile.n * C + (q % chunks) * KC + (qr % 2) * kPiece);
    };
    if (sid == 0)
      for (int qr = 0; qr < Q::RAW; ++qr) load_raw(qr);
    int qa = 0;
    for (int v = ci; v < nunits; v += nclusters) {
      const Tile tile(v, rank, cblocks, tiles_w, tiles_h, ntiles);
      for (int ch = 0; ch < chunks; ++ch, ++qa) {
        const int s = qa % 2;
        if (qa >= 2) mbar_wait_or_trap(a_empty + s, (qa / 2 - 1) & 1);
        uint8_t* As = as + s * Q::A_BYTES;
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const int qr = 2 * qa + half, r = qr % Q::RAW;
          mbar_wait_or_trap(raw_full + r, (qr / Q::RAW) & 1);
          const T* raw = reinterpret_cast<const T*>(rs + r * Q::RAW_BYTES);
#pragma unroll 2
          for (int m = 0; m < Q::STAGE_ITEMS; ++m) {
            const int item = sid + kStagers * m;
            if (item >= Q::PIECE_ITEMS) break;
            const int kk = item / Q::NPIX, p = item - kk * Q::NPIX;
            const int k = 2 * half + kk;  // the unit of the chunk: channels 16 k..
            const float4* ia4 = reinterpret_cast<const float4*>(inv_a + ch * KC + 16 * k);
            const int hr = p / HC, hc = p - hr * HC;
            const int gy = tile.h0 + hr - 1, gx = tile.w0 + hc - 1;
            // code 0 outside the image, as the TPU kernel pads the codes
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const T* src = raw + (16 * kk * Q::HR + hr) * Q::RAW_W + hc + Q::RAW_X0 - 1;
            uint32_t word[4];
#pragma unroll
            for (int j4 = 0; j4 < 4; ++j4) {
              const float4 ia = __ldg(ia4 + j4);
              const float* iav = reinterpret_cast<const float*>(&ia);
              uint32_t b[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                b[i] = code_bits(to_f32(src[(4 * j4 + i) * Q::HR * Q::RAW_W]), iav[i]);
              word[j4] = inside ? pack_codes4(b[0], b[1], b[2], b[3]) : 0u;
            }
            *reinterpret_cast<uint4*>(As + p * KC + ((k ^ ((p >> 1) & 3)) << 4)) =
                make_uint4(word[0], word[1], word[2], word[3]);
          }
          named_barrier_sync<1, kStagers>();  // every stager has read the piece
          if (sid == 0) {
            fence_proxy_async();
            load_raw(qr + Q::RAW);
          }
        }
        mbar_arrive(a_full + s);  // release: the consumers' loads see these stores
      }
    }
    return;
  }
  setmaxnreg_inc<Q::CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // consumer warpgroup wg takes tile rows 4 MB wg .. 4 MB wg + 4 MB - 1, m
  // block mb its rows 4 mb..4 mb + 3 as wgmma's 64 rows, warp w row 4 mb + w
  // (its 16 columns: fragment rows g and g + 8). This lane's ldmatrix row
  // of an A fragment: column lane % 8 + 8 (lane / 8 % 2) of the warp's row,
  // 16-byte unit lane / 16 of the k step's two.
  const int pbase = (4 * MB * wg + warp) * HC + lane % 8 + 8 * (lane / 8 % 2);
  const int khalf = lane / 16;
  // bf16: this warp's output buffers, one a tile row (m block)
  uint8_t* ob = os + (wg * 4 + warp) * MB * Q::OUT_BYTES;

  int acc[MB][BN / 8][4];
  uint32_t af[2][2][MB][4];  // two buffers of one tap's A: [k step][m block]
  int qa = 0, qb = 0, qu = 0;

  // A fragments of tap `tap` from an A slot: for each k step and m block,
  // pixel columns g and g + 8 of the tap's shifted window, codes 4t.. and
  // 16 + 4t.. of the k step
  auto load_tap = [&](const uint8_t* As, int tap, uint32_t (&f)[2][MB][4]) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int p = pbase + (4 * mb + tap / 3) * HC + tap % 3;
        const int unit = 2 * ks + khalf;
        ldsm_x4(As + p * KC + ((unit ^ ((p >> 1) & 3)) << 4), f[ks][mb]);
      }
  };
  auto fence_af = [&](uint32_t (&f)[2][MB][4]) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) reg_fence(f[ks]);
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) reg_fence(acc[mb]);
  };

  // bf16: the last stored tile's rows wait in the warp's output buffers
  // unless `sent`; where they go (channel plane: image and first channel;
  // the warp's row of m block 0; the first column) waits in shared memory
  bool sent = true;
  int* dest = sends + 4 * (wg * 4 + warp);
  // the rows out, 16 bytes a lane: 8 pixels of one channel, a warp's store
  // 16 whole 32-byte runs of the output rows (NCHW)
  auto send = [&]() {
    const int plane = dest[0], row = dest[1], w0 = dest[2];
#pragma unroll 4
    for (int q = 0; q < MB * BN / 16; ++q) {
      const int u = 32 * q + lane, mb = u / (2 * BN), co = u / 2 % BN;
      const int hh = (u % 2) ^ ((co >> 2) & 1);  // the 16-byte half: pixels 8 hh..
      const int gy = row + 4 * mb;
      const uint4 val = *reinterpret_cast<const uint4*>(ob + 16 * u);
      if (gy < H && w0 + 8 * hh < W)  // W is a multiple of 8
        *reinterpret_cast<uint4*>(out + ((size_t)(plane + co) * H + gy) * W + w0 + 8 * hh) = val;
    }
  };

  // one chunk: straight-line from its first wgmma to its last wait
  auto chunk = [&]() {
    const int sa = qa % 2;
    mbar_wait_or_trap(a_full + sa, (qa / 2) & 1);
    const uint8_t* As = as + sa * Q::A_BYTES;
    load_tap(As, 0, af[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int s = (qb + tap) % NB;
      mbar_wait_or_trap(b_full + s, ((qb + tap) / NB) & 1);
      const uint64_t db = sw64_desc(bs + s * Q::B_BYTES) + opaque(0);
      fence_acc();
      fence_af(af[tap % 2]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)  // 32 bytes a k step: 2 16-byte units
          wgmma_s8_rs(acc[mb], af[tap % 2][ks][mb], db + 2 * ks, 1);
      wgmma_commit();
      if (tap > 0) {
        wgmma_wait<1>();  // tap - 1 retired: its A buffer and its weight slot
        fence_af(af[(tap + 1) % 2]);
        mbar_arrive_cluster_lane0<kCL>(b_empty + (qb + tap - 1) % NB);
      }
      if (tap < 8) load_tap(As, tap + 1, af[(tap + 1) % 2]);
    }
    wgmma_wait<0>();
    fence_acc();
    fence_af(af[0]);
    fence_af(af[1]);
    mbar_arrive_cluster_lane0<kCL>(b_empty + (qb + 8) % NB);
    mbar_arrive(a_empty + sa);
    ++qa;
    qb += 9;
  };

  for (int v = ci; v < nunits; v += nclusters, ++qu) {
    const Tile tile(v, rank, cblocks, tiles_w, tiles_h, ntiles);
    const int row0 = tile.h0 + 4 * MB * wg + warp;  // the warp's tile row of m block 0
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) acc[mb][n][0] = acc[mb][n][1] = acc[mb][n][2] = acc[mb][n][3] = 0;

    // the last stored tile's rows go out after this one's first chunk, a
    // copy of the chain of its own (see the header)
    chunk();
    if (!sent) send();
    sent = true;
    for (int ch = 1; ch < chunks; ++ch) chunk();
    // acc * o_scale + bias, each step rounded in f32, one cast to T; the
    // unit's o_scale and bias from the producer's ring, released by each warp
    const int sv = qu % 2;
    const float* vsc = vs + sv * 2 * BN;
    const float* vbb = vsc + BN;
    mbar_wait_or_trap(vec_full + sv, (qu / 2) & 1);
    const size_t hw = (size_t)H * W;
    if (!tile.store) {
    } else if constexpr (Q::F32) {
      // whole 32-byte sectors: a warp's store is 8 pixels of 4 channels
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int gy = row0 + 4 * mb;
        if (gy >= H) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gx = tile.w0 + g + 8 * r;
          if (gx >= W) continue;
          float* o = out + ((size_t)tile.n * Co + tile.co0) * hw + (size_t)gy * W + gx;
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) {
            const float2 sc = *reinterpret_cast<const float2*>(vsc + 8 * nt + 2 * t);
            const float2 bb = *reinterpret_cast<const float2*>(vbb + 8 * nt + 2 * t);
            o[(size_t)(8 * nt + 2 * t) * hw] = dequant(acc[mb][nt][2 * r], sc.x, bb.x);
            o[(size_t)(8 * nt + 2 * t + 1) * hw] = dequant(acc[mb][nt][2 * r + 1], sc.y, bb.y);
          }
        }
      }
    } else {
      // Each tile row of the warp goes into a buffer of [BN channels][16
      // columns] in the 32-byte swizzle (16-byte half h of channel co at h ^
      // (co >> 2 & 1)) by stmatrix.trans, a 16-channel pair of n tiles at a
      // time; the rows go out during the next tile's first chunk (send), or
      // after the walk. Nothing waits for the stores.
      __syncwarp();  // the last rows are sent
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        uint8_t* o = ob + mb * Q::OUT_BYTES;
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          const int co = 16 * np + 8 * (lane / 16) + lane % 8;
          uint32_t vv[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {  // n tile 2 np + j: fragment rows g, then g + 8
            const int nt = 2 * np + j;
            const float2 sc = *reinterpret_cast<const float2*>(vsc + 8 * nt + 2 * t);
            const float2 bb = *reinterpret_cast<const float2*>(vbb + 8 * nt + 2 * t);
            vv[2 * j] = pack_bf16(dequant(acc[mb][nt][0], sc.x, bb.x),
                                  dequant(acc[mb][nt][1], sc.y, bb.y));
            vv[2 * j + 1] = pack_bf16(dequant(acc[mb][nt][2], sc.x, bb.x),
                                      dequant(acc[mb][nt][3], sc.y, bb.y));
          }
          stsm_x4_trans(o + co * 32 + ((((lane / 8) & 1) ^ ((co >> 2) & 1)) << 4), vv);
        }
      }
      if (lane == 0) {
        dest[0] = tile.n * Co + tile.co0;
        dest[1] = row0;
        dest[2] = tile.w0;
      }
      __syncwarp();
      sent = false;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(vec_empty + sv);
    // the last tile's rows, inside the walk: code after it made ptxas
    // serialize every wgmma (C7512), as in K2's wide body
    if (!sent && v + nclusters >= nunits) send();
  }
}

// the clusters of the body that fit on the card at once (a cluster's CTAs
// share a GPC)
template <typename T, int BN, int MB>
int qconv_max_clusters() {
  using Q = QConvTile<T, BN, MB>;
  static const int clusters = [] {
    auto kern = qconv_wgmma_kernel<T, BN, MB>;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCL);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Q::BYTES;
    int n = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::BYTES) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    if (n > 0) return n;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms / kCL > 0 ? sms / kCL : 1;
  }();
  return clusters;
}

// x through a 3-D tensor map over (W, H, N C); the weights, laid out by the
// wrapper as (9, Co, C), through one over (C, Co, 9) in boxes of (64, BN, 1),
// the 64-byte swizzle
template <typename T, int BN, int MB>
cudaError_t launch(const T* x, const float* inv_a, const int8_t* wt, const float* o_scale,
                   const float* bias, T* out, int n, int c, int co, int h, int wd,
                   cudaStream_t s) {
  using Q = QConvTile<T, BN, MB>;
  constexpr size_t e = sizeof(T);
  constexpr CUtensorMapDataType dt =
      Q::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tw, tx;
  const cuuint64_t wdims[3] = {(cuuint64_t)c, (cuuint64_t)co, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)c, (cuuint64_t)co * c};
  const cuuint32_t wbox[3] = {KC, (cuuint32_t)BN, 1};
  const cuuint64_t xdims[3] = {(cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n * c};
  const cuuint64_t pstrides[2] = {(cuuint64_t)wd * e, (cuuint64_t)h * wd * e};
  const cuuint32_t xbox[3] = {Q::RAW_W, Q::HR, kPiece};
  if (!tma_map(&tw, wt, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !tma_map(&tx, x, 3, xdims, pstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE, dt))
    return cudaErrorInvalidValue;
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + Q::TH - 1) / Q::TH;
  const long long ntiles = (long long)n * tiles_h * tiles_w;
  const long long nunits = (ntiles + kCL - 1) / kCL * (co / BN);
  if (nunits > (1LL << 30)) return cudaErrorInvalidValue;
  auto kern = qconv_wgmma_kernel<T, BN, MB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::BYTES);
  if (err != cudaSuccess) return err;
  const int maxc = qconv_max_clusters<T, BN, MB>();
  const int clusters = nunits < maxc ? (int)nunits : maxc;
  kern<<<clusters * kCL, kThreads, Q::BYTES, s>>>(tw, tx, inv_a, o_scale, bias, out, c, co,
                                                  h, wd, tiles_w, tiles_h, (int)ntiles,
                                                  (int)nunits);
  return cudaGetLastError();
}

// the tile for Co: (BN, MB) as ops/quant_conv.py::_tiling gives it
template <typename T>
cudaError_t launch_for(const void* x, const float* ia, const int8_t* w8, const float* os,
                       const float* fb, void* out, int n, int c, int co, int h, int wd,
                       cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (co % 256 == 0) return launch<T, 256, 1>(xt, ia, w8, os, fb, ot, n, c, co, h, wd, s);
  if (co % 128 == 0) return launch<T, 128, 2>(xt, ia, w8, os, fb, ot, n, c, co, h, wd, s);
  if (co % 160 == 0) return launch<T, 160, 1>(xt, ia, w8, os, fb, ot, n, c, co, h, wd, s);
  return launch<T, 64, 2>(xt, ia, w8, os, fb, ot, n, c, co, h, wd, s);
}

}  // namespace

// The body, as chip_smoke.py, the card tests and scripts/tune_k7.py name it.
extern "C" const char* quantized_conv3x3_body() {
  return "int8 wgmma m64nNk32 (A from registers): 8x16-pixel tiles of 256 output channels "
         "(16x16 of 128, 8x16 of 160, 16x16 of 64 where Co is no multiple of 256), a producer "
         "warpgroup quantizing the halo once a tile from TMA boxes of raw x, a TMA ring of weight "
         "taps shared by a 2-CTA cluster (multicast), one int32 accumulator";
}

// x: (n, c, h, w) and out: (n, co, h, w), of one dtype (0 = float32,
// 1 = bfloat16), contiguous and 16-byte aligned; wt: (9, co, c) int8, each
// tap's (co, c) slice; inv_a: (c,), o_scale and bias: (co,) float32. c and
// co must be multiples of 64, w of 8 (bf16) or 4 (f32): TMA's rows of x and
// of the output are whole 16-byte units.
extern "C" int quantized_conv3x3(const void* x, const void* inv_a, const void* wt,
                                 const void* o_scale, const void* bias, void* out, int n, int c,
                                 int co, int h, int wd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || c <= 0 || c % KC != 0 || co <= 0 ||
      co % 64 != 0 || (dtype == 1 && wd % 8 != 0) || (dtype == 0 && wd % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const float* ia = static_cast<const float*>(inv_a);
  const int8_t* w8 = static_cast<const int8_t*>(wt);
  const float* os = static_cast<const float*>(o_scale);
  const float* fb = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch_for<float>(x, ia, w8, os, fb, out, n, c, co, h, wd, s);
  if (dtype == 1) return (int)launch_for<__nv_bfloat16>(x, ia, w8, os, fb, out, n, c, co, h, wd, s);
  return (int)cudaErrorInvalidValue;
}
