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
// Every f32 step is one rounded operation (__fmul_rn / __fadd_rn, rintf: no
// FMA contraction), as the plain version (ops/quant.py::qconv_apply)
// computes it op by op, and the int32 sums are exact in any order: the
// kernel is bit-identical to its plain version.
//
// What bounds it on the card: 2*9*H*W*C*Co int8 operations per image; at the
// 768^2@128 VAE level (batch 2) 347.9 G, 0.176 ms at 1,979 TOPS, against
// 0.180 ms for its bf16 input and output at 3.35 TB/s: bytes bound at C = 128
// (the contraction is shallow), operations bound at C = 512. What the fusion
// saves is the int8 code tensor, the im2col gather and the int32 product
// that the composed path (quantize pass, gather, torch._int_mm, epilogue
// pass) writes to device memory and reads back.
//
// Design: the implicit GEMM of fused_gn_silu_conv3x3.cu with int8 operands.
// A CTA owns an 8 x 16 pixel tile of one image and 64 output channels and
// walks C in 64-channel chunks: it stages the (8+2) x (16+2) halo tile,
// quantizing while staging (pixel-major, channels contiguous, rows padded to
// 80 bytes for conflict-free ldmatrix), and the chunk's int8 weights for all
// nine taps, then runs the nine shifted-window products with int8 mma.sync
// m16n8k32 into int32 registers. 8 warps = 4 (pixel rows) x 2 (32-channel
// halves). 64-channel tiles take C, Co = 320 (the UNet level-0 width).
// cp.async / TMA, wgmma and overlap of staging with products are later work.
//
// Weight layout (prepared by the wrapper): (Co, 3, 3, C) int8.

#include "common.cuh"

namespace {

using namespace gp;

constexpr int kThreads = 256;
constexpr int TH = 8, TW = 16;       // output tile: 8 rows x 16 columns
constexpr int HC = TW + 2;           // halo tile width
constexpr int NPIX = (TH + 2) * HC;  // 180 halo pixels
constexpr int BN = 64;               // output channels per CTA
constexpr int KC = 64;               // input channels per chunk
constexpr int LD = KC + 16;          // bytes per shared row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// clip(rint(v * inv_a), -127, 127) as the low byte
__device__ __forceinline__ uint32_t code_s8(float v, float inv_a) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv_a)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qconv3x3_kernel(const T* __restrict__ x, const float* __restrict__ inv_a,
                const int8_t* __restrict__ w, const float* __restrict__ o_scale,
                const float* __restrict__ bias, T* __restrict__ out, int C, int Co, int H,
                int W, int tiles_w) {
  extern __shared__ float4 smem4[];
  int8_t* Xs = reinterpret_cast<int8_t*>(smem4);  // [NPIX][LD]
  int8_t* Ws = Xs + NPIX * LD;                    // [9][BN][LD]

  const int n = blockIdx.z, co0 = blockIdx.y * BN;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // tile rows 2wm, 2wm+1; channels 32wn..
  const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
  const size_t hw = (size_t)H * W;
  const T* xn = x + (size_t)n * C * hw;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    // the quantized halo tile, four channels (one 32-bit word) per thread
    for (int idx = threadIdx.x; idx < (KC / 4) * NPIX; idx += kThreads) {
      const int cq = idx / NPIX, p = idx % NPIX;
      const int gy = h0 + p / HC - 1, gx = w0 + p % HC - 1;
      const int c = c0 + 4 * cq;
      uint32_t word = 0;  // code 0: the symmetric zero padding
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const T* src = xn + c * hw + (size_t)gy * W + gx;
#pragma unroll
        for (int k = 0; k < 4; ++k) word |= code_s8(to_f32(src[k * hw]), inv_a[c + k]) << (8 * k);
      }
      *reinterpret_cast<uint32_t*>(Xs + p * LD + 4 * cq) = word;
    }
    // the chunk's weights, rows (tap, co) of KC bytes
    for (int idx = threadIdx.x; idx < 9 * BN * (KC / 16); idx += kThreads) {
      const int v = idx % (KC / 16), row = idx / (KC / 16);
      const int tap = row / BN, co = row % BN;
      *reinterpret_cast<uint4*>(Ws + row * LD + 16 * v) = *reinterpret_cast<const uint4*>(
          w + ((size_t)(co0 + co) * 9 + tap) * C + c0 + 16 * v);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int k0 = 0; k0 < KC; k0 += 32) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // m-tile i = tile row 2wm+i, columns 0..15; shifted by the tap
          const int p = (2 * wm + i + dy) * HC + mr + 8 * (mi % 2) + dx;
          ldsm_x4(Xs + p * LD + k0 + 16 * (mi / 2), af[i]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[4];
          ldsm_x4(Ws + (tap * BN + 32 * wn + 16 * j + mr + 8 * (mi / 2)) * LD + k0 +
                      16 * (mi % 2),
                  bf);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_s8(acc[i][2 * j], af[i], bf[0], bf[1]);
            mma_s8(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = h0 + 2 * wm + i;
    if (gy >= H) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gx = w0 + g + 8 * (e / 2);
      if (gx >= W) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + 32 * wn + 8 * nt + 2 * t + (e & 1);
        store(out + ((size_t)n * Co + co) * hw + (size_t)gy * W + gx,
              dequant(acc[i][nt][e], o_scale[co], bias[co]));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* inv_a, const int8_t* w, const float* o_scale,
                   const float* bias, void* out, int n, int c, int co, int h, int wd,
                   cudaStream_t stream) {
  constexpr size_t smem = (size_t)(NPIX + 9 * BN) * LD;
  auto kern = qconv3x3_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + TW - 1) / TW;
  const dim3 grid(((h + TH - 1) / TH) * tiles_w, co / BN, n);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), inv_a, w, o_scale, bias,
                                         static_cast<T*>(out), c, co, h, wd, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// x: (n, c, h, w) and out: (n, co, h, w), of one dtype (0 = float32,
// 1 = bfloat16), contiguous; wt: (co, 3, 3, c) int8; inv_a: (c,), o_scale
// and bias: (co,) float32. c and co must be multiples of 64.
extern "C" int quantized_conv3x3(const void* x, const void* inv_a, const void* wt,
                                 const void* o_scale, const void* bias, void* out, int n, int c,
                                 int co, int h, int wd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || c <= 0 || c % KC != 0 || co <= 0 ||
      co % BN != 0)
    return (int)cudaErrorInvalidValue;
  const float* ia = static_cast<const float*>(inv_a);
  const int8_t* w8 = static_cast<const int8_t*>(wt);
  const float* os = static_cast<const float*>(o_scale);
  const float* fb = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(x, ia, w8, os, fb, out, n, c, co, h, wd, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, ia, w8, os, fb, out, n, c, co, h, wd, s);
  return (int)cudaErrorInvalidValue;
}
