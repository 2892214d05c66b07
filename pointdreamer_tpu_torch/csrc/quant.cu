// K7 quantize_act and K8 int8_conv: the w8a8 UNet torso's activation
// quantize and its int8 convolution / dense layer, for Hopper (sm_90a).
//
// Neither has a Pallas kernel to replace: the JAX package leaves both to
// XLA, inside QConv8 / QDense8 (pointdreamer_tpu/models/diffusion/
// unet.py:92-100 and :121-124): a per-tensor activation scale
// ax = max(max|x|, 1e-12) / 127, xq = clip(round(x / ax), -127, 127), an
// int8 conv_general_dilated / dot_general with int32 accumulation, and the
// fp32 epilogue y = acc * (ax * ks[n]) + b[n].  PyTorch has no int8
// convolution on the card, so the port carries both here.
//
// K7 (pd_quantize_act): x bf16 or fp32, [B, C, S] (the port's NCHW torso,
// S = H * W) or [B, S, C] (channels last: the attention output), to int8
// [B, S, C], the layout K8 reads.  The amax is either reduced here (a
// grid-stride pass of 16-byte loads, a warp and block max, one atomicMax
// a block on the int bits of the non-negative float, exact) or read from
// a device pointer (a static per-step scale); it is optionally written to
// a calibration slot.  ax goes to a device scalar: nothing is read back
// to the host.  The quantize divides (IEEE, no fast math) and rounds half
// to even (rintf), as jnp.round does.  From NCHW the pass is a 32 x 32
// tile transpose through shared memory.  Bound: bytes (x read, int8
// written; x read a second time for a dynamic amax).
//
// K8 (pd_int8_conv): implicit GEMM.  M = B * Ho * Wo output pixels, N =
// Cout, K = kh * kw * Cin with k = (ky * kw + kx) * Cin + ci, so with Cin %
// 32 == 0 each 16-byte piece of a row of A is 16 channels of one input
// pixel of one tap (zeros past the border: cp.async's source size 0).
// Weights [N, K] int8, K contiguous: the col operand of mma.sync
// m16n8k32 s8.  3x3 (pad 1, stride 1 or 2) and 1x1 (pad 0); a dense layer
// is a 1x1 over B * T rows.  Products are <= 127^2 and K <= 9 * 2048, so
// the int32 sums are exact and order-free; the epilogue is the JAX
// package's (acc as fp32, times ax * ks[n], plus b[n], each rounded
// apart: __fmul_rn / __fadd_rn, no contraction), written as bf16 or fp32
// to NCHW [B, N, Ho, Wo] or to rows [M, N].  Bound: operations (2 M N K
// at the int8 tensor-core rate) at the UNet's large layers.  The design is
// the simple one: a 128 x 128 output tile a block of 8 warps (64 x 32
// each), K in 64-byte chunks through a four-stage cp.async ring (rows
// padded to 80 bytes: the ldmatrix reads are free of bank conflicts),
// mma.sync with int32 accumulators in registers, stores straight from the
// fragments.  Block x runs over N so the blocks that share a tile of A run
// together.  Neither wgmma nor TMA is used yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
struct PerVec;                 // elements in 16 bytes
template <>
struct PerVec<float> { static constexpr int n = 4; };
template <>
struct PerVec<bf16> { static constexpr int n = 8; };

// max of non-negative values that keeps a NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// max(amax, 1e-12) / 127 in fp32 (jnp.maximum keeps a NaN)
__device__ __forceinline__ float act_scale(float amax) {
  const float a = (amax != amax || amax > 1e-12f) ? amax : 1e-12f;
  return __fdiv_rn(a, 127.0f);
}

__device__ __forceinline__ int8_t quant1(float v, float ax) {
  float r = rintf(__fdiv_rn(v, ax));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

constexpr int kRedThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    absmax_kernel(const T* __restrict__ x, size_t n, float* amax) {
  constexpr int V = PerVec<T>::n;
  const size_t nv = n / V;
  const size_t first = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float m = 0.0f;
  for (size_t j = first; j < nv; j += step) {
    const uint4 u = __ldg(xv + j);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) m = nan_max(m, fabsf(to_f(e[k])));
  }
  for (size_t j = nv * V + first; j < n; j += step)
    m = nan_max(m, fabsf(to_f(x[j])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float red[kRedThreads / 32];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kRedThreads / 32; ++w) m = nan_max(m, red[w]);
    // non-negative floats (and a NaN above them all) order as their bits
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(m));
  }
}

__device__ __forceinline__ void publish(const float* amax, float ax,
                                        float* ax_out, float* calib) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    *ax_out = ax;
    if (calib) *calib = *amax;
  }
}

// [B, C, S] -> int8 [B, S, C], one 32 x 32 (channel, pixel) tile a block
template <typename T>
__global__ void __launch_bounds__(256)
    quant_nchw_kernel(const T* __restrict__ x, int C, int S,
                      const float* amax, float* ax_out, float* calib,
                      int8_t* __restrict__ q) {
  __shared__ int8_t tile[32][36];         // [pixel][channel]
  const float ax = act_scale(*amax);
  const int b = blockIdx.z, c0 = blockIdx.y * 32, s0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* xb = x + (size_t)b * C * S;
  for (int j = ty; j < 32; j += 8) {
    const int c = c0 + j, s = s0 + tx;
    if (c < C && s < S) tile[tx][j] = quant1(to_f(xb[(size_t)c * S + s]), ax);
  }
  __syncthreads();
  int8_t* qb = q + (size_t)b * S * C;
  for (int j = ty; j < 32; j += 8) {
    const int s = s0 + j, c = c0 + tx;
    if (s < S && c < C) qb[(size_t)s * C + c] = tile[j][tx];
  }
  publish(amax, ax, ax_out, calib);
}

// channels last: the same layout in and out, elementwise
template <typename T>
__global__ void __launch_bounds__(256)
    quant_flat_kernel(const T* __restrict__ x, size_t n, const float* amax,
                      float* ax_out, float* calib, int8_t* __restrict__ q) {
  const float ax = act_scale(*amax);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    q[i] = quant1(to_f(x[i]), ax);
  publish(amax, ax, ax_out, calib);
}

template <typename T>
void launch_quant(const void* x, int B, int C, int S, int channels_last,
                  float* amax_scratch, const float* amax_static, float* calib,
                  void* q, float* ax, cudaStream_t st) {
  const size_t n = (size_t)B * C * S;
  const float* amax = amax_static;
  if (!amax) {
    cudaMemsetAsync(amax_scratch, 0, sizeof(float), st);
    size_t blocks = (n + kRedThreads * 8 - 1) / (kRedThreads * 8);
    blocks = blocks < 1 ? 1 : (blocks > 132 * 8 ? 132 * 8 : blocks);
    absmax_kernel<T><<<(int)blocks, kRedThreads, 0, st>>>(
        static_cast<const T*>(x), n, amax_scratch);
    amax = amax_scratch;
  }
  if (channels_last) {
    size_t blocks = (n + 255) / 256;
    blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
    quant_flat_kernel<T><<<(int)blocks, 256, 0, st>>>(
        static_cast<const T*>(x), n, amax, ax, calib,
        static_cast<int8_t*>(q));
  } else {
    dim3 grid((S + 31) / 32, (C + 31) / 32, B);
    quant_nchw_kernel<T><<<grid, 256, 0, st>>>(
        static_cast<const T*>(x), C, S, amax, ax, calib,
        static_cast<int8_t*>(q));
  }
}

// ---- K8 -------------------------------------------------------------

constexpr int kBM = 128, kBN = 128;       // output tile: pixels x channels
constexpr int kBK = 64;                   // K bytes a stage
constexpr int kLd = kBK + 16;             // smem row stride, bytes
constexpr int kStages = 4;
constexpr int kConvThreads = 256;         // 8 warps, 2 (M) x 4 (N)
constexpr int kConvSmem = kStages * (kBM + kBN) * kLd;   // 81,920 bytes

struct ConvParams {
  const int8_t* x;                        // [B, H, W, Cin]
  const int8_t* w;                        // [N, K]
  const float* ax;                        // device scalar
  const float* ks;                        // [N]
  const float* bias;                      // [N]
  void* out;
  int H, W, Cin, Ho, Wo, N, K, KW, stride, pad, M;
};

template <bool kBf16Out, bool kNchw>
__global__ void __launch_bounds__(kConvThreads, 2)
    int8_conv_kernel(const ConvParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sA = smem;
  uint8_t* sB = smem + kStages * kBM * kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int seg = tid & 3, row = tid >> 2;        // rows row, row + 64
  const int HWo = p.Ho * p.Wo;

  const int8_t* xrow[2];
  const int8_t* wrow[2];
  int iy0[2], ix0[2];
  bool mval[2], nval[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + row + 64 * r;
    mval[r] = m < p.M;
    const int mm = mval[r] ? m : 0;
    const int b = mm / HWo, rem = mm - b * HWo;
    const int oy = rem / p.Wo, ox = rem - oy * p.Wo;
    iy0[r] = oy * p.stride - p.pad;
    ix0[r] = ox * p.stride - p.pad;
    xrow[r] = p.x + (size_t)b * p.H * p.W * p.Cin;
    const int n = n0 + row + 64 * r;
    nval[r] = n < p.N;
    wrow[r] = p.w + (size_t)(nval[r] ? n : 0) * p.K;
  }

  auto load = [&](int stage, int k0) {
    const int k = k0 + seg * 16;
    const bool kval = k < p.K;
    const int tap = k / p.Cin, ci = k - tap * p.Cin;
    const int ky = tap / p.KW, kx = tap - ky * p.KW;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int iy = iy0[r] + ky, ix = ix0[r] + kx;
      const bool v = kval && mval[r] && iy >= 0 && iy < p.H && ix >= 0 &&
                     ix < p.W;
      const int8_t* src =
          v ? xrow[r] + ((size_t)iy * p.W + ix) * p.Cin + ci : p.x;
      tc::cp_async16(sA + (stage * kBM + row + 64 * r) * kLd + seg * 16, src,
                     v);
      const bool vw = kval && nval[r];
      tc::cp_async16(sB + (stage * kBN + row + 64 * r) * kLd + seg * 16,
                     vw ? wrow[r] + k : p.w, vw);
    }
  };

  const int wm = warp >> 2, wn = warp & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();               // chunk kt landed; chunk kt-1 consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt * kBK);
    tc::cp_async_commit();
    const uint8_t* a_s = sA + (kt % kStages) * kBM * kLd;
    const uint8_t* b_s = sB + (kt % kStages) * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        tc::ldmatrix_x4(af[mt], a_s + (wm * 64 + mt * 16 + (lane & 15)) * kLd +
                                    kk + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r4[4];
        tc::ldmatrix_x4(r4, b_s + (wn * 32 + np * 16 + (lane & 7) +
                                   ((lane >> 4) << 3)) * kLd +
                                kk + ((lane >> 3) & 1) * 16);
        bf[2 * np][0] = r4[0];
        bf[2 * np][1] = r4[1];
        bf[2 * np + 1][0] = r4[2];
        bf[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tc::mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  tc::cp_async_wait<0>();

  const float axv = *p.ax;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * t + j;
      if (n >= p.N) continue;
      const float sc = __fmul_rn(axv, p.ks[n]), bi = p.bias[n];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + mt * 16 + g + 8 * h;
          if (m >= p.M) continue;
          const float v = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), sc), bi);
          size_t o;
          if (kNchw) {
            const int b = m / HWo;
            o = ((size_t)b * p.N + n) * HWo + (m - b * HWo);
          } else {
            o = (size_t)m * p.N + n;
          }
          if (kBf16Out)
            static_cast<bf16*>(p.out)[o] = __float2bfloat16_rn(v);
          else
            static_cast<float*>(p.out)[o] = v;
        }
      }
    }
  }
}

template <bool kBf16Out, bool kNchw>
cudaError_t launch_conv(const ConvParams& p, cudaStream_t st) {
  static bool attr_set = false;    // a second setting is harmless
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<kBf16Out, kNchw>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  int8_conv_kernel<kBf16Out, kNchw><<<grid, kConvThreads, kConvSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pd_quantize_act(const void* x, int is_bf16, int B, int C,
                               int S, int channels_last, float* amax_scratch,
                               const float* amax_static, float* calib,
                               void* q, float* ax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_quant<bf16>(x, B, C, S, channels_last, amax_scratch, amax_static,
                       calib, q, ax, st);
  else
    launch_quant<float>(x, B, C, S, channels_last, amax_scratch,
                        amax_static, calib, q, ax, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pd_int8_conv(const void* x, const void* w, const float* ax,
                            const float* ks, const float* bias, void* out,
                            int B, int H, int W, int Cin, int N, int KH,
                            int KW, int stride, int pad, int out_bf16,
                            int out_nchw, void* stream) {
  ConvParams p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.ax = ax;
  p.ks = ks;
  p.bias = bias;
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Ho = (H + 2 * pad - KH) / stride + 1;
  p.Wo = (W + 2 * pad - KW) / stride + 1;
  p.N = N;
  p.K = KH * KW * Cin;
  p.KW = KW;
  p.stride = stride;
  p.pad = pad;
  p.M = B * p.Ho * p.Wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (out_bf16)
    e = out_nchw ? launch_conv<true, true>(p, st)
                 : launch_conv<true, false>(p, st);
  else
    e = out_nchw ? launch_conv<false, true>(p, st)
                 : launch_conv<false, false>(p, st);
  return static_cast<int>(e);
}
