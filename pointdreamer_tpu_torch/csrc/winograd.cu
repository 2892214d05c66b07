// K6: 3x3 convolution, stride 1, 'same' padding, by Winograd F(2x2, 3x3),
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel pointdreamer_tpu/kernels/winograd_pallas.py::
// winograd_conv3x3 (_wino_kernel).  x [B,H,W,Cin] bf16 (NHWC), the
// pre-transformed weights U [16,Cin,Cout] bf16 (U[4u+v] = (G w G^T)[u,v],
// made by the wrapper as transform_weights does), out [B,H,W,Cout] bf16.
// Each 2x2 output tile takes the 4x4 input tile d around it (zeros past
// the border: the padding is done here, with no padded copy of x),
// V = B^T d B in bf16 with the Pallas kernel's add pattern and rounding,
// 16 products M[uv] = V[uv] . U[uv] summed over Cin in fp32, and
// Y = A^T M A in fp32, stored once.
//
// What bounds it on the H100: operations, 2*B*H*W*Cin*Cout*4 (16
// multiplies per 4 outputs instead of 36) against one read of x and of U
// and one write of y.  This first version is simple and right, not fast:
//   - one block of 256 threads per 32 output tiles x 32 output channels;
//   - Cin in chunks of 16: the block's V (16 x 16 x 32) and U slice
//     (16 x 16 x 32) go through shared memory as fp32;
//   - each thread keeps M for one tile and 4 output channels (64 fp32
//     accumulators) and runs plain fp32 FMAs;
//   - the output transform is done in registers.
// The TPU's even/odd row and column views (Mosaic has no strided loads)
// become plain indexing.  Tensor cores (mma.sync / wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTP = 32;       // output tiles per block
constexpr int kCO = 32;       // output channels per block
constexpr int kKC = 16;       // input channels per chunk
constexpr int kThreads = 256;
constexpr int kSmem = 2 * 16 * kKC * 32 * 4;   // sV + sU, fp32

__device__ __forceinline__ __nv_bfloat16 bsub(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) - __bfloat162float(b));
}
__device__ __forceinline__ __nv_bfloat16 badd(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}

// two blocks per SM: caps the registers at 128 (129 unbounded, one block)
__global__ void __launch_bounds__(kThreads, 2)
wino_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ U,
            __nv_bfloat16* __restrict__ out, int B, int H, int W, int Cin,
            int Cout) {
  extern __shared__ __align__(16) float smem[];
  float* sV = smem;                             // [16][kKC][kTP]
  float* sU = smem + 16 * kKC * kTP;            // [16][kKC][kCO]
  const int TW = W / 2, TH = H / 2;
  const int64_t NT = (int64_t)B * TH * TW;
  const int64_t t0 = (int64_t)blockIdx.x * kTP;
  const int o0 = blockIdx.y * kCO;
  const int pl = threadIdx.x / 8, oq = threadIdx.x % 8;

  float m[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) m[i][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    // V = B^T d B for (tile, channel) pairs, two per thread
    for (int j = threadIdx.x; j < kTP * kKC; j += kThreads) {
      const int c = j % kKC, p = j / kKC;
      const int64_t t = t0 + p;
      __nv_bfloat16 d[4][4];
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      if (t < NT) {
        const int tx = (int)(t % TW);
        const int ty = (int)((t / TW) % TH);
        const int64_t b = t / ((int64_t)TW * TH);
        const __nv_bfloat16* xb = x + b * H * W * Cin + c0 + c;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int yy = 2 * ty - 1 + r;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int xx = 2 * tx - 1 + s;
            d[r][s] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                          ? xb[((int64_t)yy * W + xx) * Cin] : zero;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) d[r][s] = zero;
      }
      // rows (B^T d): tt[u][col], then columns ((B^T d) B): v[u][v]
      __nv_bfloat16 tt[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        tt[0][s] = bsub(d[0][s], d[2][s]);
        tt[1][s] = badd(d[1][s], d[2][s]);
        tt[2][s] = bsub(d[2][s], d[1][s]);
        tt[3][s] = bsub(d[1][s], d[3][s]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* dst = sV + (4 * u * kKC + c) * kTP + p;
        dst[0 * kKC * kTP] = __bfloat162float(bsub(tt[u][0], tt[u][2]));
        dst[1 * kKC * kTP] = __bfloat162float(badd(tt[u][1], tt[u][2]));
        dst[2 * kKC * kTP] = __bfloat162float(bsub(tt[u][2], tt[u][1]));
        dst[3 * kKC * kTP] = __bfloat162float(bsub(tt[u][1], tt[u][3]));
      }
    }
    // the U slice: 16 x kKC x kCO as 8-element vectors
    for (int q = threadIdx.x; q < 16 * kKC * (kCO / 8); q += kThreads) {
      const int o8 = (q % (kCO / 8)) * 8;
      const int c = (q / (kCO / 8)) % kKC;
      const int uv = q / (kCO / 8 * kKC);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          U + ((int64_t)uv * Cin + c0 + c) * Cout + o0 + o8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float* dst = sU + (uv * kKC + c) * kCO + o8;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        dst[2 * k] = f.x;
        dst[2 * k + 1] = f.y;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kKC; ++c) {
#pragma unroll
      for (int uv = 0; uv < 16; ++uv) {
        const float v = sV[(uv * kKC + c) * kTP + pl];
        const float4 u = reinterpret_cast<const float4*>(
            sU + (uv * kKC + c) * kCO)[oq];
        m[uv][0] = fmaf(v, u.x, m[uv][0]);
        m[uv][1] = fmaf(v, u.y, m[uv][1]);
        m[uv][2] = fmaf(v, u.z, m[uv][2]);
        m[uv][3] = fmaf(v, u.w, m[uv][3]);
      }
    }
    __syncthreads();
  }

  const int64_t t = t0 + pl;
  if (t >= NT) return;
  const int tx = (int)(t % TW);
  const int ty = (int)((t / TW) % TH);
  const int64_t b = t / ((int64_t)TW * TH);
  // Y = A^T M A: rows z0 = m0 + m1 + m2, z1 = m1 - m2 - m3, then columns
  float y[2][2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float z[2][4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      z[0][v] = (m[v][q] + m[4 + v][q]) + m[8 + v][q];
      z[1][v] = (m[4 + v][q] - m[8 + v][q]) - m[12 + v][q];
    }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      y[dy][0][q] = (z[dy][0] + z[dy][1]) + z[dy][2];
      y[dy][1][q] = (z[dy][1] - z[dy][2]) - z[dy][3];
    }
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      __nv_bfloat162 pk[2] = {__floats2bfloat162_rn(y[dy][dx][0], y[dy][dx][1]),
                              __floats2bfloat162_rn(y[dy][dx][2], y[dy][dx][3])};
      __nv_bfloat16* dst = out + ((b * H + 2 * ty + dy) * W + 2 * tx + dx) *
                                     (int64_t)Cout + o0 + oq * 4;
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(pk);
    }
}

}  // namespace

extern "C" {

// x [B,H,W,Cin] bf16, U [16,Cin,Cout] bf16, out [B,H,W,Cout] bf16, all
// contiguous and 16-byte aligned.  H, W even, Cin % 16 == 0,
// Cout % 32 == 0.  Returns a cudaError_t.
int pd_winograd_conv3x3(const void* x, const void* U, void* out, int B,
                        int H, int W, int Cin, int Cout, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < kKC ||
      Cin % kKC || Cout < kCO || Cout % kCO)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wino_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const int64_t nt = (int64_t)B * (H / 2) * (W / 2);
  dim3 grid((unsigned)((nt + kTP - 1) / kTP), Cout / kCO);
  wino_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)U, (__nv_bfloat16*)out,
      B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
