// K2: fused UNet self-attention on the packed legacy qkv layout, for
// Hopper (sm_90a), forward only.
//
// Replaces the Pallas kernel pointdreamer_tpu/kernels/attention_pallas.py::
// fused_attention_qkv (_attn_kernel).  qkv is [B, T, 3*heads*hd] with
// per-head channels [q | k | v] (QKVAttentionLegacy order), fp32 or bf16;
// the output is [B, T, heads*hd] in the input dtype =
// softmax((q . k) * hd^-1/2) @ v with an fp32 softmax.  The kernel takes
// the JAX kernel's shapes: head dims 16, 32 and 64 (template
// instantiations) and any T that is a multiple of 8; the last query and
// key tiles are masked.  The backward is not a kernel: the wrapper
// recomputes the attention with torch einsums, as the JAX package's custom
// VJP does.
//
// What bounds it on the H100: the two products, 4*B*heads*T^2*hd
// operations, against few bytes (one read of qkv, one write of out).  The
// TPU kernel kept one (batch, head)'s whole [T, T] fp32 logits in VMEM
// (4 MB at T = 1024); that does not fit Hopper's 227 KB of shared memory,
// so this kernel is flash-style:
//   - one block of 256 threads per (64-query tile, head, batch);
//   - 64-key tiles of K and V stream through shared memory, read straight
//     from the packed layout (row stride 3*heads*hd, head offset
//     3*hd*head), so no transposes are needed; when T % 64 != 0 (the
//     kMask instantiations) rows past T read as zeros and keys past T
//     score -inf, and the T % 64 == 0 path carries no masking;
//   - an online softmax keeps each row's running max and sum in fp32 and
//     rescales the fp32 output accumulators (4 x hd/16 per thread, in
//     registers);
//   - the tiles live in one typed struct (`Smem`), static where it fits
//     in 48 KB, so the compiler sees fixed, distinct arrays;
//   - the products run as plain fp32 FMAs.  wgmma/TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTq = 64;       // queries per block
constexpr int kTk = 64;       // keys per tile
constexpr int kThreads = 256;

// shared-memory row stride in elements: an odd number of 32-bit words, so
// the row-strided reads hit distinct banks
template <typename T, int HD>
struct Tile {
  static constexpr int kLd = sizeof(T) == 2 ? HD + 2 : HD + 1;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [0, 64) of a 64 x HD tile from src (row stride `row_stride`
// elements); with kMask, rows at or past `valid` are zero-filled
template <typename T, int HD, bool kMask>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t row_stride, int valid) {
  constexpr int kLd = Tile<T, HD>::kLd;
  constexpr int kVec = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kTk * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (!kMask || r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    if constexpr (sizeof(T) == 2) {
      uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * kLd + c);
      d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
    } else {
      float* d = reinterpret_cast<float*>(dst + r * kLd + c);
      d[0] = __uint_as_float(val.x); d[1] = __uint_as_float(val.y);
      d[2] = __uint_as_float(val.z); d[3] = __uint_as_float(val.w);
    }
  }
}

// the block's shared memory: static where it fits in 48 KB (every
// instantiation but fp32 hd 64), dynamic otherwise
template <typename T, int HD>
struct Smem {
  T q[kTq][Tile<T, HD>::kLd];
  T k[kTk][Tile<T, HD>::kLd];
  T v[kTk][Tile<T, HD>::kLd];
  float s[kTq][kTk + 1];
  float m[kTq], l[kTq], a[kTq];
};

template <typename T, int HD>
constexpr bool kStaticSmem = sizeof(Smem<T, HD>) <= 48 * 1024;

template <typename T, int HD, bool kMask>
__global__ void __launch_bounds__(kThreads)
attn_qkv_kernel(const T* __restrict__ qkv, T* __restrict__ out, int T_,
                int heads, float scale2) {
  constexpr int kJ = HD / 16;                   // output dims per thread
  Smem<T, HD>* sm;
  if constexpr (kStaticSmem<T, HD>) {
    __shared__ Smem<T, HD> st;
    sm = &st;
  } else {
    extern __shared__ __align__(16) unsigned char dyn[];
    sm = reinterpret_cast<Smem<T, HD>*>(dyn);
  }
  auto& sq = sm->q;
  auto& sk = sm->k;
  auto& sv = sm->v;
  auto& ss = sm->s;
  float* s_m = sm->m;
  float* s_l = sm->l;
  float* s_a = sm->a;

  const int q0 = blockIdx.x * kTq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = heads * HD;
  const int64_t stride = 3 * (int64_t)C;
  const T* base = qkv + (int64_t)b * T_ * stride + h * 3 * HD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, HD, kMask>(&sq[0][0], base + q0 * stride, stride, T_ - q0);
  if (threadIdx.x < kTq) {
    s_m[threadIdx.x] = -INFINITY;
    s_l[threadIdx.x] = 0.f;
  }
  float o[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < T_; k0 += kTk) {
    const int kvalid = T_ - k0;                 // >= 8: every tile has keys
    load_tile<T, HD, kMask>(&sk[0][0], base + k0 * stride + HD, stride,
                            kvalid);
    load_tile<T, HD, kMask>(&sv[0][0], base + k0 * stride + 2 * HD, stride,
                            kvalid);
    __syncthreads();
    // scores: rows ty+16i, keys tx+16j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f(sq[ty + 16 * i][d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(sk[tx + 16 * j][d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[ty + 16 * i][tx + 16 * j] =
            !kMask || tx + 16 * j < kvalid ? acc[i][j] * scale2 : -INFINITY;
    __syncthreads();
    // online softmax: 4 threads per row, 16 keys each
    {
      const int row = threadIdx.x / 4, part = threadIdx.x % 4;
      float* srow = &ss[row][part * 16];
      float mx = -INFINITY;
      for (int k = 0; k < 16; ++k) mx = fmaxf(mx, srow[k]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = s_m[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int k = 0; k < 16; ++k) {
        float p = expf(srow[k] - m_new);
        srow[k] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        s_a[row] = alpha;
        s_l[row] = s_l[row] * alpha + sum;
        s_m[row] = m_new;
      }
    }
    __syncthreads();
    // o = o * alpha + p @ v: rows ty+16i, dims tx+16j
    float al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) al[i] = s_a[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) o[i][j] *= al[i];
    for (int k = 0; k < kTk; ++k) {
      float pv[4], vv[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kJ; ++j) vv[j] = to_f(sv[k][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (kMask && q0 + r >= T_) continue;
    const float inv = 1.f / s_l[r];
    T* dst = out + ((int64_t)b * T_ + q0 + r) * C + h * HD;
#pragma unroll
    for (int j = 0; j < kJ; ++j) from_f(dst + tx + 16 * j, o[i][j] * inv);
  }
}

template <typename T, int HD, bool kMask>
int launch_masked(const void* qkv, void* out, int B, int T_, int heads,
                  float scale2, cudaStream_t stream) {
  constexpr int bytes = kStaticSmem<T, HD> ? 0 : (int)sizeof(Smem<T, HD>);
  if (bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_qkv_kernel<T, HD, kMask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T_ + kTq - 1) / kTq, heads, B);
  attn_qkv_kernel<T, HD, kMask><<<grid, kThreads, bytes, stream>>>(
      (const T*)qkv, (T*)out, T_, heads, scale2);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* qkv, void* out, int B, int T_, int heads,
           float scale2, cudaStream_t stream) {
  return T_ % kTq ? launch_masked<T, HD, true>(qkv, out, B, T_, heads, scale2, stream)
                  : launch_masked<T, HD, false>(qkv, out, B, T_, heads, scale2, stream);
}

}  // namespace

extern "C" {

// qkv [B,T,3*heads*hd] contiguous and 16-byte aligned, out [B,T,heads*hd],
// both fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); hd in {16, 32, 64},
// T % 8 == 0.  Returns a cudaError_t; 1 (invalid value) for any other
// shape.
int pd_attention_qkv(const void* qkv, void* out, int B, int T, int heads,
                     int hd, int is_bf16, float scale2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 0 || T % 8) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (hd == 64) return launch<__nv_bfloat16, 64>(qkv, out, B, T, heads, scale2, s);
    if (hd == 32) return launch<__nv_bfloat16, 32>(qkv, out, B, T, heads, scale2, s);
    if (hd == 16) return launch<__nv_bfloat16, 16>(qkv, out, B, T, heads, scale2, s);
  } else {
    if (hd == 64) return launch<float, 64>(qkv, out, B, T, heads, scale2, s);
    if (hd == 32) return launch<float, 32>(qkv, out, B, T, heads, scale2, s);
    if (hd == 16) return launch<float, 16>(qkv, out, B, T, heads, scale2, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
