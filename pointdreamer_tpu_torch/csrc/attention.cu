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
// key tiles are masked (the kMask instantiations: rows past T read as
// zeros and are not stored, keys past T score -inf; every 64-key tile
// holds at least 8 real keys, so the running max stays finite).  The
// backward is not a kernel: the wrapper recomputes the attention with
// torch einsums, as the JAX package's custom VJP does.
//
// What bounds it on the H100: the two products, 4*B*heads*T^2*hd
// operations, against few bytes (one read of qkv, one write of out).  The
// TPU kernel kept one (batch, head)'s whole [T, T] fp32 logits in VMEM
// (4 MB at T = 1024); that does not fit Hopper's 227 KB of shared memory,
// so both kernels here are flash-style, reading K and V straight from the
// packed layout (row stride 3*heads*hd, head offset 3*hd*head).
//
// bf16 (the UNet's path): tensor cores.
//   - one block of 4 warps per (128-query tile, head, batch); each warp
//     owns two m-tiles of 16 query rows and keeps them in registers as mma
//     A fragments (ldmatrix from the Q tile, loaded once into the second
//     stage of the K/V ring before that stage's first use);
//   - 64-key tiles of K and V stream through a two-stage shared ring by
//     cp.async (16 bytes a thread, zero-filled past T): tile j+1 loads
//     while tile j multiplies.  Rows are padded by 16 bytes (stride hd+8
//     elements, an odd multiple of 16 bytes over 128), so the eight row
//     addresses of an ldmatrix hit eight distinct bank groups;
//   - S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//     registers; K's B fragments by ldmatrix from the [key][d] tile, each
//     used by both of the warp's m-tiles);
//   - online softmax in registers: the row max and sum across the quad by
//     __shfl_xor_sync, p = exp2f(s * c - m * c) by one FFMA with
//     c = hd^-1/2 * log2(e), the running O rescaled by exp2((m_old -
//     m_new) * c);
//   - the unnormalised P is rounded to bf16 and used straight from the
//     accumulators as the A fragments of O += P V (the m16n8k16 C layout
//     is the A layout), V's B fragments by ldmatrix.trans;
//   - one divide by the row sum at the end; O goes through the warp's
//     rows of the first ring stage and out as 16-byte stores.
//   The plain version rounds the normalised weights to bf16; this kernel
//   rounds the unnormalised P (the sum l is taken over the unrounded fp32
//   P): the same function within bf16 rounding (tests/test_torch_attention
//   .py models this arithmetic against the Pallas kernel).
//   By count, each warp reads the whole K and V tile by ldmatrix (16 KB
//   at hd 64) for its rows, so with one m-tile a warp shared memory's 128
//   bytes a clock would be as near a limit as the tensor cores; two
//   m-tiles halve those reads per query.  At T = 64 the second m-tile's
//   rows are past T (zeros, not stored), and the time is the launch's.
//   -Xptxas -v at hd 16 / 32 / 64: 168 / 178-184 / 244 registers, no
//   spills (2 blocks an SM at hd 64); static shared memory, the two ring
//   stages: 12 / 20 / 36 KB.
//
// fp32 (the training CLI's hd 16 model): CUDA-core FMAs.  On tensor cores
// fp32 operands would run as TF32 (10-bit mantissas), which breaks the
// 1e-5 agreement with the plain version that training and its tests hold
// it to, so it keeps the first design: one block of 256 threads per
// 64-query tile, K and V tiles through shared memory, scores and P V as
// fp32 FMAs, the softmax through a shared [64 x 65] array.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int kTq = 64;       // queries per block
constexpr int kTk = 64;       // keys per tile

// ---------------------------------------------------------------- fp32 --

constexpr int kFmaThreads = 256;

// rows [0, 64) of a 64 x HD tile from src (row stride `row_stride`
// elements) into a row stride of HD + 1 (odd: the row-strided reads hit
// distinct banks); with kMask, rows at or past `valid` are zero-filled
template <int HD, bool kMask>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t row_stride, int valid) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < kTk * kPerRow; i += kFmaThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!kMask || r < valid)
      val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// the block's shared memory: static where it fits in 48 KB (hd 16 and 32),
// dynamic for hd 64
template <int HD>
struct SmemF32 {
  float q[kTq][HD + 1];
  float k[kTk][HD + 1];
  float v[kTk][HD + 1];
  float s[kTq][kTk + 1];
  float m[kTq], l[kTq], a[kTq];
};

template <int HD>
constexpr bool kStaticSmem = sizeof(SmemF32<HD>) <= 48 * 1024;

template <int HD, bool kMask>
__global__ void __launch_bounds__(kFmaThreads)
attn_fma_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                int T_, int heads, float scale2) {
  constexpr int kJ = HD / 16;                   // output dims per thread
  SmemF32<HD>* sm;
  if constexpr (kStaticSmem<HD>) {
    __shared__ SmemF32<HD> st;
    sm = &st;
  } else {
    extern __shared__ __align__(16) unsigned char dyn[];
    sm = reinterpret_cast<SmemF32<HD>*>(dyn);
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
  const float* base = qkv + (int64_t)b * T_ * stride + h * 3 * HD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile_f32<HD, kMask>(&sq[0][0], base + q0 * stride, stride, T_ - q0);
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
    load_tile_f32<HD, kMask>(&sk[0][0], base + k0 * stride + HD, stride,
                             kvalid);
    load_tile_f32<HD, kMask>(&sv[0][0], base + k0 * stride + 2 * HD, stride,
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
      for (int i = 0; i < 4; ++i) qv[i] = sq[ty + 16 * i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[tx + 16 * j][d];
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
      for (int j = 0; j < kJ; ++j) vv[j] = sv[k][tx + 16 * j];
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
    float* dst = out + ((int64_t)b * T_ + q0 + r) * C + h * HD;
#pragma unroll
    for (int j = 0; j < kJ; ++j) dst[tx + 16 * j] = o[i][j] * inv;
  }
}

template <int HD, bool kMask>
int launch_f32_masked(const void* qkv, void* out, int B, int T_, int heads,
                      float scale2, cudaStream_t stream) {
  constexpr int bytes = kStaticSmem<HD> ? 0 : (int)sizeof(SmemF32<HD>);
  if (bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fma_kernel<HD, kMask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T_ + kTq - 1) / kTq, heads, B);
  attn_fma_kernel<HD, kMask><<<grid, kFmaThreads, bytes, stream>>>(
      (const float*)qkv, (float*)out, T_, heads, scale2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

constexpr int kWarps = 4;
typedef __nv_bfloat16 bf16;

// two stages of K and V tiles; stage 1 holds the Q tile (128 rows)
// until its fragments are in registers, stage 0 the output on the way out
template <int HD>
struct SmemBf16 {
  static constexpr int kLd = HD + 8;          // row stride, elements
  bf16 kv[2][2][kTk][kLd];                    // [stage][k, v][key][d]
};

// m-tiles of 16 query rows a warp: a block takes 16 * 2 * 4 = 128 queries
constexpr int kMt = 2;

template <int HD, bool kMask>
__global__ void __launch_bounds__(32 * kWarps, 1)
attn_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                int T_, int heads, float scale2) {
  constexpr int kLd = SmemBf16<HD>::kLd;
  constexpr int kRows = 16 * kMt * kWarps;    // queries per block
  constexpr int kChunks = HD / 8;             // 16-byte chunks per row
  constexpr int kD16 = HD / 16;               // k-steps of Q K^T
  constexpr int kN8 = HD / 8;                 // n-tiles of O
  __shared__ __align__(128) SmemBf16<HD> sm;
  // a stage's K and V tiles, seen as one [128][kLd] array
  auto rows = [&](int stage) {
    return reinterpret_cast<bf16 (*)[kLd]>(&sm.kv[stage][0][0][0]);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = heads * HD;
  const int64_t stride = 3 * (int64_t)C;
  const bf16* base = qkv + (int64_t)b * T_ * stride + h * 3 * HD;

  // n rows from rows row0.. at column col of the head; rows past T are
  // zero-filled
  auto load = [&](bf16 (*dst)[kLd], int n, int row0, int col) {
    for (int i = threadIdx.x; i < n * kChunks; i += 32 * kWarps) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = !kMask || row0 + r < T_;
      tc::cp_async16(&dst[r][c],
                     base + (ok ? (int64_t)(row0 + r) * stride : 0) + col + c,
                     ok);
    }
  };

  const int n_tiles = (T_ + kTk - 1) / kTk;
  load(rows(1), kRows, q0, 0);
  load(sm.kv[0][0], kTk, 0, HD);
  load(sm.kv[0][1], kTk, 0, 2 * HD);
  tc::cp_async_commit();

  const float sl2 = scale2 * 1.4426950408889634f;   // scale * log2(e)
  uint32_t qf[kMt][kD16][4];
  float o[kMt][kN8][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][n][r] = 0.f;
  // rows g and g + 8 of each of the warp's m-tiles (lane = 4 g + t):
  // running max of the raw scores and this lane's part of the running sum
  float m0[kMt], m1[kMt], l0[kMt], l1[kMt];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    m0[mt] = m1[mt] = -INFINITY;
    l0[mt] = l1[mt] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    tc::cp_async_wait<0>();
    __syncthreads();              // tile j landed; tile j-1's buffers free
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int kk = 0; kk < kD16; ++kk)
          tc::ldmatrix_x4(qf[mt][kk],
                          &rows(1)[16 * (kMt * warp + mt) + (lane & 15)]
                                  [16 * kk + (lane >> 4) * 8]);
      __syncthreads();            // the Q tile's stage is free for tile 1
    }
    if (j + 1 < n_tiles) {
      load(sm.kv[buf ^ 1][0], kTk, (j + 1) * kTk, HD);
      load(sm.kv[buf ^ 1][1], kTk, (j + 1) * kTk, 2 * HD);
      tc::cp_async_commit();
    }

    // S = Q K^T: 8 n-tiles of 8 keys, each K fragment used by every m-tile
    float s[kMt][8][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[mt][n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, &sm.kv[buf][0][16 * np + (lane & 7) +
                                           ((lane >> 4) << 3)]
                                          [16 * kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          tc::mma_bf16(s[mt][2 * np], qf[mt][kk], kb[0], kb[1]);
          tc::mma_bf16(s[mt][2 * np + 1], qf[mt][kk], kb[2], kb[3]);
        }
      }

    // online softmax: row maxima of the raw scores, p = 2^(s*sl2 - m*sl2)
    // by one FFMA and exp2
    const int key0 = j * kTk + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      float mx0 = m0[mt], mx1 = m1[mt];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (kMask && key0 + 8 * n + (r & 1) >= T_) s[mt][n][r] = -INFINITY;
          if (r < 2) mx0 = fmaxf(mx0, s[mt][n][r]);
          else mx1 = fmaxf(mx1, s[mt][n][r]);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = exp2f((m0[mt] - mx0) * sl2);
      const float a1 = exp2f((m1[mt] - mx1) * sl2);
      m0[mt] = mx0;
      m1[mt] = mx1;
      const float b0 = -mx0 * sl2, b1 = -mx1 * sl2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[mt][n][0] = exp2f(fmaf(s[mt][n][0], sl2, b0));
        s[mt][n][1] = exp2f(fmaf(s[mt][n][1], sl2, b0));
        s[mt][n][2] = exp2f(fmaf(s[mt][n][2], sl2, b1));
        s[mt][n][3] = exp2f(fmaf(s[mt][n][3], sl2, b1));
        rs0 += s[mt][n][0] + s[mt][n][1];
        rs1 += s[mt][n][2] + s[mt][n][3];
      }
      l0[mt] = l0[mt] * a0 + rs0;
      l1[mt] = l1[mt] * a1 + rs1;
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        o[mt][n][0] *= a0;
        o[mt][n][1] *= a0;
        o[mt][n][2] *= a1;
        o[mt][n][3] *= a1;
      }
    }

    // O += P V: P's bf16 A fragments straight from the S accumulators,
    // each V fragment used by every m-tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        pa[mt][0] = tc::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = tc::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = tc::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = tc::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, &sm.kv[buf][1][16 * kk + (lane & 15)]
                                               [16 * dp + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          tc::mma_bf16(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
          tc::mma_bf16(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // the row sums across the quad, one divide, bf16 through the warp's own
  // rows of stage 0, then 16-byte stores
  __syncthreads();                // every warp is done with the last tile
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bf16 (*so)[kLd] = rows(0) + 16 * kMt * warp;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    float s0 = l0[mt], s1 = l1[mt];
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const float inv0 = 1.f / s0, inv1 = 1.f / s1;
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      *reinterpret_cast<uint32_t*>(&so[16 * mt + g][8 * n + t2]) =
          tc::pack_bf16(o[mt][n][0] * inv0, o[mt][n][1] * inv0);
      *reinterpret_cast<uint32_t*>(&so[16 * mt + g + 8][8 * n + t2]) =
          tc::pack_bf16(o[mt][n][2] * inv1, o[mt][n][3] * inv1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * kMt * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = q0 + 16 * kMt * warp + r;
    if (kMask && row >= T_) continue;
    *reinterpret_cast<uint4*>(out + ((int64_t)b * T_ + row) * C + h * HD + c) =
        *reinterpret_cast<const uint4*>(&so[r][c]);
  }
}

template <int HD>
int launch_bf16(const void* qkv, void* out, int B, int T_, int heads,
                float scale2, cudaStream_t stream) {
  constexpr int kRows = 16 * kMt * kWarps;
  dim3 grid((T_ + kRows - 1) / kRows, heads, B);
  if (T_ % kRows)
    attn_mma_kernel<HD, true><<<grid, 32 * kWarps, 0, stream>>>(
        (const bf16*)qkv, (bf16*)out, T_, heads, scale2);
  else
    attn_mma_kernel<HD, false><<<grid, 32 * kWarps, 0, stream>>>(
        (const bf16*)qkv, (bf16*)out, T_, heads, scale2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* qkv, void* out, int B, int T_, int heads, int is_bf16,
           float scale2, cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<HD>(qkv, out, B, T_, heads, scale2, stream);
  return T_ % kTq ? launch_f32_masked<HD, true>(qkv, out, B, T_, heads, scale2, stream)
                  : launch_f32_masked<HD, false>(qkv, out, B, T_, heads, scale2, stream);
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
  if (hd == 64) return launch<64>(qkv, out, B, T, heads, is_bf16, scale2, s);
  if (hd == 32) return launch<32>(qkv, out, B, T, heads, is_bf16, scale2, s);
  if (hd == 16) return launch<16>(qkv, out, B, T, heads, is_bf16, scale2, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
