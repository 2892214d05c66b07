// K5: fused GroupNorm32 (+ optional (1+scale)/shift) (+ optional SiLU) on
// [B, S, C], for Hopper (sm_90a).
//
// Replaces the Pallas kernel pointdreamer_tpu/kernels/groupnorm_pallas.py::
// fused_groupnorm (_gn_kernel).  x is fp32 or bf16, the output fp32 or
// bf16; statistics are fp32 and use the reference's E[x^2] - E[x]^2
// (not Welford: its cancellation is part of the result).  gamma/beta are
// folded into one per-(batch, channel) scale and bias, as the TPU kernel's
// phase 0 does.
//
// What bounds it on the H100: bytes.  The function has to read x once and
// write y once (~1 operation per byte); this kernel reads x twice, like
// the TPU kernel.  The TPU ran the phases one after another on one core
// with the sums in VMEM scratch; on Hopper the blocks run in parallel, so
// the work is three launches:
//   1. gn_stats: per-(batch, channel) fp32 sum and sum of squares over a
//      slice of S rows, one block per (slice, batch), enough slices to give
//      the 132 SMs several blocks each (but no slice under 32 rows, so the
//      fold stays short at small S); 16-byte loads along C, the rows of
//      the slice spread over the block and reduced in shared memory;
//   2. gn_fold: one block per batch sums the slices, folds channels into
//      the 32 groups (mean, E[x^2] - mean^2, rsqrt) and writes scale =
//      gamma * rstd and bias = beta - mean * gamma * rstd;
//   3. gn_apply: y = x * scale + bias, then y * (1 + s) + shift, then SiLU,
//      8 elements per thread, written once in the output dtype.
// The _rn intrinsics keep the compiler from contracting the plain
// version's separate roundings into FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 32;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// part [B][nsplit][2][C]: the slice's sum and sum of squares per channel
template <typename Ti>
__global__ void __launch_bounds__(kThreads)
gn_stats(const Ti* __restrict__ x, float* __restrict__ part, int S, int C,
         int rows_per_split) {
  __shared__ float red[kThreads][17];
  const int split = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
  const int P = C / 8;                          // 8-channel vectors per row
  const int tpr = P < kThreads ? P : kThreads;  // threads along a row
  const int rp = kThreads / tpr;                // rows in flight
  const int cv = threadIdx.x % tpr, rs = threadIdx.x / tpr;
  const int r0 = split * rows_per_split;
  const int r1 = min(S, r0 + rows_per_split);
  const Ti* xb = x + (int64_t)b * S * C;
  float* out = part + ((int64_t)b * nsplit + split) * 2 * C;
  for (int v0 = 0; v0 < P; v0 += tpr) {
    const int v = v0 + cv;
    float s[8], q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.f;
    if (rs < rp && v < P) {
      for (int r = r0 + rs; r < r1; r += rp) {
        float f[8];
        load8(xb + (int64_t)r * C + v * 8, f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s[k] = __fadd_rn(s[k], f[k]);
          q[k] = __fadd_rn(q[k], __fmul_rn(f[k], f[k]));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[threadIdx.x][k] = s[k];
      red[threadIdx.x][8 + k] = q[k];
    }
    __syncthreads();
    if (rs == 0 && v < P) {
      for (int j = 1; j < rp; ++j) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s[k] = __fadd_rn(s[k], red[j * tpr + cv][k]);
          q[k] = __fadd_rn(q[k], red[j * tpr + cv][8 + k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        out[v * 8 + k] = s[k];
        out[C + v * 8 + k] = q[k];
      }
    }
    __syncthreads();
  }
}

// sb [B][2][C]: the folded scale and bias (also the channel totals'
// scratch before the fold)
__global__ void __launch_bounds__(kThreads)
gn_fold(const float* __restrict__ part, const float* __restrict__ gamma,
        const float* __restrict__ beta, float* __restrict__ sb, int C,
        int nsplit, float n, float eps) {
  __shared__ float g_mean[kGroups], g_rstd[kGroups];
  const int b = blockIdx.x;
  float* tot = sb + (int64_t)b * 2 * C;
  const float* pb = part + (int64_t)b * nsplit * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f, q = 0.f;
    // unrolled so the independent loads are in flight together; the adds
    // keep their order
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) {
      s = __fadd_rn(s, pb[(int64_t)sp * 2 * C + c]);
      q = __fadd_rn(q, pb[(int64_t)sp * 2 * C + C + c]);
    }
    tot[c] = s;
    tot[C + c] = q;
  }
  __syncthreads();
  const int gs = C / kGroups;
  if (threadIdx.x < kGroups) {
    float s = 0.f, q = 0.f;
#pragma unroll 8
    for (int k = 0; k < gs; ++k) {
      s = __fadd_rn(s, tot[threadIdx.x * gs + k]);
      q = __fadd_rn(q, tot[C + threadIdx.x * gs + k]);
    }
    const float mean = __fdiv_rn(s, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
    g_mean[threadIdx.x] = mean;
    g_rstd[threadIdx.x] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float mean = g_mean[c / gs], rstd = g_rstd[c / gs];
    const float g = gamma[c];
    tot[c] = __fmul_rn(g, rstd);
    tot[C + c] = __fsub_rn(beta[c], __fmul_rn(__fmul_rn(mean, g), rstd));
  }
}

template <typename Ti, typename To>
__global__ void __launch_bounds__(kThreads)
gn_apply(const Ti* __restrict__ x, const float* __restrict__ sb,
         const float* __restrict__ ss, To* __restrict__ out, int S, int C,
         int64_t nvec, int silu) {
  const int64_t SC = (int64_t)S * C;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t e = i * 8;
    const int64_t b = e / SC;
    const int c = (int)(e % C);
    float y[8], sc[8], bi[8];
    load8(x + e, y);
    load8(sb + b * 2 * C + c, sc);
    load8(sb + b * 2 * C + C + c, bi);
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = __fadd_rn(__fmul_rn(y[k], sc[k]), bi[k]);
    if (ss != nullptr) {
      load8(ss + b * 2 * C + c, sc);
      load8(ss + b * 2 * C + C + c, bi);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        y[k] = __fadd_rn(__fmul_rn(y[k], __fadd_rn(1.f, sc[k])), bi[k]);
    }
    if (silu) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        y[k] = __fmul_rn(y[k], __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y[k]))));
    }
    store8(out + e, y);
  }
}

template <typename Ti, typename To>
int launch_apply(const void* x, const float* sb, const float* ss, void* out,
                 int B, int S, int C, int silu, cudaStream_t stream) {
  const int64_t nvec = (int64_t)B * S * C / 8;
  const int64_t want = (nvec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gn_apply<Ti, To><<<blocks, kThreads, 0, stream>>>(
      (const Ti*)x, sb, ss, (To*)out, S, C, nvec, silu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B,S,C] (fp32, or bf16 when x_bf16), 16-byte aligned; gamma, beta [C]
// fp32; ss [B,2C] fp32 or null; part [B,nsplit,2,C] and sb [B,2,C] fp32
// scratch; out [B,S,C] (fp32, or bf16 when out_bf16).  C % 32 == 0,
// S >= 1, 1 <= nsplit <= S.  Three launches; returns a cudaError_t.
int pd_groupnorm(const void* x, const void* gamma, const void* beta,
                 const void* ss, void* part, void* sb, void* out, int B,
                 int S, int C, int nsplit, int x_bf16, int out_bf16,
                 int silu, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || C < kGroups || C % kGroups || nsplit < 1 ||
      nsplit > S)
    return (int)cudaErrorInvalidValue;
  const int rows = (S + nsplit - 1) / nsplit;
  dim3 grid(nsplit, B);
  if (x_bf16)
    gn_stats<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (float*)part, S, C, rows);
  else
    gn_stats<float><<<grid, kThreads, 0, st>>>((const float*)x, (float*)part,
                                               S, C, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_fold<<<B, kThreads, 0, st>>>(
      (const float*)part, (const float*)gamma, (const float*)beta,
      (float*)sb, C, nsplit, (float)((double)S * (C / kGroups)), eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* sbf = (const float*)sb;
  const float* ssf = (const float*)ss;
  if (x_bf16 && out_bf16)
    return launch_apply<__nv_bfloat16, __nv_bfloat16>(x, sbf, ssf, out, B, S, C, silu, st);
  if (x_bf16)
    return launch_apply<__nv_bfloat16, float>(x, sbf, ssf, out, B, S, C, silu, st);
  if (out_bf16)
    return launch_apply<float, __nv_bfloat16>(x, sbf, ssf, out, B, S, C, silu, st);
  return launch_apply<float, float>(x, sbf, ssf, out, B, S, C, silu, st);
}

}  // extern "C"
