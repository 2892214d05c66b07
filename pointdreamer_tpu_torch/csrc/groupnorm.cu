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
// write y once.  The TPU ran its phases one after another on one core
// with the sums in VMEM scratch; here the whole function is one launch of
// persistent thread-block clusters of 2, 4 or 8 blocks (portable sizes):
//   - an item is one (batch element, channel range); the range holds
//     whole groups, and the cluster's blocks split S into equal row
//     slices.  The clusters the card holds at once (one block an SM, for
//     the shared memory) walk the items.  The launch plan
//     (kernels/groupnorm.py::launch_plan) picks the cluster size and the
//     range from the card's resident-cluster counts
//     (cudaOccupancyMaxActiveClusters);
//   - pass 1: the slice streams through two shared-memory slots by
//     cp.async, one chunk summed while the next is in flight; the last two
//     chunks are the slice's first keep_rows rows, which stay.  Each
//     thread copies and reads back only its own 16-byte vectors, so the
//     stream needs no block barrier.  fp32 sums of x and x*x per channel
//     are reduced by warp shuffles and then through shared memory, in a
//     fixed order;
//   - the fold, spread over the cluster: after a cluster barrier, rank k
//     folds the range's groups k, k + ncl, ... from all blocks' sums
//     (distributed shared memory, ranks in order; mean, E[x^2] - mean^2,
//     rsqrt) and writes each group's mean and rstd into every block; a
//     second cluster barrier publishes them;
//   - pass 2: the kept rows from shared memory, then the other rows
//     streamed in again (newest first, while they may still be in L2):
//     y = x * a + c by one FMA, a and c the plain version's scale and bias
//     (with the scale-shift folded in), then SiLU; stored evict-first.
// Where a slice fits in shared memory (the UNet's 16^2 and 8^2 shapes), x
// crosses HBM once.  Where it does not (its 256^2 shapes: 32-64 MB a batch
// element, more than the on-chip memory), x is read twice, and the plan
// takes ranges of at least 256 bytes a row, which stream faster than
// narrower ones.  Statistics keep the _rn intrinsics (no contraction);
// the FMA and the SiLU's fast exp and division differ from the plain
// version by a few fp32 ulps, far below the bf16 output's ulp.
// The kernel is specialised on the scale-shift and the SiLU.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;           // blocks a cluster at most
constexpr int kGroups = 32;
constexpr int kMaxRange = 2048;          // channels one cluster owns at most
constexpr int kKeepBytes = 192 * 1024;   // the two slots a slice streams
                                         // through (its first rows stay)
constexpr int kUnroll = 4;               // vectors a thread applies at once
// dynamic shared memory (bytes): [the two slots][red: 4 x kThreads partial
// sums][bsum: the block's channel sums, read by the cluster][group mean,
// rstd, written by the cluster]
constexpr int kRedOff = kKeepBytes;
constexpr int kSumOff = kRedOff + 4 * kThreads * 4;
constexpr int kGrpOff = kSumOff + 2 * kMaxRange * 4;
constexpr int kSmem = kGrpOff + 2 * kGroups * 4;
static_assert(kSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 8 elements: 16 bytes of bf16 or 32 of fp32
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ static void copy_async(void* s,
                                                    const __nv_bfloat16* p) {
    cp_async16(s, p);
  }
  __device__ __forceinline__ void get(const void* s) {
    a = *reinterpret_cast<const uint4*>(s);
  }
  __device__ __forceinline__ void to_float(float* v) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    __stcs(reinterpret_cast<uint4*>(p), o);
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ static void copy_async(void* s,
                                                    const float* p) {
    cp_async16(s, p);
    cp_async16(reinterpret_cast<float*>(s) + 4, p + 4);
  }
  __device__ __forceinline__ void get(const void* s) {
    a = reinterpret_cast<const float4*>(s)[0];
    b = reinterpret_cast<const float4*>(s)[1];
  }
  __device__ __forceinline__ void to_float(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p + 4),
           make_float4(v[4], v[5], v[6], v[7]));
  }
};

template <typename T>
__device__ __forceinline__ void accumulate(const Vec8<T>& v, float* s,
                                           float* q) {
  float f[8];
  v.to_float(f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = __fadd_rn(s[k], f[k]);
    q[k] = __fadd_rn(q[k], __fmul_rn(f[k], f[k]));
  }
}

// grid (ncl, P): P persistent clusters of ncl blocks (along x) walk the
// items (batch element, channel range) i = y, y + P, ...; each item is one
// pass 1, the cluster's fold and one pass 2.  rows: the rows of one block's
// slice; keep_rows <= rows of them stay in shared memory.
template <typename Ti, typename To, bool kSs, bool kSilu>
__global__ void __launch_bounds__(kThreads, 1)
gn_fused(const Ti* __restrict__ x, const float* __restrict__ gamma,
         const float* __restrict__ beta, const float* __restrict__ ss,
         To* __restrict__ out, int B, int S, int C, int n_ranges, int rows,
         int keep_rows, float n, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int crange = C / n_ranges;
  const int vr = crange / 8;                    // 8-channel vectors a row
  int tpr = 1;                                  // threads along a row
  while (tpr < vr) tpr <<= 1;
  const int rp = kThreads / tpr;                // rows in flight
  const int cv = threadIdx.x % tpr, rs = threadIdx.x / tpr;
  const bool lane_on = cv < vr;
  const int r0 = rank * rows;
  const int r1 = max(r0, min(S, r0 + rows));     // empty past S
  const int kept = max(0, min(keep_rows, r1 - r0));
  const int gs = C / kGroups, ng = crange / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* keep = smem;
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* bsum = reinterpret_cast<float*>(smem + kSumOff);
  float* grp = reinterpret_cast<float*>(smem + kGrpOff);
  const int W = tpr > 32 ? tpr : 32;            // row groups of the sums
  const int ngrp = kThreads / W, g2 = threadIdx.x / W;
  const bool holder = (threadIdx.x % W) < tpr;
  const Ti* x_item = x;

  // the keep buffer is two slots of ch rows.  The rows not kept stream
  // through them in chunks of ch rows (chunk j: slice rows kept + j * ch
  // on), then the kept rows land in them for good: rows [0, ch) in slot
  // nk % 2 and [ch, kept) in slot (nk + 1) % 2.  Each thread copies,
  // reads back and overwrites only its own vectors, so the copies need
  // no block barrier.
  const int ch = (keep_rows + 1) / 2;
  const int nk = (r1 - r0 - kept + ch - 1) / ch;     // chunks not kept
  const size_t slot_bytes = (size_t)ch * crange * sizeof(Ti);
  auto at = [&](int slot, int lr) {
    return keep + slot * slot_bytes + ((size_t)lr * crange + cv * 8) *
                                          sizeof(Ti);
  };
  // chunk t of the pass-1 order: its first slice row and its length
  auto chunk = [&](int t, int& first, int& len) {
    if (t < nk) {
      first = kept + t * ch;
      len = min(ch, r1 - r0 - first);
    } else {
      first = (t - nk) * ch;
      len = max(0, min(ch, kept - first));
    }
  };
  auto fetch = [&](int t) {
    int first, len;
    chunk(t, first, len);
    if (lane_on)
      for (int lr = rs; lr < len; lr += rp)
        Vec8<Ti>::copy_async(at(t % 2, lr),
                             x_item + (int64_t)(r0 + first + lr) * C);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int item = blockIdx.y; item < B * n_ranges; item += gridDim.y) {
    const int b = item / n_ranges;
    const int c0 = (item % n_ranges) * crange;
    const int64_t base = (int64_t)b * S * C + c0 + cv * 8;
    x_item = x + base;
    To* ob = out + base;

    // ---- pass 1: fp32 sums of x and x*x per channel over the slice, a
    // chunk summed from shared memory while the next one is in flight
    float s[8], q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.f;
    fetch(0);
    for (int t = 0; t < nk + 2; ++t) {
      if (t + 1 < nk + 2) {
        fetch(t + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      int first, len;
      chunk(t, first, len);
      if (lane_on)
        for (int lr = rs; lr < len; lr += rp) {
          Vec8<Ti> v;
          v.get(at(t % 2, lr));
          accumulate(v, s, q);
        }
    }
    // lanes of a warp on the same vector (tpr < 32): a butterfly, which
    // leaves the same sum in each of them
    for (int off = tpr; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] = __fadd_rn(s[k], __shfl_xor_sync(0xffffffffu, s[k], off));
        q[k] = __fadd_rn(q[k], __shfl_xor_sync(0xffffffffu, q[k], off));
      }
    }
    // then the row groups (warps, or rows when tpr >= 32) through shared
    // memory, four of the sixteen sums at a time, in row-group order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (holder) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * j + kk;
          red[(g2 * 4 + kk) * tpr + cv] = k < 8 ? s[k] : q[k - 8];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 4 * tpr; i += kThreads) {
        const int kk = i / tpr, c = i % tpr;
        if (c < vr) {
          float acc = 0.f;
          for (int g = 0; g < ngrp; ++g)
            acc = __fadd_rn(acc, red[(g * 4 + kk) * tpr + c]);
          const int k = 4 * j + kk;
          bsum[(k / 8) * crange + c * 8 + k % 8] = acc;
        }
      }
      __syncthreads();
    }

    // the thread's 8 channels' affine and scale-shift inputs, in flight
    // while the cluster gathers
    float ga[8], be[8], s1[8], sh[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + (lane_on ? cv * 8 + k : 0);
      ga[k] = gamma[c];
      be[k] = beta[c];
      s1[k] = kSs ? ss[(int64_t)b * 2 * C + c] : 0.f;
      sh[k] = kSs ? ss[(int64_t)b * 2 * C + C + c] : 0.f;
    }

    // ---- the fold, spread over the cluster: rank k folds the range's
    // groups k, k + 8, ... (one warp a group): its lanes sum the group's
    // channels over the eight blocks' sums (channel by channel, ranks in
    // order), a butterfly adds the lanes, and the group's mean and rstd
    // go to every block of the cluster
    cluster.sync();
    for (int g = rank + ncl * warp; g < ng; g += ncl * (kThreads / 32)) {
      float ts = 0.f, tq = 0.f;
      for (int c = g * gs + lane; c < (g + 1) * gs; c += 32) {
        for (int k = 0; k < ncl; ++k) {
          const float* peer = cluster.map_shared_rank(bsum, k);
          ts = __fadd_rn(ts, peer[c]);
          tq = __fadd_rn(tq, peer[crange + c]);
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        ts = __fadd_rn(ts, __shfl_xor_sync(0xffffffffu, ts, off));
        tq = __fadd_rn(tq, __shfl_xor_sync(0xffffffffu, tq, off));
      }
      const float mean = __fdiv_rn(ts, n);
      const float var = __fsub_rn(__fdiv_rn(tq, n), __fmul_rn(mean, mean));
      const float rstd = rsqrtf(__fadd_rn(var, eps));
      if (lane < ncl) {
        float* peer = cluster.map_shared_rank(grp, lane);
        peer[g] = mean;
        peer[kGroups + g] = rstd;
      }
    }
    cluster.sync();              // every group folded; bsum free again

    // ---- pass 2: y = x * a + c, then SiLU.  The thread's 8 channels'
    // a and c stay in registers: a = gamma * rstd and c = beta - mean *
    // gamma * rstd (the plain version's scale and bias, rounded as it
    // rounds them), times (1 + s) and plus shift where there is a
    // scale-shift; one FMA an element
    float a[8], cb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int gl = (lane_on ? cv * 8 + k : 0) / gs;
      const float mean = grp[gl], rstd = grp[kGroups + gl];
      a[k] = __fmul_rn(ga[k], rstd);
      cb[k] = __fsub_rn(be[k], __fmul_rn(__fmul_rn(mean, ga[k]), rstd));
      if (kSs) {
        const float s1k = __fadd_rn(1.f, s1[k]);
        cb[k] = __fadd_rn(__fmul_rn(cb[k], s1k), sh[k]);
        a[k] = __fmul_rn(a[k], s1k);
      }
    }
    auto apply = [&](const Vec8<Ti>& v, To* dst) {
      float y[8];
      v.to_float(y);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        y[k] = fmaf(y[k], a[k], cb[k]);
        if (kSilu) y[k] = __fdividef(y[k], __fadd_rn(1.f, __expf(-y[k])));
      }
      Vec8<To>::store(dst, y);
    };
    // the kept rows, then the rows not kept again, newest first, two
    // chunks in flight
    auto emit = [&](int t) {
      int first, len;
      chunk(t, first, len);
      if (lane_on)
        for (int lr = rs; lr < len; lr += kUnroll * rp) {
          Vec8<Ti> v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (lr + u * rp < len) v[u].get(at(t % 2, lr + u * rp));
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (lr + u * rp < len)
              apply(v[u], ob + (int64_t)(r0 + first + lr + u * rp) * C);
        }
    };
    emit(nk);
    emit(nk + 1);
    if (nk > 0) {
      fetch(nk - 1);
      for (int t = nk - 1; t >= 0; --t) {
        if (t > 0) {
          fetch(t - 1);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        emit(t);
      }
    }
  }
}

// the launch of `clusters` clusters of ncl blocks
cudaLaunchConfig_t config(int ncl, int clusters, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncl, clusters, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ncl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using Kernel = void (*)(const void*, const float*, const float*,
                        const float*, void*, int, int, int, int, int, int,
                        float, float);

template <typename Ti, typename To, bool kSs, bool kSilu>
Kernel prepared() {
  static const cudaError_t e = cudaFuncSetAttribute(
      gn_fused<Ti, To, kSs, kSilu>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return e == cudaSuccess
             ? reinterpret_cast<Kernel>(gn_fused<Ti, To, kSs, kSilu>)
             : nullptr;
}

template <typename Ti, typename To>
Kernel pick(bool has_ss, bool silu) {
  if (has_ss)
    return silu ? prepared<Ti, To, true, true>()
                : prepared<Ti, To, true, false>();
  return silu ? prepared<Ti, To, false, true>()
              : prepared<Ti, To, false, false>();
}

Kernel pick(bool x_bf16, bool out_bf16, bool has_ss, bool silu) {
  using bf = __nv_bfloat16;
  if (x_bf16 && out_bf16) return pick<bf, bf>(has_ss, silu);
  if (x_bf16) return pick<bf, float>(has_ss, silu);
  if (out_bf16) return pick<float, bf>(has_ss, silu);
  return pick<float, float>(has_ss, silu);
}

}  // namespace

extern "C" {

// The launch constants the plan in kernels/groupnorm.py must respect:
// {blocks a cluster at most, kept bytes a block, channels a range at most}.
int pd_groupnorm_limits(int* out) {
  out[0] = kMaxCluster;
  out[1] = kKeepBytes;
  out[2] = kMaxRange;
  return 0;
}

// Clusters of ncl blocks that can be resident on the card at once (its
// shared memory holds one block an SM); a negative cudaError_t on failure.
int pd_groupnorm_max_clusters(int ncl, int x_bf16, int out_bf16) {
  if (ncl < 1 || ncl > kMaxCluster) return -(int)cudaErrorInvalidValue;
  Kernel k = pick(x_bf16, out_bf16, true, true);
  if (k == nullptr) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(ncl, 1, 0, &attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, (const void*)k, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// x [B,S,C] (fp32, or bf16 when x_bf16), 16-byte aligned; gamma, beta [C]
// fp32; ss [B,2C] fp32 or null; out [B,S,C] (fp32, or bf16 when
// out_bf16), 16-byte aligned.  The plan: n_ranges channel ranges of
// C / n_ranges channels (whole groups, a multiple of 8, at most
// kMaxRange), clusters of ncl blocks, slices of `rows` rows (ncl * rows
// >= S), the first keep_rows >= 1 of each kept in shared memory (two
// slots of ceil(keep_rows / 2) rows within kKeepBytes), `clusters`
// persistent clusters.  One launch; returns a cudaError_t.
int pd_groupnorm(const void* x, const void* gamma, const void* beta,
                 const void* ss, void* out, int B, int S, int C,
                 int n_ranges, int rows, int keep_rows, int ncl,
                 int clusters, int x_bf16, int out_bf16, int silu, float eps,
                 void* stream) {
  if (B < 1 || S < 1 || C < kGroups || C % kGroups || n_ranges < 1 ||
      n_ranges > kGroups || kGroups % n_ranges || ncl < 1 ||
      ncl > kMaxCluster || clusters < 1 || clusters > 65535 ||
      (int64_t)B * n_ranges > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int crange = C / n_ranges;
  const int esize = x_bf16 ? 2 : 4;
  if (crange % 8 || crange > kMaxRange || rows < 1 ||
      (int64_t)rows * ncl < S || keep_rows < 1 ||
      (int64_t)(keep_rows + 1) / 2 * 2 * crange * esize > kKeepBytes)
    return (int)cudaErrorInvalidValue;
  Kernel k = pick(x_bf16, out_bf16, ss != nullptr, silu != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(ncl, clusters, (cudaStream_t)stream, &attr);
  const float n = (float)((double)S * (C / kGroups));
  return (int)cudaLaunchKernelEx(&cfg, k, x, (const float*)gamma,
                                 (const float*)beta, (const float*)ss, out,
                                 B, S, C, n_ranges, rows, keep_rows, n, eps);
}

}  // extern "C"
