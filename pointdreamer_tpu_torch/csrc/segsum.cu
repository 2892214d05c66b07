// K3: dense per-texel segment sums of base-sorted pixel contributions, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel pointdreamer_tpu/kernels/segsum_pallas.py::
// segment_sum_expand (_kernel + _build).  The TPU version turned the sorted
// segment reduction into one-hot matmuls over scalar-prefetched 128-lane
// windows (off128, W2, BASE_SENTINEL); none of that carries over.  This
// kernel takes the natural inputs: contributions [12, K] f32 sorted by
// base texel and cum_bounds [n_tex] i32 (cum_bounds[t] = number of pixels
// with base <= t), and writes out[12, n_tex].
//
// What bounds it on the H100: bytes.  Each contribution, each bound and
// each output has to cross HBM once; the adds are one per contribution.
// A block owns a contiguous range of texels (the plan in
// pipeline/optimize.py::segment_sum_plan, one texel a thread):
//   - it reads the range's bounds once, coalesced, into shared memory;
//   - the range's contributions are one contiguous run
//     [cum[t0-1], cum[t1-1]) of each of the 12 channel rows.  The block
//     stages that run into shared memory with cp.async, 16 bytes a copy
//     where the rows allow it (4 otherwise), in chunks of `chunk`
//     contributions when the run is longer;
//   - each thread sums its texel's run for all 12 channels in run order
//     (__fadd_rn, so no contraction), carrying its sums from chunk to
//     chunk: deterministic and free of atomics, the same order as a
//     sequential sum;
//   - the 12 output rows are written coalesced, one texel a thread.
// Texels without contributions (most of the atlas) cost one bound read
// and 12 zero writes; no thread walks a run that is not its own.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 12;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// blockDim.x texels a block; shared memory: the bounds [blockDim.x + 1]
// ints, then the stage [12][chunk] floats.  kVec: 16-byte copies (K and
// the rows 16-byte aligned); the staged window then starts at a multiple
// of 4.
template <bool kVec>
__global__ void segsum_kernel(const float* __restrict__ contrib,
                              const int* __restrict__ cum, int64_t K,
                              int n_tex, int chunk, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  float* stage = reinterpret_cast<float*>(smem);
  int* cb = reinterpret_cast<int*>(smem + (size_t)kCh * chunk * 4);
  const int t0 = blockIdx.x * nt;
  const int t = t0 + threadIdx.x;
  const int n_here = min(nt, n_tex - t0);
  if (threadIdx.x == 0) cb[0] = t0 ? cum[t0 - 1] : 0;
  if (threadIdx.x < n_here) cb[threadIdx.x + 1] = cum[t];
  __syncthreads();
  const int lo = cb[0], hi = cb[n_here];
  const int my_lo = threadIdx.x < n_here ? cb[threadIdx.x] : 0;
  const int my_hi = threadIdx.x < n_here ? cb[threadIdx.x + 1] : 0;
  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;

  const int start = kVec ? (lo & ~3) : lo;
  for (int a = start; a < hi; a += chunk) {
    const int e = min(a + chunk, hi);
    if (kVec) {
      // whole 16-byte vectors from a to e (rounded up: K % 4 == 0, so the
      // last vector stays inside the row)
      const int nv = (e - a + 3) >> 2;
      for (int i = threadIdx.x; i < kCh * nv; i += nt) {
        const int c = i / nv, v = i % nv;
        cp_async16(stage + c * chunk + 4 * v, contrib + c * K + a + 4 * v);
      }
    } else {
      const int n = e - a;
      for (int i = threadIdx.x; i < kCh * n; i += nt) {
        const int c = i / n, k = i % n;
        cp_async4(stage + c * chunk + k, contrib + c * K + a + k);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int k1 = min(my_hi, e);
    for (int k = max(my_lo, a); k < k1; ++k) {
#pragma unroll
      for (int c = 0; c < kCh; ++c)
        acc[c] = __fadd_rn(acc[c], stage[c * chunk + (k - a)]);
    }
    __syncthreads();
  }
  if (threadIdx.x < n_here) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) out[(int64_t)c * n_tex + t] = acc[c];
  }
}

}  // namespace

extern "C" {

// contrib [12, K] f32, cum [n_tex] i32, out [12, n_tex] f32.  The plan:
// `texels` texels a block (one a thread, <= 1024) and runs staged `chunk`
// contributions a row at a time (a multiple of 4; the shared memory,
// 4 * (12 * chunk + texels + 1) bytes, within the default 48 KB).
int pd_segment_sum(const void* contrib, const void* cum, int64_t K, int n_tex,
                   int texels, int chunk, void* out, void* stream) {
  const size_t smem = (size_t)4 * (kCh * chunk + texels + 1);
  if (n_tex < 1 || K < 0 || K > INT32_MAX || texels < 32 || texels > 1024 ||
      chunk < 4 || chunk % 4 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_tex + texels - 1) / texels;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = K % 4 == 0 && (uintptr_t)contrib % 16 == 0;
  if (vec)
    segsum_kernel<true><<<blocks, texels, smem, st>>>(
        (const float*)contrib, (const int*)cum, K, n_tex, chunk, (float*)out);
  else
    segsum_kernel<false><<<blocks, texels, smem, st>>>(
        (const float*)contrib, (const int*)cum, K, n_tex, chunk, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
