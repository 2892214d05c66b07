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
// K7 (pd_quantize_act): x bf16 or fp32, channels last [B, S, C] (the
// torso's NHWC activations, S = H * W, or the attention's [b, t, c]), to
// int8 [B, S, C], the layout K8 reads.  The amax is either reduced here (a
// grid-stride pass of 16-byte loads, a warp and block max, one atomicMax
// a block on the int bits of the non-negative float, exact) or read from
// a device pointer (a static per-step scale); it is optionally written to
// a calibration slot.  ax goes to a device scalar: nothing is read back
// to the host.  The quantize divides (IEEE, no fast math) and rounds half
// to even (rintf), as jnp.round does.  Bound: bytes (x read once and int8
// written; a dynamic amax reads x a second time).  The quantize is
// elementwise: 16-byte loads, 8-byte stores.  After a dynamic amax pass
// (which walks x forward) the quantize pass walks it backward, so what the
// amax pass read last, still in the 50 MB L2, is read first.
//
// K8 (pd_int8_conv): implicit GEMM on wgmma, fed by TMA.  M = B * Ho * Wo
// output pixels, N = Cout, K = kh * kw * Cin with k = (ky * kw + kx) * Cin
// + ci.  A (pixels x K) and B (the weights [N, K]) are both K-major, as
// wgmma's 8-bit products need.  Bound: operations (2 M N K at the int8
// tensor-core rate) at the UNet's large layers.
//   Loads.  The K loop walks (tap, channel chunk) steps; a chunk is 128,
// 64 or 32 channels (the largest that divides Cin), loaded with the 128-,
// 64- or 32-byte swizzle, so the tile TMA writes is the K-major swizzled
// layout the wgmma descriptors read.  A comes through a 4-D tiled tensor
// map over the NHWC input whose box is a chunk x (Wb, Hb, Bb) pixels, Wb
// * Hb * Bb = 128 (an M tile is a box of the output grid); tap (ky, kx)
// moves the box origin by (kx - pad, ky - pad), stride 2 is the map's
// element stride, and TMA fills every coordinate outside the image with
// zeros, which is the convolution's zero padding: no thread computes an
// address or tests a border.  A 1x1 convolution or a dense layer reads A
// through a 2-D map over rows.  B comes through a 2-D map over [N, K]
// with 256-row boxes, so at Cout = 256 each A tile is loaded once for all
// of N.
//   Schedule.  One persistent, warp-specialised kernel, a block an SM
// walking work units: one thread of warpgroup 0 (40 registers,
// setmaxnreg) keeps TMA loads in flight into a four-stage ring, each
// stage completing on an mbarrier; warpgroups 1 and 2 (232 registers)
// each run wgmma m64n256k32 s8 -> s32 over 64 of the tile's 128 rows with
// one wgmma group in flight, and release a stage through a second
// mbarrier.  While they run a tile's epilogue the producer loads the next
// tile's stages.
//   Epilogue, the JAX package's arithmetic in its order: acc as fp32,
// times ax * ks[n], plus b[n], each rounded apart (__fmul_rn, __fadd_rn:
// no contraction); the tile's (ax * ks[n], b[n]) are staged in shared
// memory once.  64 (bf16) or 32 (fp32) columns a pass go through a
// shared-memory tile [pixel][channel] (bf16 by stmatrix), and out as
// 16-byte vectors of a pixel's consecutive channels: the output is rows
// [M, N], NHWC.
//   Split-K.  Where the tiles fill less than the SMs (the 16^2 and 8^2
// layers) the K loop is split across work units in (tap, chunk) order;
// each stores its int32 partial sums into its own slice of a workspace,
// and the last one of a tile (a per-tile atomic counter) adds the others'
// to its own and runs the epilogue.  An atomicAdd of every partial sum
// instead (4.2 M of them at those layers) took most of their time.
// Products are <= 127^2 and K <= 9 * 2048, so every sum is an exact int32,
// and integer addition is associative: the result is bit for bit the
// plain version's in any order of the splits.
//   The launch plan (chunk, box, tiles, splits, grid) comes from the
// wrapper (kernels/quant.py::conv_plan); a shape it refuses raises
// there.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ uint32_t quant_byte(float v, float ax) {
  return static_cast<uint32_t>(static_cast<uint8_t>(quant1(v, ax)));
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
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *ax_out = ax;
    if (calib) *calib = *amax;
  }
}

// 8 consecutive values from a 16-byte aligned address, by 16-byte loads
__device__ __forceinline__ void load8(const bf16* x, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(x));
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8(const float* x, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the same layout in and out, 8 elements a thread (16-byte loads of bf16,
// 8-byte stores)
template <typename T>
__global__ void __launch_bounds__(256)
    quant_flat_kernel(const T* __restrict__ x, size_t n, int reverse,
                      const float* amax, float* ax_out, float* calib,
                      int8_t* __restrict__ q) {
  const float ax = act_scale(*amax);
  const size_t nv = n / 8;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nv;
       i += step) {
    const size_t j = reverse ? nv - 1 - i : i;
    float w[8];
    load8(x + j * 8, w);
    uint2 o;
    o.x = quant_byte(w[0], ax) | quant_byte(w[1], ax) << 8 |
          quant_byte(w[2], ax) << 16 | quant_byte(w[3], ax) << 24;
    o.y = quant_byte(w[4], ax) | quant_byte(w[5], ax) << 8 |
          quant_byte(w[6], ax) << 16 | quant_byte(w[7], ax) << 24;
    *reinterpret_cast<uint2*>(q + j * 8) = o;
  }
  for (size_t i = nv * 8 + blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       i < n; i += step)
    q[i] = quant1(to_f(x[i]), ax);
  publish(amax, ax, ax_out, calib);
}

template <typename T>
void launch_quant(const void* x, size_t n, float* amax_scratch,
                  const float* amax_static, float* calib, void* q, float* ax,
                  cudaStream_t st) {
  const float* amax = amax_static;
  const int reverse = amax_static ? 0 : 1;
  if (!amax) {
    cudaMemsetAsync(amax_scratch, 0, sizeof(float), st);
    size_t blocks = (n + kRedThreads * 8 - 1) / (kRedThreads * 8);
    blocks = blocks < 1 ? 1 : (blocks > 132 * 8 ? 132 * 8 : blocks);
    absmax_kernel<T><<<(int)blocks, kRedThreads, 0, st>>>(
        static_cast<const T*>(x), n, amax_scratch);
    amax = amax_scratch;
  }
  size_t blocks = (n / 8 + 255) / 256;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  quant_flat_kernel<T><<<(int)blocks, 256, 0, st>>>(
      static_cast<const T*>(x), n, reverse, amax, ax, calib,
      static_cast<int8_t*>(q));
}

// ---- K8 -------------------------------------------------------------

constexpr int kBM = 128, kBN = 256;       // output tile: pixels x channels
constexpr int kMaxChunk = 128;            // K bytes a stage, at most
constexpr int kStages = 4;
constexpr int kStageA = kBM * kMaxChunk;  // 16 KiB
constexpr int kStageB = kBN * kMaxChunk;  // 32 KiB
// epilogue staging, a pass of 64 (bf16) or 32 (fp32) columns: [128][64 +
// 8] bf16 or [128][32 + 4] fp32
constexpr int kEpiBytes = 128 * 72 * 2;
constexpr int kScBiBytes = kBN * 8;       // (ax * ks[n], b[n]) of the tile
constexpr int kConvThreads = 384;         // producer WG + 2 consumer WGs
constexpr int kConvSmem =
    1024 + kStages * (kStageA + kStageB) + kEpiBytes + kScBiBytes +
    2 * kStages * 8 + 16;

struct ConvParams {
  CUtensorMap tmap_a;                     // NHWC (4-D) or rows (2-D)
  CUtensorMap tmap_b;                     // [N, K]
  const float* ax;                        // device scalar
  const float* ks;                        // [N]
  const float* bias;                      // [N]
  void* out;
  int* ws;                                // split-K partial sums
  int* counters;                          // split-K arrivals a tile
  int B, Ho, Wo, HWo, N, M;
  int chunk, layout, cchunks, KW, stride, pad;
  int rows_mode, box_w, box_h, box_b, nbx, nby;
  int n_tiles, splits, k_iters, units;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_u32(bar)),
               "r"(count)
               : "memory");
}

// waits for the phase of `parity` to complete; a wait of more than ~10 s
// (a lost arrival) traps, so a fault ends the launch with an error rather
// than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tc::smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   tc::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(tc::smem_u32(bar)),
               "r"(tx)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major swizzled tile: start
// address, stride between 8-row groups (8 rows x the swizzle span), the
// swizzle (1: 128 B, 2: 64 B, 3: 32 B); the leading offset is unused
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B on the tensor cores, one warpgroup: m64n256k32, s8 x s8 ->
// s32, both operands K-major in shared memory (descriptors da, db)
__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// the 256 consumer threads' own barrier (the producer warpgroup is not in
// it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

struct Unit {
  int tile, split, mt, n0, q0, q1;
};

// work unit u: tile u / splits (N tiles fastest), split u % splits
__device__ __forceinline__ Unit unit_of(const ConvParams& p, int u) {
  Unit w;
  w.tile = u / p.splits;
  const int s = w.split = u - w.tile * p.splits;
  w.mt = w.tile / p.n_tiles;
  w.n0 = (w.tile - w.mt * p.n_tiles) * kBN;
  w.q0 = s * p.k_iters / p.splits;
  w.q1 = (s + 1) * p.k_iters / p.splits;
  return w;
}

// output pixel of row r of M tile mt: image b and pixel oy * Wo + ox,
// `ok` false outside the output
struct Pix {
  int b, pix;
  bool ok;
};

__device__ __forceinline__ Pix row_pixel(const ConvParams& p, int mt, int r) {
  Pix q;
  if (p.rows_mode) {
    const int m = mt * kBM + r;
    q.ok = m < p.M;
    q.b = m / p.HWo;
    q.pix = m - q.b * p.HWo;
    return q;
  }
  const int bx = mt % p.nbx, by = (mt / p.nbx) % p.nby;
  const int bb = mt / (p.nbx * p.nby);
  const int ox = bx * p.box_w + r % p.box_w;
  const int oy = by * p.box_h + (r / p.box_w) % p.box_h;
  q.b = bb * p.box_b + r / (p.box_w * p.box_h);
  q.ok = ox < p.Wo && oy < p.Ho && q.b < p.B;
  q.pix = oy * p.Wo + ox;
  return q;
}

template <bool kBf16Out>
struct EpiTraits {
  typedef typename std::conditional<kBf16Out, bf16, float>::type OutT;
  static constexpr int kVW = 16 / sizeof(OutT);     // elements a vector
  static constexpr int kPassN = kBf16Out ? 64 : 32;  // columns a pass
  static constexpr int kLdR = kPassN + kVW;          // staging row
  // copy-out: a thread stores kVW channels of every kRowStep-th row
  static constexpr int kRowStep = 256 / (kPassN / kVW);
};

// the output pixels of the four rows a consumer thread stores in every
// pass of a tile, worked out once a tile
struct EpiRows {
  Pix px[4];
};

template <bool kBf16Out>
__device__ __forceinline__ EpiRows epi_rows(const ConvParams& p, int mt,
                                            int ct) {
  typedef EpiTraits<kBf16Out> Tr;
  EpiRows e;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e.px[i] = row_pixel(p, mt, ct / (Tr::kPassN / Tr::kVW) +
                                   Tr::kRowStep * i);
  return e;
}

// columns [kPass * kPassN, (kPass + 1) * kPassN) of the tile: dequantize
// (the JAX order), stage through shared memory, store 16-byte vectors;
// then the next pass
// stmatrix: four 8x8 b16 matrices from the mma fragment layout (lane
// 4 i + t holds row i, columns 2 t, 2 t + 1 of each) to shared memory,
// lanes 8 m .. 8 m + 7 giving the addresses of matrix m's rows
__device__ __forceinline__ void stmatrix_x4(const void* row,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(tc::smem_u32(row)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// columns [kPass * kPassN, (kPass + 1) * kPassN) of the tile: dequantize
// (the JAX order), stage through shared memory, store 16-byte vectors;
// then the next pass.  Element i of acc: row 16 (ct / 32) + (lane / 4) + 8
// ((i / 2) & 1), column 8 (i / 4) + 2 (lane & 3) + (i & 1).
template <bool kBf16Out, int kPass>
__device__ __forceinline__ void epilogue(
    const ConvParams& p, const int (&acc)[128], const Unit& w, int ct,
    const EpiRows& er, typename EpiTraits<kBf16Out>::OutT* sE,
    const float2* scbi) {
  typedef EpiTraits<kBf16Out> Tr;
  typedef typename Tr::OutT OutT;
  constexpr int kVW = Tr::kVW, kPassN = Tr::kPassN, kLdR = Tr::kLdR;
  const int lane = ct & 31, rw = (ct >> 5) * 16, cbase = 2 * (lane & 3);
  consumer_sync();                        // the staging tile is free
  if constexpr (kBf16Out) {
    // two n8 column blocks (four 8x8 matrices: rows 0-7 and 8-15 of each)
    // a stmatrix
#pragma unroll
    for (int jj = 0; jj < kPassN / 16; ++jj) {
      const int j0 = kPass * kPassN / 8 + 2 * jj;
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + (m >> 1), h = m & 1;
        const float4 sb =
            *reinterpret_cast<const float4*>(&scbi[8 * j + cbase]);
        r[m] = tc::pack_bf16(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sb.x),
                      sb.y),
            __fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sb.z),
                sb.w));
      }
      const int mi = lane >> 3, k = lane & 7;
      const int cl = 8 * (j0 + (mi >> 1)) - kPass * kPassN;
      const int row = rw + 8 * (mi & 1);
      stmatrix_x4(sE + (row + k) * kLdR + cl, r);
    }
  } else {
#pragma unroll
    for (int j = kPass * kPassN / 8; j < (kPass + 1) * kPassN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cbase + e;
        const float2 sb = scbi[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), sb.x), sb.y);
          const int r = rw + (lane >> 2) + 8 * h, cl = col - kPass * kPassN;
          sE[r * kLdR + cl] = v;
        }
      }
    }
  }
  consumer_sync();
  OutT* out = static_cast<OutT*>(p.out);
  const int nb = w.n0 + kPass * kPassN;
  const int cl = (ct % (kPassN / kVW)) * kVW, n = nb + cl;
  if (n < p.N) {
    const bool vec = p.N % kVW == 0 && n + kVW <= p.N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ct / (kPassN / kVW) + Tr::kRowStep * i;
      const Pix q = er.px[i];
      if (!q.ok) continue;
      const OutT* src = sE + r * kLdR + cl;
      OutT* dst = out + ((size_t)q.b * p.HWo + q.pix) * p.N + n;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < kVW && n + k < p.N; ++k) dst[k] = src[k];
      }
    }
  }
  if constexpr ((kPass + 1) * kPassN < kBN)
    epilogue<kBf16Out, kPass + 1>(p, acc, w, ct, er, sE, scbi);
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kConvThreads, 1)
    int8_conv_kernel(const __grid_constant__ ConvParams p) {
  typedef typename EpiTraits<kBf16Out>::OutT OutT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;
  uint8_t* sB = sA + kStages * kStageA;
  OutT* sE = reinterpret_cast<OutT*>(sB + kStages * kStageB);
  float2* sScBi = reinterpret_cast<float2*>(
      reinterpret_cast<uint8_t*>(sE) + kEpiBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sScBi) + kScBiBytes);
  uint64_t* empty = full + kStages;
  volatile int* s_last = reinterpret_cast<volatile int*>(empty + kStages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);            // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t tx = (kBM + kBN) * p.chunk;
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit w = unit_of(p, u);
        int x0 = 0, y0 = 0, b0 = 0;
        if (!p.rows_mode) {
          const int bx = w.mt % p.nbx, by = (w.mt / p.nbx) % p.nby;
          x0 = bx * p.box_w * p.stride - p.pad;
          y0 = by * p.box_h * p.stride - p.pad;
          b0 = (w.mt / (p.nbx * p.nby)) * p.box_b;
        }
        for (int q = w.q0; q < w.q1; ++q) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], tx);
          const int tap = q / p.cchunks, c = (q - tap * p.cchunks) * p.chunk;
          if (p.rows_mode) {
            tma_load_2d(sA + stage * kStageA, &p.tmap_a, &full[stage], c,
                        w.mt * kBM);
          } else {
            const int ky = tap / p.KW, kx = tap - ky * p.KW;
            tma_load_4d(sA + stage * kStageA, &p.tmap_a, &full[stage], c,
                        x0 + kx, y0 + ky, b0);
          }
          tma_load_2d(sB + stage * kStageB, &p.tmap_b, &full[stage],
                      q * p.chunk, w.n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma over the ring, then the epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;            // 0..255
    const int g = ct >> 7, wq = (ct >> 5) & 3, lane = ct & 31;
    const int ksteps = p.chunk / 32;
    const uint32_t sbo = 8 * p.chunk;
    const uint32_t a0 = tc::smem_u32(sA) + g * 64 * p.chunk;
    const uint32_t b0 = tc::smem_u32(sB);
    const float axv = *p.ax;
    int stage = 0;
    uint32_t phase = 0;
    int acc[128];
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit w = unit_of(p, u);
      // this thread's column of the tile's scales and biases, loaded now
      // so the load's latency hides behind the products
      const int n = w.n0 + ct;
      const float ks_n = n < p.N ? __ldg(p.ks + n) : 0.f;
      const float b_n = n < p.N ? __ldg(p.bias + n) : 0.f;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      int prev = -1;
      for (int q = w.q0; q < w.q1; ++q) {
        mbar_wait(&full[stage], phase);
        fence_acc(acc);
        wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk)
          wgmma_s8_m64n256k32(
              acc, smem_desc(a0 + stage * kStageA + kk * 32, sbo, p.layout),
              smem_desc(b0 + stage * kStageB + kk * 32, sbo, p.layout));
        wgmma_commit();
        fence_acc(acc);
        if (prev >= 0) {
          wgmma_wait<1>();                 // the previous stage is read
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // element i of acc: row g*64 + 16 wq + lane/4 + 8 ((i/2) & 1),
      // column 8 (i/4) + 2 (lane & 3) + (i & 1)
      const int rbase = g * 64 + wq * 16 + (lane >> 2);
      const int cbase = 2 * (lane & 3);
      if (p.splits > 1) {
        // this split's partial sums to its own slice of the workspace;
        // the last split of the tile adds the others' to its own
        int* ws = p.ws + (size_t)w.tile * p.splits * kBM * kBN;
#pragma unroll
        for (int i = 0; i < 128; i += 2)
          __stcg(reinterpret_cast<int2*>(
                     ws + (size_t)w.split * kBM * kBN +
                     (rbase + 8 * ((i >> 1) & 1)) * kBN + 8 * (i >> 2) +
                     cbase),
                 make_int2(acc[i], acc[i + 1]));
        __threadfence();
        consumer_sync();
        if (ct == 0)
          *s_last = atomicAdd(p.counters + w.tile, 1) == p.splits - 1;
        consumer_sync();
        if (!*s_last) continue;
        __threadfence();
        for (int o = 0; o < p.splits; ++o) {
          if (o == w.split) continue;
#pragma unroll
          for (int i = 0; i < 128; i += 2) {
            const int2 v = __ldcg(reinterpret_cast<const int2*>(
                ws + (size_t)o * kBM * kBN +
                (rbase + 8 * ((i >> 1) & 1)) * kBN + 8 * (i >> 2) + cbase));
            acc[i] += v.x;
            acc[i + 1] += v.y;
          }
        }
      }

      // the tile's column scales and biases, read by every pass
      sScBi[ct] = make_float2(__fmul_rn(axv, ks_n), b_n);
      epilogue<kBf16Out, 0>(p, acc, w, ct, epi_rows<kBf16Out>(p, w.mt, ct),
                            sE, sScBi);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the link
// line stays the runtime's)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, const cuuint32_t* elem, int chunk) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const CUtensorMapSwizzle sw = chunk == 128   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : chunk == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kBf16Out>
cudaError_t launch_conv(const ConvParams& p, int grid, cudaStream_t st) {
  static bool attr_set = false;    // a second setting is harmless
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<kBf16Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int8_conv_kernel<kBf16Out><<<grid, kConvThreads, kConvSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pd_quantize_act(const void* x, int is_bf16, int B, int C,
                               int S, float* amax_scratch,
                               const float* amax_static, float* calib,
                               void* q, float* ax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)B * C * S;
  if (is_bf16)
    launch_quant<bf16>(x, n, amax_scratch, amax_static, calib, q, ax, st);
  else
    launch_quant<float>(x, n, amax_scratch, amax_static, calib, q, ax, st);
  return static_cast<int>(cudaGetLastError());
}

// plan (kernels/quant.py::conv_plan): chunk, rows_mode, box_w, box_h,
// box_b, nbx, nby, m_tiles, n_tiles, splits, grid.  ws: splits >
// 1, int32 [m_tiles * n_tiles * (splits * 128 * 256 + 1)], the last
// m_tiles * n_tiles (the tiles' counters) zeroed.
// Returns a cudaError, or -1 when a tensor map cannot be encoded.
extern "C" int pd_int8_conv(const void* x, const void* w, const float* ax,
                            const float* ks, const float* bias, void* out,
                            int* ws, int B, int H, int W, int Cin, int N,
                            int KH, int KW, int stride, int pad, int out_bf16,
                            const int* plan, void* stream) {
  ConvParams p;
  const int chunk = plan[0];
  p.ax = ax;
  p.ks = ks;
  p.bias = bias;
  p.out = out;
  p.B = B;
  p.Ho = (H + 2 * pad - KH) / stride + 1;
  p.Wo = (W + 2 * pad - KW) / stride + 1;
  p.N = N;
  p.HWo = p.Ho * p.Wo;
  p.M = B * p.HWo;
  p.chunk = chunk;
  p.layout = chunk == 128 ? 1 : chunk == 64 ? 2 : 3;
  p.cchunks = Cin / chunk;
  p.KW = KW;
  p.stride = stride;
  p.pad = pad;
  p.rows_mode = plan[1];
  p.box_w = plan[2];
  p.box_h = plan[3];
  p.box_b = plan[4];
  p.nbx = plan[5];
  p.nby = plan[6];
  const int m_tiles = plan[7];
  p.n_tiles = plan[8];
  p.splits = plan[9];
  const int grid = plan[10];
  p.k_iters = KH * KW * p.cchunks;
  p.units = m_tiles * p.n_tiles * p.splits;
  p.ws = ws;
  p.counters =
      ws ? ws + (size_t)m_tiles * p.n_tiles * p.splits * kBM * kBN : nullptr;
  const cuuint64_t K = (cuuint64_t)KH * KW * Cin;
  bool ok;
  if (p.rows_mode) {
    const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)p.M};
    const cuuint64_t strides[1] = {(cuuint64_t)Cin};
    const cuuint32_t box[2] = {(cuuint32_t)chunk, (cuuint32_t)kBM};
    const cuuint32_t elem[2] = {1, 1};
    ok = encode(&p.tmap_a, x, 2, dims, strides, box, elem, chunk);
  } else {
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W,
                                (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)Cin, (cuuint64_t)W * Cin,
                                   (cuuint64_t)H * W * Cin};
    const cuuint32_t box[4] = {(cuuint32_t)chunk,
                               (cuuint32_t)(p.box_w * stride),
                               (cuuint32_t)(p.box_h * stride),
                               (cuuint32_t)p.box_b};
    const cuuint32_t elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride,
                                1};
    ok = encode(&p.tmap_a, x, 4, dims, strides, box, elem, chunk);
  }
  {
    const cuuint64_t dims[2] = {K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {K};
    const cuuint32_t box[2] = {(cuuint32_t)chunk, (cuuint32_t)kBN};
    const cuuint32_t elem[2] = {1, 1};
    ok = ok && encode(&p.tmap_b, w, 2, dims, strides, box, elem, chunk);
  }
  if (!ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = out_bf16 ? launch_conv<true>(p, grid, st)
                                 : launch_conv<false>(p, grid, st);
  return static_cast<int>(e);
}
