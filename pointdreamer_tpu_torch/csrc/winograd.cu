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
// What bounds it on the H100: by the count, operations, 2*B*H*W*Cin*Cout*4
// (16 multiplies per 4 outputs instead of 36) at the bf16 tensor-core
// rate, against one read of x and of U and one write of y.  In practice,
// data movement: 16 fp32 accumulators per output keep a block's tile at
// 64 tiles x 32 channels (128 registers a thread), so every block streams
// all of U's 16 x Cin x 32 slice from L2, and the staging, the transform
// and the operand loads all pass through shared memory.  V and U are
// bf16, so the 16 products take tensor-core operands exactly; only the
// order of the fp32 sums differs from the plain version.  The design:
//   - one block of 8 warps per 8 x 8 output tiles (16 x 16 pixels of one
//     image) x 32 output channels; the block index runs over the channel
//     blocks first, so the blocks that share an input region run together
//     and x is read from device memory about once;
//   - Cin in chunks of 16.  A chunk's input region (18 x 18 pixels x 16
//     channels, zero-filled past the border by cp.async's source size)
//     and its U slice (16 x 16 x 32) stream into a four-stage shared ring
//     by cp.async, three chunks ahead of the products;
//   - V = B^T d B of chunk c+1 is computed from the staged region while
//     chunk c multiplies, into a second V buffer, so no barrier separates
//     the transform from the products (odd warps multiply first): one
//     (tile, channel pair) a thread item, its 4 x 4 pixels read once as
//     bf16x2 words, packed bf16x2 adds (each rounds once, as the plain
//     version's fp32 add and cast do);
//   - warp w runs two of the 16 products, M[2w] and M[2w+1] [64 tiles x
//     32 channels], on mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//     registers), A fragments by ldmatrix from V, B by ldmatrix.trans
//     from U;
//   - the transform's reads and writes and the ldmatrix reads are free of
//     bank conflicts: the staged pixel (48 bytes for 16 channels) and the
//     U row (80 bytes) are padded, V's 32-byte rows swizzle their two
//     16-byte halves;
//   - after the Cin loop, M goes through shared memory (16 x 64 x 32
//     fp32, over the staging buffers) and each thread turns one tile x 8
//     channels into its 2 x 2 outputs (Y = A^T M A in fp32, the plain
//     version's add order) and stores them as 16-byte bf16 vectors.
// At [8,256,256,256] -> 256, 4.3 GB of U and 2.7 GB of input regions
// cross L2 for 0.54 GB of device memory, and each chunk moves about 138 KB
// through a block's shared memory (staging 26, region reads 32, V writes
// 32, ldmatrix reads 48).  -Xptxas -v: 212 registers a thread, no spills,
// 209,664 bytes of shared memory: one block per SM, one block barrier a
// chunk.  Neither wgmma nor a cluster is used: a wgmma version (m64n32k16
// a product) was slower, and so was a cluster of 2 or 4 blocks sharing
// each U slice by multicast bulk copies, with a cluster barrier a chunk;
// the cluster barrier alone, each block still loading its own U, already
// made it slower, and the multicast copies slower still.  So the time
// follows the chunk loop's synchronisation and shared-memory traffic more
// than U's L2 traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTY = 8, kTX = 8;           // output tiles per block
constexpr int kP = kTY * kTX;             // 64
constexpr int kCo = 32;                   // output channels per block
constexpr int kKc = 16;                   // input channels per chunk
constexpr int kThreads = 256;             // 8 warps
constexpr int kStages = 4;                // chunks in the x / U ring
constexpr int kRY = 2 * kTY + 2, kRX = 2 * kTX + 2;   // input region
constexpr int kXLd = kKc + 8;             // staged pixel stride, elements
constexpr int kULd = kCo + 8;             // U row stride
constexpr int kMLd = kCo + 8;             // M row stride (fp32)

struct Staging {
  bf16 x[kStages][kRY * kRX][kXLd];       // 62,208 B
  bf16 u[kStages][16][kKc][kULd];         // 81,920 B
  bf16 v[2][16][kP][kKc];                 // 65,536 B, 16-byte chunks swizzled
};
constexpr int kSmemM = 16 * kP * kMLd * 4;  // 163,840 B
constexpr int kSmem = sizeof(Staging) > kSmemM ? (int)sizeof(Staging) : kSmemM;

// V rows are 32 bytes (two 16-byte chunks); chunk c of row p sits at
// c ^ ((p >> 2) & 1), so the 8 rows an ldmatrix reads, and the rows a
// quarter-warp of the transform writes, fall in 8 distinct bank groups
__device__ __forceinline__ int v_chunk(int p, int c) {
  return c ^ ((p >> 2) & 1);
}

__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t hadd2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__global__ void __launch_bounds__(kThreads, 1)
wino_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ U,
                bf16* __restrict__ out, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  Staging& st = *reinterpret_cast<Staging*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int TH = H / 2, TW = W / 2;
  const int nbx = (TW + kTX - 1) / kTX, nby = (TH + kTY - 1) / kTY;
  const int n_co = Cout / kCo;
  const int o0 = (int)(blockIdx.x % n_co) * kCo;
  const int tb = (int)(blockIdx.x / n_co);          // (batch, tile block)
  const int b = tb / (nbx * nby);
  const int ty0 = (tb / nbx) % nby * kTY, tx0 = tb % nbx * kTX;
  const int py0 = 2 * ty0 - 1, px0 = 2 * tx0 - 1;  // region origin (pixels)
  const bf16* xb = x + (int64_t)b * H * W * Cin;

  // chunk c's input region and U slice into ring stage c % kStages, as one
  // cp.async group (empty past the last chunk, so the groups stay counted).
  // A thread's copies are the same every chunk but for the channel offset:
  // pixel halves i = tid + 256 k of the region, U rows (tid / 4) % 16 of
  // products tid / 64 + 4 k.
  const int nc = Cin / kKc;
  constexpr int kXCopies = (kRY * kRX * 2 + kThreads - 1) / kThreads;   // 3
  constexpr int kUCopies = 16 * kKc * (kCo / 8) / kThreads;             // 4
  const bf16* xsrc[kXCopies];
  int xvalid[kXCopies];   // 2: in the region and the image, 1: region only
#pragma unroll
  for (int k = 0; k < kXCopies; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int px = i >> 1, half = i & 1;
    const int yy = py0 + px / kRX, xx = px0 + px % kRX;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    xvalid[k] = i < kRY * kRX * 2 ? 1 + ok : 0;
    xsrc[k] = ok ? xb + ((int64_t)yy * W + xx) * Cin + 8 * half : x;
  }
  const bf16* usrc = U + ((int64_t)(threadIdx.x / 64) * Cin +
                          (threadIdx.x / 4) % kKc) * Cout +
                     o0 + 8 * (threadIdx.x % 4);
  auto load = [&](int c) {
    if (c < nc) {
      const int s = c % kStages, c0 = c * kKc;
#pragma unroll
      for (int k = 0; k < kXCopies; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (xvalid[k])
          tc::cp_async16(&st.x[s][i >> 1][8 * (i & 1)],
                         xsrc[k] + (xvalid[k] == 2 ? c0 : 0), xvalid[k] == 2);
      }
#pragma unroll
      for (int k = 0; k < kUCopies; ++k)
        tc::cp_async16(&st.u[s][threadIdx.x / 64 + 4 * k]
                            [(threadIdx.x / 4) % kKc][8 * (threadIdx.x % 4)],
                       usrc + ((int64_t)4 * k * Cin + c0) * Cout, true);
    }
    tc::cp_async_commit();
  };

  // V = B^T d B of chunk c into V buffer c % 2: one (tile, channel pair) an
  // item, two items a thread, each reading its 4 x 4 pixels once as bf16x2
  // words.  A warp takes 4 neighbouring tiles x the 8 channel pairs.
  auto transform = [&](int c) {
    const int s = c % kStages, sv = c % 2;
    const int cp = lane & 7;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int grp = warp + 8 * it;                       // 0..15
      const int i = grp >> 1, j = (grp & 1) * 4 + (lane >> 3);
      const uint32_t* d0 = reinterpret_cast<const uint32_t*>(
                               &st.x[s][2 * i * kRX + 2 * j][0]) + cp;
      uint32_t d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[r][q] = d0[(r * kRX + q) * (kXLd / 2)];
      const int p = i * kTX + j;
      uint32_t* vrow = reinterpret_cast<uint32_t*>(&st.v[sv][0][p][0]) +
                       4 * v_chunk(p, cp >> 2) + (cp & 3);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // rows of B^T d: d0-d2, d1+d2, d2-d1, d1-d3 (column q)
        uint32_t t[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          t[q] = u == 0 ? hsub2(d[0][q], d[2][q])
               : u == 1 ? hadd2(d[1][q], d[2][q])
               : u == 2 ? hsub2(d[2][q], d[1][q])
                        : hsub2(d[1][q], d[3][q]);
        constexpr int kUvWords = kP * kKc / 2;             // one V[uv]
        vrow[(4 * u + 0) * kUvWords] = hsub2(t[0], t[2]);
        vrow[(4 * u + 1) * kUvWords] = hadd2(t[1], t[2]);
        vrow[(4 * u + 2) * kUvWords] = hsub2(t[2], t[1]);
        vrow[(4 * u + 3) * kUvWords] = hsub2(t[1], t[3]);
      }
    }
  };

  // warp w: M[2w + e] (e = 0, 1), 4 m-tiles of 16 tiles x 4 n-tiles of 8
  // channels each
  float acc[2][4][4][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[e][mt][nt][r] = 0.f;

  auto multiply = [&](int c) {
    const int s = c % kStages, sv = c % 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int uv = 2 * warp + e;
      uint32_t a[4][4], bq[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int p = 16 * mt + (lane & 15);
        tc::ldmatrix_x4(a[mt], &st.v[sv][uv][p][8 * v_chunk(p, lane >> 4)]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np)
        tc::ldmatrix_x4_trans(bq[np], &st.u[s][uv][lane & 15]
                                              [16 * np + (lane >> 4) * 8]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          tc::mma_bf16(acc[e][mt][2 * np], a[mt], bq[np][0], bq[np][1]);
          tc::mma_bf16(acc[e][mt][2 * np + 1], a[mt], bq[np][2], bq[np][3]);
        }
    }
  };

  // iteration c loads chunk c+3, transforms chunk c+1 and multiplies chunk
  // c; the one barrier an iteration separates each buffer's writers from
  // its readers (stage (c+3) % 4 and V buffer (c+1) % 2 were last read in
  // iteration c-1).  Odd warps multiply first, so that half the warps keep
  // the tensor cores busy while the other half transform.
  load(0);
  load(1);
  load(2);
  tc::cp_async_wait<2>();
  __syncthreads();
  transform(0);
  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<1>();
    __syncthreads();   // chunks c, c+1 landed, V(c) written, c-1 done
    load(c + 3);
    if (warp & 1) multiply(c);
    if (c + 1 < nc) transform(c + 1);
    if (!(warp & 1)) multiply(c);
  }
  tc::cp_async_wait<0>();
  __syncthreads();     // every product done: the staging becomes M

  float (*sm)[kP][kMLd] = reinterpret_cast<float (*)[kP][kMLd]>(smem);
  {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* r0 = &sm[2 * warp + e][16 * mt + g][8 * nt + t2];
          *reinterpret_cast<float2*>(r0) =
              make_float2(acc[e][mt][nt][0], acc[e][mt][nt][1]);
          *reinterpret_cast<float2*>(r0 + 8 * kMLd) =
              make_float2(acc[e][mt][nt][2], acc[e][mt][nt][3]);
        }
  }
  __syncthreads();

  // Y = A^T M A for one tile x 8 channels a thread: rows z0 = m0 + m1 + m2,
  // z1 = m1 - m2 - m3, then the same over the columns
  const int p = threadIdx.x / 4, c8 = (threadIdx.x % 4) * 8;
  const int ty = ty0 + p / kTX, tx = tx0 + p % kTX;
  if (ty >= TH || tx >= TW) return;
  float y[2][2][8];
#pragma unroll
  for (int h4 = 0; h4 < 2; ++h4) {
    float m[16][4];
#pragma unroll
    for (int uv = 0; uv < 16; ++uv) {
      const float4 f = *reinterpret_cast<const float4*>(&sm[uv][p][c8 + 4 * h4]);
      m[uv][0] = f.x; m[uv][1] = f.y; m[uv][2] = f.z; m[uv][3] = f.w;
    }
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
        y[dy][0][4 * h4 + q] = (z[dy][0] + z[dy][1]) + z[dy][2];
        y[dy][1][4 * h4 + q] = (z[dy][1] - z[dy][2]) - z[dy][3];
      }
    }
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const uint4 pk = make_uint4(
          tc::pack_bf16(y[dy][dx][0], y[dy][dx][1]),
          tc::pack_bf16(y[dy][dx][2], y[dy][dx][3]),
          tc::pack_bf16(y[dy][dx][4], y[dy][dx][5]),
          tc::pack_bf16(y[dy][dx][6], y[dy][dx][7]));
      *reinterpret_cast<uint4*>(
          out + (((int64_t)b * H + 2 * ty + dy) * W + 2 * tx + dx) * Cout +
          o0 + c8) = pk;
    }
}

}  // namespace

extern "C" {

// x [B,H,W,Cin] bf16, U [16,Cin,Cout] bf16, out [B,H,W,Cout] bf16, all
// contiguous and 16-byte aligned.  H, W even, Cin % 16 == 0,
// Cout % 32 == 0.  Returns a cudaError_t.
int pd_winograd_conv3x3(const void* x, const void* U, void* out, int B,
                        int H, int W, int Cin, int Cout, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < kKc ||
      Cin % kKc || Cout < kCo || Cout % kCo)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * ((H / 2 + kTY - 1) / kTY) *
                         ((W / 2 + kTX - 1) / kTX) * (Cout / kCo);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wino_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  wino_mma_kernel<<<(unsigned)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)U, (bf16*)out, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
