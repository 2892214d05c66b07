// K4: the legacy full-stream z-buffer rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas kernel pointdreamer_tpu/kernels/raster_pallas.py::
// rasterize_pallas (_kernel), which the JAX package takes for every
// rasterize_views call at a resolution divisible by 128 when
// PD_USE_PALLAS_RASTER=1.  Input per (view, face), 13 floats: the three
// pixel-space corners (ax ay bx by cx cy), their depths (z0 z1 z2) and the
// corners' continuous xy box (x0 y0 x1 y1); back faces were already moved
// to -1e6 by the wrapper when culling.  Output: face_id, zbuf (+inf when
// empty) and barycentrics per pixel.
//
// What it computes, per pixel centre (x, y) = (col + .5, row + .5), over
// the faces in ascending id:
//   w0 = (cx-bx)(y-by) - (cy-by)(x-bx)   (and w1, w2 cyclically)
//   l_i = w_i * inv_area, inv_area = 1/area if |area| > 1e-12 else 0
//   z = l0 z0 + l1 z1 + l2 z2
//   covered if all l_i >= 0, |area| > 1e-12 and z > 0; a face replaces the
//   winner only when its z is strictly smaller, so ties keep the lower id.
//
// What bounds it on the H100: the face stream.  Every block reads every
// face's box (16 B a face from L2) and the pixels then test only the faces
// whose box meets the block, so the time follows views x blocks x faces
// box tests plus the covered (pixel, face) pairs; device-memory bytes
// (20 B a pixel out) are far below either.
//
// Design, in place of the TPU's (8,128) tiles with a @pl.when predicate:
// one block of 16x16 threads per (16x16 pixel tile, view), every view in
// one launch.  Faces go through shared memory 256 at a time in ascending
// order: each thread tests one face's box against the block's rectangle,
// a ballot + warp-count scan compacts the faces that meet it (order kept),
// and the loading thread also computes the face's area, 1/area and edge
// differences once, so degenerate faces (never covered) are dropped there.
// The box test is on continuous coordinates (fx1 >= col0 & fx0 < col1),
// so it skips only faces that cannot cover a pixel centre of the block.
// Arithmetic uses __fmul_rn/__fsub_rn/__fadd_rn in the Pallas kernel's
// order (no FMA contraction) and __frcp_rn for the IEEE 1/area, so the
// kernel agrees with its plain torch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 13;      // floats per face in the input
constexpr int kStage = 16;      // floats per staged face

// staged layout: ax ay bx by cx cy  (cx-bx) (cy-by) (ax-cx) (ay-cy)
//                (bx-ax) (by-ay)  z0 z1 z2  inv_area
__global__ void __launch_bounds__(kThreads)
raster_legacy_kernel(const float* __restrict__ tri, int F, int res,
                     float* __restrict__ zbuf, int* __restrict__ fid,
                     float* __restrict__ bary) {
  __shared__ float s_face[kThreads][kStage];
  __shared__ int s_id[kThreads];
  __shared__ int s_warp[kWarps];
  const int v = blockIdx.z;
  const int col0 = blockIdx.x * kTile;
  const int row0 = blockIdx.y * kTile;
  const int px = col0 + (threadIdx.x % kTile);
  const int py = row0 + (threadIdx.x / kTile);
  const float x = (float)px + 0.5f;
  const float y = (float)py + 0.5f;
  const float bc0 = (float)col0, bc1 = (float)(col0 + kTile);
  const float br0 = (float)row0, br1 = (float)(row0 + kTile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* tv = tri + (int64_t)v * F * kWidth;

  float bz = __int_as_float(0x7f800000);
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int bf = -1;
  for (int base = 0; base < F; base += kThreads) {
    const int f = base + threadIdx.x;
    bool keep = false;
    float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f, cx = 0.f, cy = 0.f;
    float area = 0.f;
    const float* t = tv + (int64_t)f * kWidth;
    if (f < F) {
      const float fx0 = t[9], fy0 = t[10], fx1 = t[11], fy1 = t[12];
      if (fx1 >= bc0 && fx0 < bc1 && fy1 >= br0 && fy0 < br1) {
        ax = t[0]; ay = t[1]; bx = t[2]; by = t[3]; cx = t[4]; cy = t[5];
        area = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                         __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
        keep = fabsf(area) > 1e-12f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      off += (w < warp) ? c : 0;
      n += c;
    }
    if (keep) {
      float* s = s_face[off + __popc(mask & ((1u << lane) - 1u))];
      s[0] = ax; s[1] = ay; s[2] = bx; s[3] = by; s[4] = cx; s[5] = cy;
      s[6] = __fsub_rn(cx, bx); s[7] = __fsub_rn(cy, by);
      s[8] = __fsub_rn(ax, cx); s[9] = __fsub_rn(ay, cy);
      s[10] = __fsub_rn(bx, ax); s[11] = __fsub_rn(by, ay);
      s[12] = t[6]; s[13] = t[7]; s[14] = t[8];
      s[15] = __frcp_rn(area);
      s_id[off + __popc(mask & ((1u << lane) - 1u))] = f;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* s = s_face[i];
      const float w0 = __fsub_rn(__fmul_rn(s[6], __fsub_rn(y, s[3])),
                                 __fmul_rn(s[7], __fsub_rn(x, s[2])));
      const float w1 = __fsub_rn(__fmul_rn(s[8], __fsub_rn(y, s[5])),
                                 __fmul_rn(s[9], __fsub_rn(x, s[4])));
      const float w2 = __fsub_rn(__fmul_rn(s[10], __fsub_rn(y, s[1])),
                                 __fmul_rn(s[11], __fsub_rn(x, s[0])));
      const float l0 = __fmul_rn(w0, s[15]);
      const float l1 = __fmul_rn(w1, s[15]);
      const float l2 = __fmul_rn(w2, s[15]);
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(l0, s[12]),
                                          __fmul_rn(l1, s[13])),
                                __fmul_rn(l2, s[14]));
      if (l0 >= 0.f && l1 >= 0.f && l2 >= 0.f && z > 0.f && z < bz) {
        bz = z; bf = s_id[i]; b0 = l0; b1 = l1; b2 = l2;
      }
    }
    __syncthreads();
  }
  const int64_t o = ((int64_t)v * res + py) * res + px;
  zbuf[o] = bz;
  fid[o] = bf;
  bary[o * 3 + 0] = b0;
  bary[o * 3 + 1] = b1;
  bary[o * 3 + 2] = b2;
}

}  // namespace

extern "C" {

// tri [V,F,13] f32; outputs zbuf [V,res,res] f32, fid [V,res,res] i32,
// bary [V,res,res,3] f32.  res % 16 == 0.
int pd_raster_legacy(const void* tri, int V, int F, int res, void* zbuf,
                     void* fid, void* bary, void* stream) {
  dim3 grid(res / kTile, res / kTile, V);
  raster_legacy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, F, res, (float*)zbuf, (int*)fid, (float*)bary);
  return (int)cudaGetLastError();
}

}  // extern "C"
