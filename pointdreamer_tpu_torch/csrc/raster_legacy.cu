// K4: the legacy z-buffer rasterizer for Hopper (sm_90a).
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
// What it computes, per pixel centre (x, y) = (col + .5, row + .5):
//   w0 = (cx-bx)(y-by) - (cy-by)(x-bx)   (and w1, w2 cyclically)
//   l_i = w_i * inv_area, inv_area = 1/area if |area| > 1e-12 else 0
//   z = l0 z0 + l1 z1 + l2 z2
//   covered if all l_i >= 0, |area| > 1e-12 and z > 0; the winner is the
//   lexicographic minimum of (z, face id), so ties keep the lower id, as
//   the Pallas kernel's strict `<` over faces in ascending id does.
//
// Design, in place of the TPU's (8,128) tiles where every tile streams
// every face under a @pl.when predicate:
//   1. pd_bin_xy_boxes: the binning of raster_bin.cuh, each face's tile
//      rectangle computed here from its continuous xy box: tile tx can
//      hold a covered pixel centre only if fx1 >= 16 tx and fx0 <
//      16 tx + 16 (the old block test, no margin needed).  Faces of at most
//      M tiles go to their tiles' lists, bigger ones to the view's side
//      list; NaN and off-screen (culled) boxes bin nowhere;
//   2. pd_raster_legacy: one block of 16x16 threads per (tile, view).  The
//      tile's list and then the side list (whose faces pass the tile test
//      first) are staged 256 at a time; the loading thread computes the
//      face's area, 1/area and edge differences once, and a ballot
//      compacts the faces with |area| > 1e-12.  As in K1 a warp (two rows
//      of the tile) skips the faces whose box rows (with the plain
//      version's one-pixel margin) miss its own, and every pixel keeps the
//      lexicographic minimum of (z, face id).
// Arithmetic uses __fmul_rn/__fsub_rn/__fadd_rn in the Pallas kernel's
// order (no FMA contraction) and __frcp_rn for the IEEE 1/area, so the
// kernel agrees with its plain torch version bit for bit.
//
// What bounds it on the H100: no longer the face stream (every block
// read all F boxes: 157M box tests at 8 x 512^2) but, as for K1,
// instruction issue in the candidate loop: every (tile, face) pair of the
// bins costs each warp whose rows the face's box meets 32 pixel
// evaluations of ~23 fp32 operations and a 64-byte broadcast read from
// shared memory, against the covered (pixel, face) pairs and the 20 B a
// pixel of output that any rasterizer needs.
#include "raster_bin.cuh"

namespace {

using pd_bin::kThreads;
using pd_bin::kTile;
using pd_bin::kWarps;
constexpr int kWidth = 13;      // floats per face in the input
constexpr float kBig = 3.0e38f;

struct XyBoxRect {
  const float* tri;
  int ntx;
  __device__ __forceinline__ pd_bin::Rect operator()(int64_t vf) const {
    const float* b = tri + vf * kWidth + 9;
    return pd_bin::rect_of_xy_box(b[0], b[1], b[2], b[3], ntx);
  }
};

// staged layout: ax ay bx by | cx cy (cx-bx) (cy-by) |
//                (ax-cx) (ay-cy) (bx-ax) (by-ay) | z0 z1 z2 inv_area
__global__ void __launch_bounds__(kThreads)
raster_legacy_kernel(const float* __restrict__ tri, XyBoxRect rect_of, int F,
                     int res, int ntx, pd_bin::Bins bins,
                     float* __restrict__ zbuf, int* __restrict__ fid,
                     float* __restrict__ bary) {
  __shared__ float4 s_face[kThreads][4];
  __shared__ int s_id[kThreads];
  __shared__ int s_rows[kThreads];
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x;
  const int v = blockIdx.y;
  const int tx = tile % ntx, ty = tile / ntx;
  const int px = tx * kTile + (threadIdx.x % kTile);
  const int py = ty * kTile + (threadIdx.x / kTile);
  const int warp = threadIdx.x >> 5;
  const float x = (float)px + 0.5f;
  const float y = (float)py + 0.5f;
  const float row0 = (float)(ty * kTile);
  const pd_bin::TileCandidates cand(bins, v, tile, ntx * ntx, F);
  const int total = cand.total();

  float bz = kBig, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int bf = -1;
  for (int base = 0; base < total; base += kThreads) {
    const int k = base + threadIdx.x;
    bool keep = false;
    int f = -1;
    float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f, cx = 0.f, cy = 0.f;
    float area = 0.f;
    const float* t = tri;
    if (k < total) {
      bool from_side;
      f = cand.face(k, from_side);
      const int64_t vf = (int64_t)v * F + f;
      t = tri + vf * kWidth;
      if (!from_side || rect_of(vf).has(tx, ty)) {
        ax = t[0]; ay = t[1]; bx = t[2]; by = t[3]; cx = t[4]; cy = t[5];
        area = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                         __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
        keep = fabsf(area) > 1e-12f;
      }
    }
    int n;
    const int slot = pd_bin::compact(keep, s_warp, n);
    if (slot >= 0) {
      float4* s = s_face[slot];
      s[0] = make_float4(ax, ay, bx, by);
      s[1] = make_float4(cx, cy, __fsub_rn(cx, bx), __fsub_rn(cy, by));
      s[2] = make_float4(__fsub_rn(ax, cx), __fsub_rn(ay, cy),
                         __fsub_rn(bx, ax), __fsub_rn(by, ay));
      s[3] = make_float4(t[6], t[7], t[8], __frcp_rn(area));
      s_id[slot] = f;
      // the rows of the xy box with a pixel's margin, as the plain
      // version's face_pixel_bbox, clipped to the tile
      const float r0 = fminf(fmaxf(floorf(t[10] - 1.f) - row0, 0.f),
                             kTile - 1.f);
      const float r1 = fminf(fmaxf(floorf(t[12] + 1.f) - row0, 0.f),
                             kTile - 1.f);
      s_rows[slot] = (int)r0 | ((int)r1 << 8);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (pd_bin::rows_miss(s_rows[i], warp)) continue;
      const float4 p = s_face[i][0], q = s_face[i][1], e = s_face[i][2],
                   d = s_face[i][3];
      // p = (ax ay bx by), q = (cx cy cx-bx cy-by), e = (ax-cx ay-cy
      // bx-ax by-ay), d = (z0 z1 z2 inv_area)
      const float w0 = __fsub_rn(__fmul_rn(q.z, __fsub_rn(y, p.w)),
                                 __fmul_rn(q.w, __fsub_rn(x, p.z)));
      const float w1 = __fsub_rn(__fmul_rn(e.x, __fsub_rn(y, q.y)),
                                 __fmul_rn(e.y, __fsub_rn(x, q.x)));
      const float w2 = __fsub_rn(__fmul_rn(e.z, __fsub_rn(y, p.y)),
                                 __fmul_rn(e.w, __fsub_rn(x, p.x)));
      const float l0 = __fmul_rn(w0, d.w);
      const float l1 = __fmul_rn(w1, d.w);
      const float l2 = __fmul_rn(w2, d.w);
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(l0, d.x),
                                          __fmul_rn(l1, d.y)),
                                __fmul_rn(l2, d.z));
      if (l0 >= 0.f && l1 >= 0.f && l2 >= 0.f && z > 0.f) {
        const int fi = s_id[i];
        if (z < bz || (z == bz && fi < bf)) {
          bz = z; bf = fi; b0 = l0; b1 = l1; b2 = l2;
        }
      }
    }
    __syncthreads();
  }
  const int64_t o = ((int64_t)v * res + py) * res + px;
  zbuf[o] = bf >= 0 ? bz : __int_as_float(0x7f800000);
  fid[o] = bf;
  bary[o * 3 + 0] = b0;
  bary[o * 3 + 1] = b1;
  bary[o * 3 + 2] = b2;
}

}  // namespace

extern "C" {

// tri [V,F,13] f32; work and ids int32 buffers laid out as raster_bin.cuh
// says.  res % 16 == 0.
int pd_bin_xy_boxes(const void* tri, int V, int F, int res, int max_tiles,
                    void* work, void* ids, void* stream) {
  return pd_bin::bin_faces(XyBoxRect{(const float*)tri, res / kTile}, V, F,
                           res, max_tiles, work, ids, (cudaStream_t)stream);
}

// bins from pd_bin_xy_boxes on the same tri; outputs zbuf [V,res,res] f32,
// fid [V,res,res] i32, bary [V,res,res,3] f32.
int pd_raster_legacy(const void* tri, int V, int F, int res, int max_tiles,
                     void* work, void* ids, void* zbuf, void* fid,
                     void* bary, void* stream) {
  const int ntx = res / kTile;
  if (V == 0 || ntx == 0) return 0;
  const dim3 grid(ntx * ntx, V);
  raster_legacy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, XyBoxRect{(const float*)tri, ntx}, F, res, ntx,
      pd_bin::bins_of(work, ids, V, F, ntx * ntx, max_tiles), (float*)zbuf,
      (int*)fid, (float*)bary);
  return (int)cudaGetLastError();
}

}  // extern "C"
