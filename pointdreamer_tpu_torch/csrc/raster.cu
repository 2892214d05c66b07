// K1: binned z-buffer rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas kernel pointdreamer_tpu/kernels/raster_pallas.py::
// rasterize_views_binned_pallas (_binned_kernel + the XLA binning of
// _bin_faces_sorted_rect).  The per-face affine coefficients
// l_i = A_i x + B_i y + C_i and the z plane (12 floats a face, computed in
// torch exactly as _face_coefficients does) and the faces' integer pixel
// boxes come in; face_id, zbuf and barycentrics come out.
//
// Design, in place of the TPU's (8,128) tiles, K-candidate lists and
// side list (which exist for Mosaic's sublane rules):
//   1. pd_bin_pixel_boxes: the binning of raster_bin.cuh, each face's tile
//      rectangle computed here from its pixel box (x0, y0, x1, y1) / 16.
//      Faces of at most M tiles go to their tiles' lists, bigger ones to
//      the view's side list, so no face is dropped, and every buffer is
//      sized from V, F and res: no host read, no sync;
//   2. pd_raster_tiles: one block per (tile, view), one thread per pixel.
//      The tile's list and then the side list (whose faces pass the tile
//      test first, compacted by a ballot) are staged through shared
//      memory 256 candidates at a time: 12 coefficients as three 16-byte
//      loads and the rows of the face's pixel box, so that a warp (two
//      rows of the tile) skips the faces whose box misses its rows.  Every
//      thread keeps its best (z, face_id, l0, l1, l2) in registers.  The
//      winner is the lexicographic minimum of (z, face_id), so the result
//      does not depend on the (atomic) list order.
// The edge functions use __fmul_rn/__fadd_rn so that `l >= 0` and z are
// decided with the rounding of the plain torch version, op for op.
//
// What bounds it on the H100: neither HBM bytes (outputs are 20 B a pixel)
// nor FLOPs in bulk, but instruction issue in the candidate loop: every
// (tile, face) pair costs each warp whose rows the face's box meets 32
// pixel tests of ~16 fp32 operations, 4 compares and a 48-byte broadcast
// read from shared memory, so the time follows the number of pairs
// (starts[V*T]) and the rows their boxes span; the binning's atomics
// follow the pairs too.
#include "raster_bin.cuh"

namespace {

using pd_bin::kThreads;
using pd_bin::kTile;
using pd_bin::kWarps;
constexpr float kBig = 3.0e38f;

struct PixelBoxRect {
  const int* bbox;
  int res;
  __device__ __forceinline__ pd_bin::Rect operator()(int64_t vf) const {
    return pd_bin::rect_of_pixel_box(bbox + vf * 4, res);
  }
};

__device__ __forceinline__ float plane(float a, float b, float c, float x,
                                       float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__global__ void __launch_bounds__(kThreads)
raster_tiles_kernel(const float* __restrict__ cof, PixelBoxRect rect_of,
                    int F, int res, int ntx, pd_bin::Bins bins,
                    float* __restrict__ zbuf, int* __restrict__ fid,
                    float* __restrict__ bary) {
  __shared__ float4 s_cof[kThreads][3];
  __shared__ int s_fid[kThreads];
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
  const pd_bin::TileCandidates cand(bins, v, tile, ntx * ntx, F);
  const int total = cand.total();

  float bz = kBig, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int bf = -1;
  for (int base = 0; base < total; base += kThreads) {
    const int k = base + threadIdx.x;
    int f = -1;
    bool keep = false;
    if (k < total) {
      bool from_side;
      f = cand.face(k, from_side);
      keep = !from_side || rect_of((int64_t)v * F + f).has(tx, ty);
    }
    int n;
    const int slot = pd_bin::compact(keep, s_warp, n);
    if (slot >= 0) {
      const int64_t vf = (int64_t)v * F + f;
      const float4* c = reinterpret_cast<const float4*>(cof + vf * 12);
      s_cof[slot][0] = __ldg(c);
      s_cof[slot][1] = __ldg(c + 1);
      s_cof[slot][2] = __ldg(c + 2);
      s_fid[slot] = f;
      s_rows[slot] = pd_bin::pack_rows(rect_of.bbox[vf * 4 + 1],
                                       rect_of.bbox[vf * 4 + 3], ty * kTile);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (pd_bin::rows_miss(s_rows[i], warp)) continue;
      const float4 c0 = s_cof[i][0], c1 = s_cof[i][1], c2 = s_cof[i][2];
      const float l0 = plane(c0.x, c0.y, c0.z, x, y);
      const float l1 = plane(c0.w, c1.x, c1.y, x, y);
      const float l2 = plane(c1.z, c1.w, c2.x, x, y);
      const float zk = plane(c2.y, c2.z, c2.w, x, y);
      if (l0 >= 0.f && l1 >= 0.f && l2 >= 0.f && zk > 0.f) {
        const int fi = s_fid[i];
        if (zk < bz || (zk == bz && fi < bf)) {
          bz = zk; bf = fi; b0 = l0; b1 = l1; b2 = l2;
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

// bbox [V,F,4] int32 inclusive pixel boxes (empty when x0 > x1); work and
// ids int32 buffers laid out as raster_bin.cuh says.  res % 16 == 0.
int pd_bin_pixel_boxes(const void* bbox, int V, int F, int res,
                       int max_tiles, void* work, void* ids, void* stream) {
  return pd_bin::bin_faces(PixelBoxRect{(const int*)bbox, res}, V, F, res,
                           max_tiles, work, ids, (cudaStream_t)stream);
}

// cof [V,F,12] f32 (16-byte aligned); bins from pd_bin_pixel_boxes on the
// same bbox; outputs zbuf [V,res,res] f32, fid [V,res,res] i32,
// bary [V,res,res,3] f32.
int pd_raster_tiles(const void* cof, const void* bbox, int V, int F,
                    int res, int max_tiles, void* work, void* ids,
                    void* zbuf, void* fid, void* bary, void* stream) {
  const int ntx = res / kTile;
  if (V == 0 || ntx == 0) return 0;
  const dim3 grid(ntx * ntx, V);
  raster_tiles_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cof, PixelBoxRect{(const int*)bbox, res}, F, res, ntx,
      pd_bin::bins_of(work, ids, V, F, ntx * ntx, max_tiles), (float*)zbuf,
      (int*)fid, (float*)bary);
  return (int)cudaGetLastError();
}

}  // extern "C"
