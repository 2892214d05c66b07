// The face binning shared by K1 (raster.cu) and K4 (raster_legacy.cu), for
// Hopper (sm_90a).  Its CPU model is ops/raster.py::bin_faces_plain.
//
// Every view is cut into 16x16-pixel tiles.  Each face has an inclusive
// rectangle of tiles that holds every pixel centre it can cover; the
// including kernel says how it is computed (K1 from the integer pixel box
// of prepare_views, K4 from the continuous xy box of prepare_legacy), and
// an empty rectangle (an invalid, NaN or off-screen face) bins nowhere.
//   - A face whose rectangle holds at most `max_tiles` tiles (M, set once
//     in ops/raster.py::BIN_MAX_TILES) goes to the list of each of those
//     tiles.  All lists together hold at most V*F*M entries, so their
//     storage is sized from the shapes alone.
//   - A bigger face goes to its view's side list (capacity F a view),
//     which every tile of the view reads, testing the face's rectangle.
// So no face is dropped and no host read sizes anything: a wrapper
// allocates `work` and `ids` from V, F and res, and the binning is four
// operations on its stream (a memset, a count, a one-block scan and a
// fill), none of which synchronises with the host.
//
// Buffers (int32):
//   work: counts [V*T] | side_n [V] | starts [V*T + 1]
//   ids:  lists [V*F*M] | side [V, F]
// After pd_bin_*, tile t of view v (t = ty * ntx + tx, T = ntx * ntx)
// holds lists[starts[v*T + t] .. starts[v*T + t + 1]) and view v's side
// list is side[v*F .. v*F + side_n[v]).  The fill takes its slots by
// atomics, so the order inside a list differs from run to run; the tile
// kernels take the lexicographic minimum of (z, face id), which does not
// depend on it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pd_bin {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// inclusive tile rectangle; empty when x0 > x1
struct Rect {
  int x0, y0, x1, y1;
  __device__ __forceinline__ int tiles() const {
    return (x0 > x1 || y0 > y1) ? 0 : (x1 - x0 + 1) * (y1 - y0 + 1);
  }
  __device__ __forceinline__ bool has(int tx, int ty) const {
    return tx >= x0 && tx <= x1 && ty >= y0 && ty <= y1;
  }
};

__device__ __forceinline__ Rect empty_rect() { return {1, 1, 0, 0}; }

// K1: an inclusive pixel box (x0, y0, x1, y1), empty when x0 > x1, clipped
// to the screen.
__device__ __forceinline__ Rect rect_of_pixel_box(const int* b, int res) {
  const int x0 = b[0], y0 = b[1], x1 = b[2], y1 = b[3];
  if (x0 > x1 || y0 > y1 || x1 < 0 || y1 < 0 || x0 >= res || y0 >= res)
    return empty_rect();
  return {max(x0, 0) / kTile, max(y0, 0) / kTile, min(x1, res - 1) / kTile,
          min(y1, res - 1) / kTile};
}

// K4: the corners' continuous box.  Tile tx can hold a covered pixel
// centre only if fx1 >= 16 tx and fx0 < 16 tx + 16, that is
// floor(fx0 / 16) <= tx <= floor(fx1 / 16) (x / 16 is exact).  A NaN fails
// every comparison, so a NaN box is empty; culled faces sit at -1e6.
__device__ __forceinline__ Rect rect_of_xy_box(float fx0, float fy0,
                                               float fx1, float fy1,
                                               int ntx) {
  const float a0 = floorf(fx0 * 0.0625f), b0 = floorf(fy0 * 0.0625f);
  const float a1 = floorf(fx1 * 0.0625f), b1 = floorf(fy1 * 0.0625f);
  const float last = (float)(ntx - 1);
  if (!(a1 >= 0.f && b1 >= 0.f && a0 <= last && b0 <= last && a0 <= a1 &&
        b0 <= b1))
    return empty_rect();
  return {(int)fmaxf(a0, 0.f), (int)fmaxf(b0, 0.f), (int)fminf(a1, last),
          (int)fminf(b1, last)};
}

// RectOf: a functor, Rect operator()(int64_t vf) for face vf = v * F + f
template <class RectOf>
__global__ void count_kernel(RectOf rect_of, int V, int F, int ntx,
                             int max_tiles, int* __restrict__ counts,
                             int* __restrict__ side_n,
                             int* __restrict__ side) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)V * F) return;
  const int v = (int)(i / F);
  const Rect r = rect_of(i);
  const int n = r.tiles();
  if (n == 0) return;
  if (n > max_tiles) {
    const int slot = atomicAdd(side_n + v, 1);
    side[(int64_t)v * F + slot] = (int)(i - (int64_t)v * F);
    return;
  }
  int* c = counts + (int64_t)v * ntx * ntx;
  for (int ty = r.y0; ty <= r.y1; ++ty)
    for (int tx = r.x0; tx <= r.x1; ++tx) atomicAdd(c + ty * ntx + tx, 1);
}

// starts[0..n] = the exclusive scan of counts[0..n) (starts[n] the total),
// one block: each thread sums its own run of counts, a warp-shuffle scan
// of the runs, then each thread writes its run's starts.
static __global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int n, int* __restrict__ starts) {
  __shared__ int s_warp[kScanThreads / 32];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += counts[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int incl = x + (warp > 0 ? s_warp[warp - 1] : 0);
  int run = incl - own;
  for (int i = lo; i < hi; ++i) {
    starts[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) starts[n] = incl;
}

// The same walk as count_kernel, taking each slot by counting the tile's
// count back down (so the counts end at 0 and no cursor is needed).
template <class RectOf>
__global__ void fill_kernel(RectOf rect_of, int V, int F, int ntx,
                            int max_tiles, int* __restrict__ counts,
                            const int* __restrict__ starts,
                            int* __restrict__ lists) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)V * F) return;
  const int v = (int)(i / F);
  const Rect r = rect_of(i);
  const int n = r.tiles();
  if (n == 0 || n > max_tiles) return;
  const int f = (int)(i - (int64_t)v * F);
  const int64_t base = (int64_t)v * ntx * ntx;
  for (int ty = r.y0; ty <= r.y1; ++ty)
    for (int tx = r.x0; tx <= r.x1; ++tx) {
      const int64_t t = base + ty * ntx + tx;
      lists[starts[t] + atomicSub(counts + t, 1) - 1] = f;
    }
}

struct Bins {
  int* counts;         // [V*T]
  int* side_n;         // [V]
  int* starts;         // [V*T + 1]
  int* lists;          // [V*F*M]
  int* side;           // [V*F]
};

__host__ inline Bins bins_of(void* work, void* ids, int V, int F, int T,
                             int max_tiles) {
  int* w = (int*)work;
  int* d = (int*)ids;
  return {w, w + (int64_t)V * T, w + (int64_t)V * T + V, d,
          d + (int64_t)V * F * max_tiles};
}

template <class RectOf>
int bin_faces(RectOf rect_of, int V, int F, int res, int max_tiles,
              void* work, void* ids, cudaStream_t stream) {
  const int ntx = res / kTile;
  const int T = ntx * ntx;
  const Bins b = bins_of(work, ids, V, F, T, max_tiles);
  cudaError_t e = cudaMemsetAsync(b.counts, 0,
                                  ((int64_t)V * T + V) * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)V * F;
  const int blocks = (int)((n + 255) / 256);
  if (n > 0)
    count_kernel<<<blocks, 256, 0, stream>>>(rect_of, V, F, ntx, max_tiles,
                                             b.counts, b.side_n, b.side);
  scan_kernel<<<1, kScanThreads, 0, stream>>>(b.counts, V * T, b.starts);
  if (n > 0)
    fill_kernel<<<blocks, 256, 0, stream>>>(rect_of, V, F, ntx, max_tiles,
                                            b.counts, b.starts, b.lists);
  return (int)cudaGetLastError();
}

// The candidates of one tile: its own list, then its view's side list.
// Candidate k of the block is a face id and whether it came from the
// side list (and so still needs the tile test).
struct TileCandidates {
  const int* list;
  int n_list;
  const int* side;
  int n_side;

  __device__ __forceinline__ TileCandidates(const Bins& b, int v, int tile,
                                            int T, int F) {
    const int64_t t = (int64_t)v * T + tile;
    list = b.lists + b.starts[t];
    n_list = b.starts[t + 1] - b.starts[t];
    side = b.side + (int64_t)v * F;
    n_side = b.side_n[v];
  }
  __device__ __forceinline__ int total() const { return n_list + n_side; }
  // face id of candidate k < total()
  __device__ __forceinline__ int face(int k, bool& from_side) const {
    from_side = k >= n_list;
    return from_side ? side[k - n_list] : list[k];
  }
};

// Block-wide compaction of the threads that keep a candidate: returns the
// thread's slot (or -1) and the number kept in `n`.  One barrier; the
// caller's barrier after it has read the staged candidates protects
// s_warp for the next call.
__device__ __forceinline__ int compact(bool keep, int* s_warp, int& n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warp[warp] = __popc(mask);
  __syncthreads();
  int off = 0;
  n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    off += (w < warp) ? c : 0;
    n += c;
  }
  return keep ? off + __popc(mask & ((1u << lane) - 1u)) : -1;
}

// ---- the tile loop's row skip, shared by K1 and K4 ---------------------
//
// A tile kernel's block has one thread a pixel, so warp w holds the tile's
// rows 2w and 2w + 1.  A staged candidate carries the tile-local rows of
// its face's pixel box, and a warp skips (uniformly) the candidates whose
// rows miss its own two.

// Tile-local rows [r0, r1] of a face's pixel rows [y0, y1], packed as
// r0 | r1 << 8.
__device__ __forceinline__ int pack_rows(int y0, int y1, int row0) {
  return max(y0 - row0, 0) | (min(y1 - row0, kTile - 1) << 8);
}

// whether warp `warp`'s rows 2 warp, 2 warp + 1 miss the packed rows
__device__ __forceinline__ bool rows_miss(int rows, int warp) {
  return 2 * warp + 1 < (rows & 0xff) || 2 * warp > (rows >> 8);
}

}  // namespace pd_bin
