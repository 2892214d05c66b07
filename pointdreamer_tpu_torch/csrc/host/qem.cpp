// Quadric error metric (Garland–Heckbert) edge-collapse simplification.
//
// Native replacement for the reference's decimation paths:
//   open3d simplify_quadric_decimation (models/POCO/generate.py:283)
//   vendored libsimplify (models/POCO/eval/src/utils/libsimplify)
// Edge-collapse with a lazy min-heap, midpoint/optimal vertex placement,
// and a link-condition-lite flip guard.
//
// The port's own copy of native/qem/qem.cpp (the JAX package's host
// library), built with g++ at first use by pointdreamer_tpu_torch/ops/qem.py
// and bound with ctypes.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 qem.cpp -o libqem.so
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_set>

namespace {

struct Quadric {
  double m[10];  // symmetric 4x4: a2 ab ac ad b2 bc bd c2 cd d2
  Quadric() { std::memset(m, 0, sizeof(m)); }
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d; m[9] += d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; ++i) m[i] += o.m[i]; }
  double eval(double x, double y, double z) const {
    return m[0]*x*x + 2*m[1]*x*y + 2*m[2]*x*z + 2*m[3]*x
         + m[4]*y*y + 2*m[5]*y*z + 2*m[6]*y
         + m[7]*z*z + 2*m[8]*z + m[9];
  }
  // solve for minimizing point; returns false if near-singular
  bool optimal(double* out) const {
    double A[9] = {m[0], m[1], m[2], m[1], m[4], m[5], m[2], m[5], m[7]};
    double b[3] = {-m[3], -m[6], -m[8]};
    double det = A[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(A[3]*A[8]-A[5]*A[6])
               + A[2]*(A[3]*A[7]-A[4]*A[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    out[0] = inv*( b[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(b[1]*A[8]-A[5]*b[2])
                 + A[2]*(b[1]*A[7]-A[4]*b[2]));
    out[1] = inv*( A[0]*(b[1]*A[8]-A[5]*b[2]) - b[0]*(A[3]*A[8]-A[5]*A[6])
                 + A[2]*(A[3]*b[2]-b[1]*A[6]));
    out[2] = inv*( A[0]*(A[4]*b[2]-b[1]*A[7]) - A[1]*(A[3]*b[2]-b[1]*A[6])
                 + b[0]*(A[3]*A[7]-A[4]*A[6]));
    return true;
  }
};

// Collapse placement: quadric-optimal point, falling back to the best of
// {midpoint, v0, v1} when the normal-equation solve is singular OR lands
// far from the edge (ill-conditioned quadrics on noisy surfaces produce
// wild optimal points that the flip guard then rejects wholesale,
// stalling decimation above the target count).
void placement(const std::vector<double>& V, const Quadric& q,
               int a, int b, double* pos) {
  double mx = (V[3*a] + V[3*b]) * 0.5, my = (V[3*a+1] + V[3*b+1]) * 0.5,
         mz = (V[3*a+2] + V[3*b+2]) * 0.5;
  double ex = V[3*a] - V[3*b], ey = V[3*a+1] - V[3*b+1],
         ez = V[3*a+2] - V[3*b+2];
  double elen2 = ex*ex + ey*ey + ez*ez;
  if (q.optimal(pos)) {
    double dx = pos[0]-mx, dy = pos[1]-my, dz = pos[2]-mz;
    if (dx*dx + dy*dy + dz*dz <= 4.0 * elen2) return;
  }
  const double cand[3][3] = {{mx, my, mz},
                             {V[3*a], V[3*a+1], V[3*a+2]},
                             {V[3*b], V[3*b+1], V[3*b+2]}};
  double best = 1e300;
  for (const auto& c : cand) {
    double e = q.eval(c[0], c[1], c[2]);
    if (e < best) { best = e; pos[0]=c[0]; pos[1]=c[1]; pos[2]=c[2]; }
  }
}

struct HeapItem {
  double cost;
  int v0, v1;
  uint64_t stamp;  // validity: sum of vertex versions at push time
  bool operator<(const HeapItem& o) const { return cost > o.cost; }
};

struct Mesh {
  std::vector<double> V;            // 3*nv
  std::vector<int64_t> F;           // 3*nf
  std::vector<Quadric> Q;
  std::vector<uint32_t> version;
  std::vector<int> remap;           // union-find for collapsed verts
  std::vector<std::vector<int>> vfaces;  // incident face ids
  std::vector<char> fdead;
  // epoch-stamped scratch marks (hot path runs per CANDIDATE, including
  // rejected ones — unordered_set allocations there dominated the
  // profile; a stamped array is a compare + store)
  std::vector<uint32_t> vmark_a, vmark_b, fmark;
  uint32_t epoch = 0;

  int find(int v) {
    while (remap[v] != v) { remap[v] = remap[remap[v]]; v = remap[v]; }
    return v;
  }
};

void face_plane(const Mesh& M, int f, double* abcd) {
  const int64_t* t = &M.F[3 * f];
  const double* p0 = &M.V[3 * t[0]];
  const double* p1 = &M.V[3 * t[1]];
  const double* p2 = &M.V[3 * t[2]];
  double u[3] = {p1[0]-p0[0], p1[1]-p0[1], p1[2]-p0[2]};
  double w[3] = {p2[0]-p0[0], p2[1]-p0[1], p2[2]-p0[2]};
  double n[3] = {u[1]*w[2]-u[2]*w[1], u[2]*w[0]-u[0]*w[2],
                 u[0]*w[1]-u[1]*w[0]};
  double len = std::sqrt(n[0]*n[0]+n[1]*n[1]+n[2]*n[2]);
  if (len < 1e-14) { abcd[0]=abcd[1]=abcd[2]=abcd[3]=0; return; }
  abcd[0]=n[0]/len; abcd[1]=n[1]/len; abcd[2]=n[2]/len;
  abcd[3] = -(abcd[0]*p0[0] + abcd[1]*p0[1] + abcd[2]*p0[2]);
}

// Link condition (Dey et al. / Hoppe): collapsing (a,b) preserves a
// manifold iff the common vertex neighbors of a and b are exactly the
// opposite vertices of the faces incident on edge (a,b).  Without this,
// deep decimation (e.g. 500k -> 10k) creates fins: edges shared by >2
// faces, which downstream chart growing/packing cannot handle.
bool link_condition_ok(Mesh& M, int a, int b) {
  // epoch e: vmark_a[v]==e      -> v is a neighbor of a (na)
  //          vmark_a[v]==e+1    -> ...and already counted as common
  //          vmark_b[v]==e      -> v is an opposite vertex of an (a,b) face
  M.epoch += 2;
  const uint32_t e = M.epoch;
  int edge_faces = 0, n_opposite = 0;
  for (int f : M.vfaces[a]) {
    if (M.fdead[f]) continue;
    int vs[3];
    for (int j = 0; j < 3; ++j) vs[j] = M.find((int)M.F[3*f+j]);
    bool has_b = (vs[0]==b || vs[1]==b || vs[2]==b);
    for (int j = 0; j < 3; ++j) {
      int v = vs[j];
      if (v != a && v != b) {
        M.vmark_a[v] = e;
        if (has_b && M.vmark_b[v] != e) { M.vmark_b[v] = e; ++n_opposite; }
      }
    }
    if (has_b) ++edge_faces;
  }
  if (edge_faces > 2) return false;       // edge already non-manifold
  int common = 0;
  for (int f : M.vfaces[b]) {
    if (M.fdead[f]) continue;
    int vs[3];
    for (int j = 0; j < 3; ++j) vs[j] = M.find((int)M.F[3*f+j]);
    for (int j = 0; j < 3; ++j) {
      int v = vs[j];
      if (v != a && v != b && M.vmark_a[v] == e) {
        M.vmark_a[v] = e + 1;             // count each common vertex once
        ++common;
      }
    }
  }
  // every common neighbor must be an opposite vertex of a dying face
  return common == n_opposite && common == edge_faces;
}

bool collapse_would_flip(Mesh& M, int v_keep, int v_gone,
                         const double* newpos) {
  // check faces incident to either vertex that survive the collapse
  for (int vv : {v_keep, v_gone}) {
    for (int f : M.vfaces[vv]) {
      if (M.fdead[f]) continue;
      int64_t a = M.find(M.F[3*f]), b = M.find(M.F[3*f+1]),
              c = M.find(M.F[3*f+2]);
      bool has_keep = (a==v_keep||b==v_keep||c==v_keep);
      bool has_gone = (a==v_gone||b==v_gone||c==v_gone);
      if (has_keep && has_gone) continue;  // face dies, skip
      // normal before
      double pl0[4]; face_plane(M, f, pl0);
      // simulate: move the collapsed vertex to newpos
      double p[3][3];
      int64_t ids[3] = {a, b, c};
      for (int i = 0; i < 3; ++i) {
        int vi = (int)ids[i];
        if (vi == v_keep || vi == v_gone) {
          p[i][0]=newpos[0]; p[i][1]=newpos[1]; p[i][2]=newpos[2];
        } else {
          p[i][0]=M.V[3*vi]; p[i][1]=M.V[3*vi+1]; p[i][2]=M.V[3*vi+2];
        }
      }
      double u[3]={p[1][0]-p[0][0],p[1][1]-p[0][1],p[1][2]-p[0][2]};
      double w[3]={p[2][0]-p[0][0],p[2][1]-p[0][1],p[2][2]-p[0][2]};
      double n[3]={u[1]*w[2]-u[2]*w[1],u[2]*w[0]-u[0]*w[2],
                   u[0]*w[1]-u[1]*w[0]};
      double dot = n[0]*pl0[0]+n[1]*pl0[1]+n[2]*pl0[2];
      if (dot < 0) return true;  // normal flip
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Returns 0 on success. Caller passes pre-allocated output buffers of the
// input size; out_nv/out_nf receive actual counts.
int qem_simplify(const float* verts, int nv, const int64_t* faces, int nf,
                 int target_faces, float* out_v, int* out_nv,
                 int64_t* out_f, int* out_nf) {
  Mesh M;
  M.V.resize(3 * (size_t)nv);
  for (int i = 0; i < 3 * nv; ++i) M.V[i] = verts[i];
  M.F.assign(faces, faces + 3 * (size_t)nf);
  M.Q.assign(nv, Quadric());
  M.version.assign(nv, 0);
  M.remap.resize(nv);
  for (int i = 0; i < nv; ++i) M.remap[i] = i;
  M.vfaces.assign(nv, {});
  M.fdead.assign(nf, 0);
  M.vmark_a.assign(nv, 0);
  M.vmark_b.assign(nv, 0);
  M.fmark.assign(nf, 0);
  M.epoch = 2;

  for (int f = 0; f < nf; ++f) {
    double pl[4]; face_plane(M, f, pl);
    for (int j = 0; j < 3; ++j) {
      int v = (int)M.F[3*f+j];
      if (v < 0 || v >= nv) return 1;
      M.Q[v].add_plane(pl[0], pl[1], pl[2], pl[3]);
      M.vfaces[v].push_back(f);
    }
  }

  // candidate edges
  std::priority_queue<HeapItem> heap;
  auto push_edge = [&](int a, int b) {
    a = M.find(a); b = M.find(b);
    if (a == b) return;
    if (a > b) std::swap(a, b);
    Quadric q = M.Q[a]; q.add(M.Q[b]);
    double pos[3];
    placement(M.V, q, a, b, pos);
    double cost = q.eval(pos[0], pos[1], pos[2]);
    // shortest-edge tie-break: on exactly-flat regions every quadric cost
    // is 0 and an arbitrary collapse order lets one vertex swallow a whole
    // plane (quadratic vfaces growth + fins).  A tiny length^2 term keeps
    // coarsening uniform and valence bounded.
    double dx = M.V[3*a]-M.V[3*b], dy = M.V[3*a+1]-M.V[3*b+1],
           dz = M.V[3*a+2]-M.V[3*b+2];
    cost += 1e-9 * (dx*dx + dy*dy + dz*dz);
    heap.push({cost, a, b,
               (uint64_t)M.version[a] + (uint64_t)M.version[b]});
  };
  auto seed_heap = [&]() {
    std::unordered_set<uint64_t> seen;
    for (int f = 0; f < nf; ++f) {
      if (M.fdead[f]) continue;
      for (int j = 0; j < 3; ++j) {
        int a = M.find((int)M.F[3*f+j]), b = M.find((int)M.F[3*f+(j+1)%3]);
        if (a == b) continue;
        if (a > b) std::swap(a, b);
        uint64_t key = ((uint64_t)a << 32) | (uint32_t)b;
        if (seen.insert(key).second) push_edge(a, b);
      }
    }
  };
  seed_heap();

  int alive_faces = nf;
  // restart passes: a link/flip-rejected edge is dropped from the heap,
  // but often becomes collapsible after nearby collapses change its
  // neighborhood — reseed and retry until the target is reached or a
  // pass makes no progress.
  for (int pass = 0; pass < 8 && alive_faces > target_faces; ++pass) {
    if (pass > 0) {
      int before = alive_faces;
      seed_heap();
      if (heap.empty()) break;
      (void)before;
    }
    int at_start = alive_faces;
    long n_stale = 0, n_val = 0, n_link = 0, n_flip = 0, n_ok = 0;
  while (alive_faces > target_faces && !heap.empty()) {
    HeapItem it = heap.top(); heap.pop();
    int a = M.find(it.v0), b = M.find(it.v1);
    if (a == b) continue;
    if ((uint64_t)M.version[a] + (uint64_t)M.version[b] != it.stamp ||
        a != it.v0 || b != it.v1) { ++n_stale; continue; }  // stale

    Quadric q = M.Q[a]; q.add(M.Q[b]);
    double pos[3];
    placement(M.V, q, a, b, pos);
    // valence cap: a quadratic-growth backstop (flip/link checks scan the
    // merged incidence list, so unbounded valence is O(n^2) overall);
    // count alive faces only — stale dead entries linger in vfaces
    {
      size_t val = 0;
      for (int ff : M.vfaces[a]) if (!M.fdead[ff]) ++val;
      for (int ff : M.vfaces[b]) if (!M.fdead[ff]) ++val;
      if (val > 96) { ++n_val; continue; }
    }
    if (!link_condition_ok(M, a, b)) { ++n_link; continue; }
    if (collapse_would_flip(M, a, b, pos)) { ++n_flip; continue; }
    ++n_ok;

    // collapse b -> a
    M.remap[b] = a;
    M.V[3*a]=pos[0]; M.V[3*a+1]=pos[1]; M.V[3*a+2]=pos[2];
    M.Q[a] = q;
    M.version[a]++; M.version[b]++;

    // merge face lists, kill degenerate faces (fresh epoch: fmark dedups
    // faces, vmark_a dedups the neighbor set for re-pushes)
    M.epoch += 2;
    const uint32_t ec = M.epoch;
    std::vector<int> merged;
    merged.reserve(M.vfaces[a].size() + M.vfaces[b].size());
    for (int vv : {a, b}) {
      for (int f : M.vfaces[vv]) {
        if (M.fdead[f] || M.fmark[f] == ec) continue;
        M.fmark[f] = ec;
        int64_t x = M.find(M.F[3*f]), y = M.find(M.F[3*f+1]),
                z = M.find(M.F[3*f+2]);
        if (x == y || y == z || x == z) {
          M.fdead[f] = 1; --alive_faces;
        } else {
          merged.push_back(f);
        }
      }
    }
    M.vfaces[a] = std::move(merged);
    M.vfaces[b].clear();

    // re-push incident edges
    for (int f : M.vfaces[a]) {
      for (int j = 0; j < 3; ++j) {
        int v = M.find((int)M.F[3*f+j]);
        if (v != a && M.vmark_a[v] != ec) {
          M.vmark_a[v] = ec;
          push_edge(a, v);
        }
      }
    }
  }
    if (std::getenv("QEM_DEBUG"))
      std::fprintf(stderr,
                   "qem pass %d: alive %d stale %ld val %ld link %ld "
                   "flip %ld ok %ld\n", pass, alive_faces, n_stale, n_val,
                   n_link, n_flip, n_ok);
    if (alive_faces == at_start) break;       // no progress: stop passes
    // drain leftover stale items before the next reseed
    while (!heap.empty()) heap.pop();
  }

  // compact output
  std::vector<int> new_id(nv, -1);
  int nvo = 0, nfo = 0;
  for (int f = 0; f < nf; ++f) {
    if (M.fdead[f]) continue;
    int64_t t[3];
    bool ok = true;
    for (int j = 0; j < 3; ++j) {
      t[j] = M.find((int)M.F[3*f+j]);
    }
    if (t[0]==t[1]||t[1]==t[2]||t[0]==t[2]) ok = false;
    if (!ok) continue;
    for (int j = 0; j < 3; ++j) {
      int v = (int)t[j];
      if (new_id[v] < 0) {
        new_id[v] = nvo;
        out_v[3*nvo]=(float)M.V[3*v]; out_v[3*nvo+1]=(float)M.V[3*v+1];
        out_v[3*nvo+2]=(float)M.V[3*v+2];
        ++nvo;
      }
      out_f[3*nfo+j] = new_id[v];
    }
    ++nfo;
  }
  *out_nv = nvo;
  *out_nf = nfo;
  return 0;
}

}  // extern "C"
