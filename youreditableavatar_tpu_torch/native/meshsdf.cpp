// Host-side signed distance to a watertight triangle mesh.
//
// The port's own copy of youreditableavatar_tpu/native/meshsdf.cpp, built
// by youreditableavatar_tpu_torch/native/__init__.py into the package's
// _build/ directory. It replaces the reference's pysdf dependency
// (`implicit_sdf.py:231-239`): used once per run for SDF shape
// initialization (millions of point queries against a ~100k-triangle mesh).
//
// Design: median-split AABB BVH over triangles; unsigned distance by
// closest-point-on-triangle traversal with box-distance pruning; sign by
// ray-crossing parity along a fixed jittered direction (robust enough for
// watertight scan meshes; matches pysdf's contract of "positive inside" —
// we emit the conventional positive-outside and let callers flip).
//
// C ABI (ctypes):
//   void* meshsdf_build(const float* verts, int nv, const int* faces, int nf);
//   void  meshsdf_query(void* h, const float* pts, int n, float* out);
//   void  meshsdf_free(void* h);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator*(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm2(Vec3 a) { return dot(a, a); }

// Ericson, "Real-Time Collision Detection": closest point on triangle.
inline Vec3 closest_on_tri(Vec3 p, Vec3 a, Vec3 b, Vec3 c) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return a;
  Vec3 bp = p - b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return b;
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) return a + ab * (d1 / (d1 - d3));
  Vec3 cp = p - c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return c;
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) return a + ac * (d2 / (d2 - d6));
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0)
    return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)));
  float denom = 1.0f / (va + vb + vc);
  return a + ab * (vb * denom) + ac * (vc * denom);
}

struct AABB {
  Vec3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
  void grow(Vec3 p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& o) { grow(o.lo); grow(o.hi); }
  float dist2(Vec3 p) const {
    float dx = std::max({lo.x - p.x, 0.0f, p.x - hi.x});
    float dy = std::max({lo.y - p.y, 0.0f, p.y - hi.y});
    float dz = std::max({lo.z - p.z, 0.0f, p.z - hi.z});
    return dx * dx + dy * dy + dz * dz;
  }
};

struct Node {
  AABB box;
  int left = -1, right = -1;  // internal
  int start = 0, count = 0;   // leaf triangle range
};

struct MeshSDF {
  std::vector<Vec3> verts;
  std::vector<int> faces;   // 3 per tri
  std::vector<int> order;   // triangle permutation (BVH leaves)
  std::vector<Node> nodes;
  Vec3 ray_dirs[3];

  int build(std::vector<int>& idx, std::vector<Vec3>& cent, int start,
            int count) {
    Node node;
    for (int i = start; i < start + count; ++i) {
      int t = idx[i];
      node.box.grow(verts[faces[3 * t]]);
      node.box.grow(verts[faces[3 * t + 1]]);
      node.box.grow(verts[faces[3 * t + 2]]);
    }
    int id = (int)nodes.size();
    nodes.push_back(node);
    if (count <= 8) {
      nodes[id].start = start;
      nodes[id].count = count;
      return id;
    }
    Vec3 ext = node.box.hi - node.box.lo;
    int axis = 0;
    if (ext.y > ext.x && ext.y >= ext.z) axis = 1;
    else if (ext.z > ext.x && ext.z >= ext.y) axis = 2;
    int mid = start + count / 2;
    std::nth_element(
        idx.begin() + start, idx.begin() + mid, idx.begin() + start + count,
        [&](int a, int b) {
          float ca = axis == 0 ? cent[a].x : axis == 1 ? cent[a].y : cent[a].z;
          float cb = axis == 0 ? cent[b].x : axis == 1 ? cent[b].y : cent[b].z;
          return ca < cb;
        });
    int l = build(idx, cent, start, mid - start);
    int r = build(idx, cent, mid, start + count - mid);
    nodes[id].left = l;
    nodes[id].right = r;
    nodes[id].count = 0;
    return id;
  }

  float unsigned_dist2(Vec3 p) const {
    float best = 1e30f;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int ni = stack[--sp];
      const Node& n = nodes[ni];
      if (n.box.dist2(p) >= best) continue;
      if (n.count > 0) {
        for (int i = n.start; i < n.start + n.count; ++i) {
          int t = order[i];
          Vec3 q = closest_on_tri(p, verts[faces[3 * t]],
                                  verts[faces[3 * t + 1]],
                                  verts[faces[3 * t + 2]]);
          best = std::min(best, norm2(p - q));
        }
      } else {
        float dl = nodes[n.left].box.dist2(p);
        float dr = nodes[n.right].box.dist2(p);
        // Visit nearer child first.
        if (dl < dr) {
          if (dr < best) stack[sp++] = n.right;
          if (dl < best) stack[sp++] = n.left;
        } else {
          if (dl < best) stack[sp++] = n.left;
          if (dr < best) stack[sp++] = n.right;
        }
      }
    }
    return best;
  }

  // Ray-box slab test for the fixed direction.
  bool ray_hits_box(Vec3 o, Vec3 inv, const AABB& b) const {
    float t1 = (b.lo.x - o.x) * inv.x, t2 = (b.hi.x - o.x) * inv.x;
    float tmin = std::min(t1, t2), tmax = std::max(t1, t2);
    t1 = (b.lo.y - o.y) * inv.y; t2 = (b.hi.y - o.y) * inv.y;
    tmin = std::max(tmin, std::min(t1, t2));
    tmax = std::min(tmax, std::max(t1, t2));
    t1 = (b.lo.z - o.z) * inv.z; t2 = (b.hi.z - o.z) * inv.z;
    tmin = std::max(tmin, std::min(t1, t2));
    tmax = std::min(tmax, std::max(t1, t2));
    return tmax >= std::max(tmin, 0.0f);
  }

  int crossings(Vec3 o, Vec3 d) const {
    Vec3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    int count = 0;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const Node& n = nodes[stack[--sp]];
      if (!ray_hits_box(o, inv, n.box)) continue;
      if (n.count > 0) {
        for (int i = n.start; i < n.start + n.count; ++i) {
          int t = order[i];
          // Möller–Trumbore.
          Vec3 a = verts[faces[3 * t]];
          Vec3 e1 = verts[faces[3 * t + 1]] - a;
          Vec3 e2 = verts[faces[3 * t + 2]] - a;
          Vec3 pv = cross(d, e2);
          float det = dot(e1, pv);
          if (std::fabs(det) < 1e-12f) continue;
          float invdet = 1.0f / det;
          Vec3 tv = o - a;
          float u = dot(tv, pv) * invdet;
          if (u < 0 || u > 1) continue;
          Vec3 qv = cross(tv, e1);
          float v = dot(d, qv) * invdet;
          if (v < 0 || u + v > 1) continue;
          float thit = dot(e2, qv) * invdet;
          if (thit > 1e-7f) ++count;
        }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    return count;
  }
};

}  // namespace

extern "C" {

void* meshsdf_build(const float* verts, int nv, const int* faces, int nf) {
  auto* m = new MeshSDF();
  m->verts.resize(nv);
  std::memcpy(m->verts.data(), verts, sizeof(float) * 3 * nv);
  m->faces.assign(faces, faces + 3 * nf);
  // Fixed irrational-ish directions avoid axis-aligned edge degeneracies;
  // sign is decided by majority vote over three rays (robust to sparse
  // edge/degenerate-triangle hits).
  Vec3 dirs[3] = {{0.57735f, 0.267261f, 0.801784f},
                  {-0.356822f, 0.866025f, 0.350813f},
                  {0.525731f, -0.440891f, 0.727606f}};
  for (int k = 0; k < 3; ++k) {
    float n = std::sqrt(norm2(dirs[k]));
    m->ray_dirs[k] = dirs[k] * (1.0f / n);
  }

  std::vector<int> idx(nf);
  std::vector<Vec3> cent(nf);
  for (int t = 0; t < nf; ++t) {
    idx[t] = t;
    Vec3 c = m->verts[faces[3 * t]] + m->verts[faces[3 * t + 1]] +
             m->verts[faces[3 * t + 2]];
    cent[t] = c * (1.0f / 3.0f);
  }
  m->nodes.reserve(2 * nf / 8 + 2);
  m->build(idx, cent, 0, nf);
  m->order = std::move(idx);
  return m;
}

// out[i] = signed distance, POSITIVE OUTSIDE the mesh.
void meshsdf_query(void* handle, const float* pts, int n, float* out) {
  auto* m = static_cast<MeshSDF*>(handle);
#pragma omp parallel for schedule(dynamic, 256)
  for (int i = 0; i < n; ++i) {
    Vec3 p = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    float d = std::sqrt(m->unsigned_dist2(p));
    int inside_votes = 0;
    for (int k = 0; k < 3; ++k)
      inside_votes += m->crossings(p, m->ray_dirs[k]) % 2;
    out[i] = (inside_votes >= 2) ? -d : d;
  }
}

void meshsdf_free(void* handle) { delete static_cast<MeshSDF*>(handle); }

}  // extern "C"
