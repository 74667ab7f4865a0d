// Native binned-SAH BVH builder for tracer_torch.
//
// The port's own copy of the JAX package's C++ builder, kept here so that
// tracer_torch builds nothing from the other package's sources. Same
// algorithm as tracer_torch/bvh/builder.py's NumPy path: 8-bin SAH over the
// node bounds per axis (the reference's candidate planes, src/bvh.c:143-160)
// with the reference's cost form 0.125 + Nl*SAl + Nr*SAr (src/bvh.c:59-97),
// median fallback on degenerate partitions, escape-indexed preorder output.
// Loaded with ctypes by tracer_torch/bvh/native.py, which compiles it with
// g++ into build/tracer_torch/libtracer_bvh.so on first use.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct V3 { float x, y, z; };

inline V3 vmin(V3 a, V3 b) { return {std::min(a.x,b.x), std::min(a.y,b.y), std::min(a.z,b.z)}; }
inline V3 vmax(V3 a, V3 b) { return {std::max(a.x,b.x), std::max(a.y,b.y), std::max(a.z,b.z)}; }

inline float surface_area(V3 lo, V3 hi) {
  float dx = std::max(hi.x - lo.x, 0.0f);
  float dy = std::max(hi.y - lo.y, 0.0f);
  float dz = std::max(hi.z - lo.z, 0.0f);
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
  const float* centers;  // (n, 3)
  const float* radii;    // (n,)
  int n, leaf_size, num_bins, max_depth;
  V3 near_point;  // emit the child closer to this point first (preorder DFS
                  // visits left-first, so closer-first ordering makes the
                  // traversal's best-t pruning effective for rays starting
                  // near this point; the reference has no ordering at all,
                  // src/hit.c:102-103)

  std::vector<V3> prim_lo, prim_hi;
  std::vector<int> order;

  // outputs
  std::vector<float> node_min, node_max;
  std::vector<int32_t> escape, leaf_start, prim_idx;

  float axis_center(int i, int axis) const { return centers[3 * i + axis]; }

  void bounds_of(const int* idx, int count, V3& lo, V3& hi) const {
    lo = {FLT_MAX, FLT_MAX, FLT_MAX};
    hi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int k = 0; k < count; ++k) {
      lo = vmin(lo, prim_lo[idx[k]]);
      hi = vmax(hi, prim_hi[idx[k]]);
    }
  }

  // Returns the number of prims in the left part after partitioning idx
  // in-place, or 0/count when no usable SAH split exists.
  int sah_partition(int* idx, int count, V3 lo, V3 hi) {
    const int NB = num_bins;
    float best_cost = FLT_MAX;
    int best_axis = -1, best_plane = -1;
    std::vector<int> counts(NB);
    std::vector<V3> blo(NB), bhi(NB);

    for (int axis = 0; axis < 3; ++axis) {
      float lo_a = axis == 0 ? lo.x : (axis == 1 ? lo.y : lo.z);
      float hi_a = axis == 0 ? hi.x : (axis == 1 ? hi.y : hi.z);
      float span = hi_a - lo_a;
      if (span <= 0.0f) continue;
      std::fill(counts.begin(), counts.end(), 0);
      std::fill(blo.begin(), blo.end(), V3{FLT_MAX, FLT_MAX, FLT_MAX});
      std::fill(bhi.begin(), bhi.end(), V3{-FLT_MAX, -FLT_MAX, -FLT_MAX});
      for (int k = 0; k < count; ++k) {
        float t = (axis_center(idx[k], axis) - lo_a) / span;
        int b = std::min(std::max(int(t * NB), 0), NB - 1);
        counts[b]++;
        blo[b] = vmin(blo[b], prim_lo[idx[k]]);
        bhi[b] = vmax(bhi[b], prim_hi[idx[k]]);
      }
      // sweep planes 1..NB-1
      std::vector<int> nl(NB), nr(NB);
      std::vector<float> sal(NB), sar(NB);
      V3 l = {FLT_MAX, FLT_MAX, FLT_MAX}, h = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int c = 0;
      for (int b = 0; b < NB - 1; ++b) {
        c += counts[b];
        l = vmin(l, blo[b]); h = vmax(h, bhi[b]);
        nl[b] = c; sal[b] = c > 0 ? surface_area(l, h) : 0.0f;
      }
      l = {FLT_MAX, FLT_MAX, FLT_MAX}; h = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      c = 0;
      for (int b = NB - 1; b >= 1; --b) {
        c += counts[b];
        l = vmin(l, blo[b]); h = vmax(h, bhi[b]);
        nr[b - 1] = c; sar[b - 1] = c > 0 ? surface_area(l, h) : 0.0f;
      }
      for (int b = 0; b < NB - 1; ++b) {
        if (nl[b] == 0 || nr[b] == 0) continue;  // plane must split
        float cost = 0.125f + nl[b] * sal[b] + nr[b] * sar[b];
        if (cost < best_cost) { best_cost = cost; best_axis = axis; best_plane = b; }
      }
    }

    if (best_axis < 0) return 0;  // degenerate -> caller uses median
    float lo_a = best_axis == 0 ? lo.x : (best_axis == 1 ? lo.y : lo.z);
    float hi_a = best_axis == 0 ? hi.x : (best_axis == 1 ? hi.y : hi.z);
    float span = hi_a - lo_a;
    int* mid = std::partition(idx, idx + count, [&](int i) {
      float t = (axis_center(i, best_axis) - lo_a) / span;
      int b = std::min(std::max(int(t * num_bins), 0), num_bins - 1);
      return b <= best_plane;
    });
    return int(mid - idx);
  }

  int median_partition(int* idx, int count, V3 lo, V3 hi) {
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    int axis = (dx >= dy && dx >= dz) ? 0 : (dy >= dz ? 1 : 2);
    int half = std::max(count / 2, 1);
    std::nth_element(idx, idx + half, idx + count, [&](int a, int b) {
      return axis_center(a, axis) < axis_center(b, axis);
    });
    return half;
  }

  void emit(int* idx, int count, int depth) {
    int me = int(escape.size());
    V3 lo, hi;
    bounds_of(idx, count, lo, hi);
    node_min.insert(node_min.end(), {lo.x, lo.y, lo.z});
    node_max.insert(node_max.end(), {hi.x, hi.y, hi.z});
    escape.push_back(-1);
    leaf_start.push_back(-1);

    if (count <= leaf_size) {
      leaf_start[me] = int(prim_idx.size());
      for (int k = 0; k < leaf_size; ++k)
        prim_idx.push_back(k < count ? idx[k] : n);  // n = sentinel slot
      escape[me] = me + 1;
      return;
    }
    int left = 0;
    if (depth < max_depth) left = sah_partition(idx, count, lo, hi);
    if (left == 0 || left == count) left = median_partition(idx, count, lo, hi);

    // Closer-to-near_point child first (see near_point above).
    V3 llo, lhi, rlo, rhi;
    bounds_of(idx, left, llo, lhi);
    bounds_of(idx + left, count - left, rlo, rhi);
    auto dist2 = [&](V3 lo_, V3 hi_) {
      float dx = std::max({lo_.x - near_point.x, near_point.x - hi_.x, 0.0f});
      float dy = std::max({lo_.y - near_point.y, near_point.y - hi_.y, 0.0f});
      float dz = std::max({lo_.z - near_point.z, near_point.z - hi_.z, 0.0f});
      return dx * dx + dy * dy + dz * dz;
    };
    if (dist2(rlo, rhi) < dist2(llo, lhi)) {
      // Swap: rotate the right part to the front.
      std::rotate(idx, idx + left, idx + count);
      left = count - left;
    }
    emit(idx, left, depth + 1);
    emit(idx + left, count - left, depth + 1);
    escape[me] = int(escape.size());
  }
};

}  // namespace

extern "C" int tracer_build_bvh(
    const float* centers, const float* radii, int n,
    int leaf_size, int num_bins, int max_depth,
    const float* near_point /* 3 floats */,
    float* out_node_min, float* out_node_max,
    int32_t* out_escape, int32_t* out_leaf_start, int32_t* out_prim_idx,
    int32_t* out_sizes /* [num_nodes, num_prim_slots] */) {
  if (n <= 0) return -1;
  Builder b;
  b.centers = centers; b.radii = radii; b.n = n;
  b.leaf_size = leaf_size; b.num_bins = num_bins; b.max_depth = max_depth;
  b.near_point = {near_point[0], near_point[1], near_point[2]};
  b.prim_lo.resize(n); b.prim_hi.resize(n);
  for (int i = 0; i < n; ++i) {
    float r = radii[i];
    b.prim_lo[i] = {centers[3*i] - r, centers[3*i+1] - r, centers[3*i+2] - r};
    b.prim_hi[i] = {centers[3*i] + r, centers[3*i+1] + r, centers[3*i+2] + r};
  }
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  b.node_min.reserve(6 * n); b.node_max.reserve(6 * n);
  b.escape.reserve(2 * n); b.leaf_start.reserve(2 * n);
  b.prim_idx.reserve(n + n * leaf_size / std::max(leaf_size - 1, 1));
  b.emit(order.data(), n, 0);

  int m = int(b.escape.size());
  int p = int(b.prim_idx.size());
  std::copy(b.node_min.begin(), b.node_min.end(), out_node_min);
  std::copy(b.node_max.begin(), b.node_max.end(), out_node_max);
  std::copy(b.escape.begin(), b.escape.end(), out_escape);
  std::copy(b.leaf_start.begin(), b.leaf_start.end(), out_leaf_start);
  std::copy(b.prim_idx.begin(), b.prim_idx.end(), out_prim_idx);
  out_sizes[0] = m;
  out_sizes[1] = p;
  return 0;
}
