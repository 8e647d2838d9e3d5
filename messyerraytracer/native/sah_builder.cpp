// sah_builder.cpp — native binned-SAH BVH builder.
//
// C++ implementation of the same algorithm as accel/bvh.py::build_bvh
// (binned SAH, 12 bins, MAX_LEAF_SIZE=4, DFS order, implicit left child at
// node+1, right-child index stored in left_first — the reference's
// documented BVH semantics, README.md:128-131).  The Python builder is the
// readable specification; this is the production path: building 1M
// triangles takes minutes in numpy-per-node Python and well under a second
// here.  Exposed through ctypes (see native/__init__.py) — the framework's
// native runtime component, playing the role the reference's C++ engine
// core plays around its hot loops.
//
// Bit-compatibility note: all geometry math is float32 with the same
// operation order as the numpy builder; SAH cost comparison uses float
// (see accel/bvh.py).  Tie-breaking between equal-cost splits follows
// lowest (axis, bin), matching numpy's argmin-first semantics.

#include <algorithm>
#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 12;        // README.md:128
constexpr int kMaxLeaf = 4;      // README.md:129

struct BuildContext {
  const float* tri_min;   // (N,3)
  const float* tri_max;   // (N,3)
  const float* centroid;  // (N,3)
  int32_t* order;         // (N,) permutation, mutated in place
  float* node_min;        // (2N-1,3)
  float* node_max;        // (2N-1,3)
  int32_t* left_first;    // (2N-1,)
  int32_t* count;         // (2N-1,)
  int32_t* depth;         // (2N-1,)
  int32_t* axis;          // (2N-1,) split axis (0 for leaves)
  int32_t num_nodes = 0;
  int32_t max_leaf = kMaxLeaf;   // leaf threshold (TLAS pair trees use 1)
  std::vector<int32_t> scratch;  // partition buffer
};

inline float surface_area(const float mn[3], const float mx[3]) {
  float dx = mx[0] - mn[0];
  float dy = mx[1] - mn[1];
  float dz = mx[2] - mn[2];
  if (dx < 0.f) dx = 0.f;
  if (dy < 0.f) dy = 0.f;
  if (dz < 0.f) dz = 0.f;
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

int32_t emit(BuildContext& ctx, int32_t start, int32_t end, int32_t depth) {
  const int32_t node = ctx.num_nodes++;
  const int32_t cnt = end - start;

  // node AABB over the range
  float bmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float bmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int32_t i = start; i < end; ++i) {
    const int32_t t = ctx.order[i];
    for (int a = 0; a < 3; ++a) {
      bmin[a] = std::min(bmin[a], ctx.tri_min[3 * t + a]);
      bmax[a] = std::max(bmax[a], ctx.tri_max[3 * t + a]);
    }
  }
  std::memcpy(ctx.node_min + 3 * node, bmin, 12);
  std::memcpy(ctx.node_max + 3 * node, bmax, 12);
  ctx.depth[node] = depth;

  if (cnt <= ctx.max_leaf) {
    ctx.left_first[node] = start;
    ctx.count[node] = cnt;
    return node;
  }

  // centroid bounds
  float cmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float cmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int32_t i = start; i < end; ++i) {
    const int32_t t = ctx.order[i];
    for (int a = 0; a < 3; ++a) {
      const float c = ctx.centroid[3 * t + a];
      cmin[a] = std::min(cmin[a], c);
      cmax[a] = std::max(cmax[a], c);
    }
  }

  // --- binned SAH over all 3 axes ---------------------------------
  float best_cost = FLT_MAX;
  int best_axis = -1;
  int best_bin = -1;
  for (int axis = 0; axis < 3; ++axis) {
    const float extent = cmax[axis] - cmin[axis];
    if (extent <= 1e-12f) continue;
    const float scale = static_cast<float>(kBins) / extent;

    int32_t bin_counts[kBins] = {0};
    float bin_min[kBins][3];
    float bin_max[kBins][3];
    for (int b = 0; b < kBins; ++b) {
      for (int a = 0; a < 3; ++a) {
        bin_min[b][a] = FLT_MAX;
        bin_max[b][a] = -FLT_MAX;
      }
    }
    for (int32_t i = start; i < end; ++i) {
      const int32_t t = ctx.order[i];
      int b = static_cast<int>((ctx.centroid[3 * t + axis] - cmin[axis]) * scale);
      if (b > kBins - 1) b = kBins - 1;
      ++bin_counts[b];
      for (int a = 0; a < 3; ++a) {
        bin_min[b][a] = std::min(bin_min[b][a], ctx.tri_min[3 * t + a]);
        bin_max[b][a] = std::max(bin_max[b][a], ctx.tri_max[3 * t + a]);
      }
    }

    // left prefix sweep
    float lmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float lmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    int32_t lcnt = 0;
    float lcost[kBins - 1];
    int32_t lcnt_arr[kBins - 1];
    for (int b = 0; b < kBins - 1; ++b) {
      lcnt += bin_counts[b];
      for (int a = 0; a < 3; ++a) {
        lmin[a] = std::min(lmin[a], bin_min[b][a]);
        lmax[a] = std::max(lmax[a], bin_max[b][a]);
      }
      lcnt_arr[b] = lcnt;
      lcost[b] = lcnt > 0 ? lcnt * surface_area(lmin, lmax) : FLT_MAX;
    }
    // right suffix sweep + combine
    float rmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float rmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    int32_t rcnt = 0;
    for (int b = kBins - 1; b >= 1; --b) {
      rcnt += bin_counts[b];
      for (int a = 0; a < 3; ++a) {
        rmin[a] = std::min(rmin[a], bin_min[b][a]);
        rmax[a] = std::max(rmax[a], bin_max[b][a]);
      }
      const int k = b - 1;
      if (lcnt_arr[k] <= 0 || rcnt <= 0) continue;
      const float cost = lcost[k] + rcnt * surface_area(rmin, rmax);
      // strict < keeps the lowest (axis, bin) on ties like numpy argmin
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_bin = k;
      }
    }
  }

  int32_t mid;
  int32_t used_axis = best_axis;
  if (best_axis < 0) {
    // degenerate centroids: median split on the longest AABB axis
    int axis = 0;
    float ext = bmax[0] - bmin[0];
    for (int a = 1; a < 3; ++a) {
      const float e = bmax[a] - bmin[a];
      if (e > ext) { ext = e; axis = a; }
    }
    mid = start + cnt / 2;
    std::nth_element(
        ctx.order + start, ctx.order + mid, ctx.order + end,
        [&](int32_t x, int32_t y) {
          return ctx.centroid[3 * x + axis] < ctx.centroid[3 * y + axis];
        });
    used_axis = axis;
  } else {
    // stable partition by bin (keeps relative order like numpy concat)
    const float scale = static_cast<float>(kBins) / (cmax[best_axis] - cmin[best_axis]);
    auto& left = ctx.scratch;
    left.clear();
    std::vector<int32_t> right;
    right.reserve(cnt);
    for (int32_t i = start; i < end; ++i) {
      const int32_t t = ctx.order[i];
      int b = static_cast<int>((ctx.centroid[3 * t + best_axis] - cmin[best_axis]) * scale);
      if (b > kBins - 1) b = kBins - 1;
      if (b <= best_bin) left.push_back(t); else right.push_back(t);
    }
    mid = start + static_cast<int32_t>(left.size());
    if (mid == start || mid == end) {
      // safety: never emit an empty child (matches bvh.py fallback)
      const int axis = best_axis;
      mid = start + cnt / 2;
      std::nth_element(
          ctx.order + start, ctx.order + mid, ctx.order + end,
          [&](int32_t x, int32_t y) {
            return ctx.centroid[3 * x + axis] < ctx.centroid[3 * y + axis];
          });
    } else {
      std::memcpy(ctx.order + start, left.data(), left.size() * 4);
      std::memcpy(ctx.order + mid, right.data(), right.size() * 4);
    }
  }

  ctx.count[node] = 0;
  ctx.axis[node] = used_axis;
  emit(ctx, start, mid, depth + 1);                 // left child = node+1
  const int32_t right_idx = emit(ctx, mid, end, depth + 1);
  ctx.left_first[node] = right_idx;                 // store right child
  return node;
}

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on bad input.
// All output arrays must be preallocated for 2N-1 nodes / N tris.
int32_t mrt_build_bvh(
    int32_t n,
    const float* v0, const float* v1, const float* v2,   // (N,3) each
    float* node_min, float* node_max,                    // (2N-1,3)
    int32_t* left_first, int32_t* count, int32_t* depth, // (2N-1,)
    int32_t* axis,                                       // (2N-1,)
    int32_t* tri_order) {                                // (N,)
  if (n <= 0) return -1;

  std::vector<float> tri_min(3 * n), tri_max(3 * n), centroid(3 * n);
  for (int32_t i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      const float a0 = v0[3 * i + a];
      const float a1 = v1[3 * i + a];
      const float a2 = v2[3 * i + a];
      tri_min[3 * i + a] = std::min(a0, std::min(a1, a2));
      tri_max[3 * i + a] = std::max(a0, std::max(a1, a2));
      centroid[3 * i + a] = (a0 + a1 + a2) * (1.0f / 3.0f);
    }
    tri_order[i] = i;
  }

  BuildContext ctx;
  ctx.tri_min = tri_min.data();
  ctx.tri_max = tri_max.data();
  ctx.centroid = centroid.data();
  ctx.order = tri_order;
  ctx.node_min = node_min;
  ctx.node_max = node_max;
  ctx.left_first = left_first;
  ctx.count = count;
  ctx.depth = depth;
  ctx.axis = axis;
  ctx.scratch.reserve(n);

  emit(ctx, 0, n, 0);
  return ctx.num_nodes;
}

// Same build over arbitrary primitive AABBs + centroids with a caller-
// chosen leaf threshold — the TLAS over instance world AABBs
// (scene_tlas.h:140-176 is the reference's native TLAS build; the
// traversal kernel's TLAS uses singleton leaves).
int32_t mrt_build_bvh_aabbs(
    int32_t n, int32_t max_leaf,
    const float* bmin, const float* bmax, const float* cent,  // (N,3)
    float* node_min, float* node_max,                    // (2N-1,3)
    int32_t* left_first, int32_t* count, int32_t* depth, // (2N-1,)
    int32_t* axis,                                       // (2N-1,)
    int32_t* order) {                                    // (N,)
  if (n <= 0 || max_leaf <= 0) return -1;
  for (int32_t i = 0; i < n; ++i) order[i] = i;

  BuildContext ctx;
  ctx.tri_min = bmin;
  ctx.tri_max = bmax;
  ctx.centroid = cent;
  ctx.order = order;
  ctx.node_min = node_min;
  ctx.node_max = node_max;
  ctx.left_first = left_first;
  ctx.count = count;
  ctx.depth = depth;
  ctx.axis = axis;
  ctx.max_leaf = max_leaf;
  ctx.scratch.reserve(n);

  emit(ctx, 0, n, 0);
  return ctx.num_nodes;
}

}  // extern "C"
