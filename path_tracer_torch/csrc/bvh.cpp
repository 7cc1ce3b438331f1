// Binned-SAH BVH builder producing a flattened skip-pointer node array for
// stackless wavefront traversal on TPU.
//
// TPU-native replacement for the reference's external kdtree-ray crate
// (SAH KD-tree, ref: Cargo.toml:17, usage src/scene/internal/mod.rs:42,
// model.rs:96). A BVH with DFS-ordered nodes + escape ("skip") indices needs
// no traversal stack: a lane either descends to node i+1 on a bbox hit or
// jumps to skip[i] on a miss — exactly the control flow a masked
// lax.while_loop wants (SURVEY §7 "BVH, not KD-tree").
//
// C ABI, built with plain g++ -O3 -shared; consumed via ctypes (no pybind).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Aabb {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};

  void grow(const Aabb &o) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], o.mn[k]);
      mx[k] = std::max(mx[k], o.mx[k]);
    }
  }
  void grow_point(const float *p) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], p[k]);
      mx[k] = std::max(mx[k], p[k]);
    }
  }
  float half_area() const {
    float dx = std::max(0.0f, mx[0] - mn[0]);
    float dy = std::max(0.0f, mx[1] - mn[1]);
    float dz = std::max(0.0f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildNode {
  Aabb bounds;
  int left = -1;   // index into node pool; -1 for leaf
  int right = -1;
  int first = 0;   // leaf: first index into prim order
  int count = 0;   // leaf: number of prims
};

struct Builder {
  const float *bb_min;
  const float *bb_max;
  std::vector<float> centroid;
  std::vector<int> order;
  std::vector<BuildNode> nodes;
  int leaf_size;

  static constexpr int kBins = 16;

  Aabb prim_bounds(int p) const {
    Aabb b;
    for (int k = 0; k < 3; ++k) {
      b.mn[k] = bb_min[3 * p + k];
      b.mx[k] = bb_max[3 * p + k];
    }
    return b;
  }

  int build(int first, int count) {
    BuildNode node;
    Aabb cb;  // centroid bounds
    for (int i = first; i < first + count; ++i) {
      node.bounds.grow(prim_bounds(order[i]));
      cb.grow_point(&centroid[3 * order[i]]);
    }
    int idx = (int)nodes.size();
    nodes.push_back(node);

    if (count <= leaf_size) {
      nodes[idx].first = first;
      nodes[idx].count = count;
      return idx;
    }

    // Widest centroid axis.
    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cb.mx[k] - cb.mn[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] <= 1e-12f) {
      mid = first + count / 2;  // degenerate: all centroids coincide
    } else {
      // Binned SAH.
      struct Bin {
        Aabb b;
        int n = 0;
      } bins[kBins];
      float scale = kBins / ext[axis];
      for (int i = first; i < first + count; ++i) {
        int p = order[i];
        int bi = std::min(kBins - 1,
                          (int)((centroid[3 * p + axis] - cb.mn[axis]) * scale));
        bins[bi].b.grow(prim_bounds(p));
        bins[bi].n++;
      }
      float right_area[kBins];
      Aabb acc;
      for (int b = kBins - 1; b > 0; --b) {
        acc.grow(bins[b].b);
        right_area[b] = acc.half_area();
      }
      acc = Aabb();
      float best_cost = FLT_MAX;
      int best_split = -1;
      int left_n = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bins[b].b);
        left_n += bins[b].n;
        int right_n = count - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = acc.half_area() * left_n + right_area[b + 1] * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      if (best_split < 0) {
        mid = first + count / 2;
        int ax = axis;
        std::nth_element(order.begin() + first, order.begin() + mid,
                         order.begin() + first + count, [&](int a, int b2) {
                           return centroid[3 * a + ax] < centroid[3 * b2 + ax];
                         });
      } else {
        float split_pos = cb.mn[axis] + (best_split + 1) * (ext[axis] / kBins);
        auto it = std::partition(order.begin() + first,
                                 order.begin() + first + count, [&](int p) {
                                   return centroid[3 * p + axis] < split_pos;
                                 });
        mid = (int)(it - order.begin());
        if (mid == first || mid == first + count) mid = first + count / 2;
      }
    }

    int left = build(first, mid - first);
    int right = build(mid, first + count - mid);
    nodes[idx].left = left;
    nodes[idx].right = right;
    return idx;
  }
};

// DFS flatten with skip pointers: node i's "hit" successor is i+1; skip[i]
// is the index right after i's subtree (n_nodes at the root tail). Subtree
// sizes are computed first so every node's escape is known when visited.
int subtree_size(const std::vector<BuildNode> &nodes, int src) {
  const BuildNode &n = nodes[src];
  if (n.left < 0) return 1;
  return 1 + subtree_size(nodes, n.left) + subtree_size(nodes, n.right);
}

void flatten2(const std::vector<BuildNode> &nodes, int src, int dst,
              int escape, float *node_min, float *node_max, int *first_prim,
              int *prim_count, int *skip) {
  const BuildNode &n = nodes[src];
  std::memcpy(node_min + 3 * dst, n.bounds.mn, 3 * sizeof(float));
  std::memcpy(node_max + 3 * dst, n.bounds.mx, 3 * sizeof(float));
  skip[dst] = escape;
  if (n.left < 0) {
    first_prim[dst] = n.first;
    prim_count[dst] = n.count;
    return;
  }
  first_prim[dst] = 0;
  prim_count[dst] = 0;
  int left_sz = subtree_size(nodes, n.left);
  int left_dst = dst + 1;
  int right_dst = dst + 1 + left_sz;
  flatten2(nodes, n.left, left_dst, right_dst, node_min, node_max, first_prim,
           prim_count, skip);
  flatten2(nodes, n.right, right_dst, escape, node_min, node_max, first_prim,
           prim_count, skip);
}

}  // namespace

extern "C" {

// Returns the number of flattened nodes (<= 2*n). Outputs must be sized for
// 2*n nodes (node_min/node_max: 6*n floats; first/count/skip: 2*n ints) and
// prim_order for n ints. leaf_size >= 1.
int ptt_build_bvh(const float *bb_min, const float *bb_max, int n,
                  int leaf_size, float *node_min, float *node_max,
                  int *first_prim, int *prim_count, int *skip,
                  int *prim_order) {
  if (n <= 0) return 0;
  Builder b;
  b.bb_min = bb_min;
  b.bb_max = bb_max;
  b.leaf_size = std::max(1, leaf_size);
  b.centroid.resize(3 * n);
  for (int p = 0; p < n; ++p)
    for (int k = 0; k < 3; ++k)
      b.centroid[3 * p + k] = 0.5f * (bb_min[3 * p + k] + bb_max[3 * p + k]);
  b.order.resize(n);
  for (int i = 0; i < n; ++i) b.order[i] = i;
  b.nodes.reserve(2 * n);
  int root = b.build(0, n);

  int n_nodes = subtree_size(b.nodes, root);
  flatten2(b.nodes, root, 0, n_nodes, node_min, node_max, first_prim,
           prim_count, skip);
  std::memcpy(prim_order, b.order.data(), n * sizeof(int));
  return n_nodes;
}

}  // extern "C"
