// Native BVH builder for mc_path_tracer_tpu_torch: the port's own copy of
// mc_path_tracer_tpu/native/bvh.cpp, unchanged below this comment, so both
// packages build the same tree from the same triangles.
//
// The reference's host-side builder (CUDA-RayTracer/BVH.cu): binned SAH
// (12 buckets, cost 0.125 + SAH, BVH.cu:214-253), plus Middle / EqualCounts
// splits (BVH.cu:138-209) and a Morton-code LBVH build.  It emits a
// *threaded* depth-first layout with skip links, which is what the
// traversal kernel (csrc/traversal.cu) walks: node i's first child is i+1
// and `skip[i]` is the DFS successor of its subtree.
//
// Exposed as a plain C ABI consumed through ctypes (utils/native.py), which
// builds it at first use with the system C++ compiler into build/native/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Bounds {
  Vec3 lo{1e32f, 1e32f, 1e32f};
  Vec3 hi{-1e32f, -1e32f, -1e32f};
  void grow(const Bounds &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  Vec3 extent() const { return {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z}; }
  float area() const {
    Vec3 e = extent();
    if (e.x < 0 || e.y < 0 || e.z < 0) return 0.f;
    return 2.f * (e.x * e.y + e.y * e.z + e.z * e.x);
  }
  int max_axis() const {
    Vec3 e = extent();
    if (e.x >= e.y && e.x >= e.z) return 0;
    return e.y >= e.z ? 1 : 2;
  }
};

struct PrimInfo {
  int index;
  Bounds bounds;
  Vec3 centroid;
};

struct BuildNode {
  Bounds bounds;
  int left = -1, right = -1;  // children (build indices)
  int first = 0, count = 0;   // leaf primitive range in ordered list
};

struct Builder {
  std::vector<PrimInfo> prims;
  std::vector<BuildNode> nodes;
  std::vector<int> ordered;
  int max_leaf;
  int method;  // 0 SAH, 1 Middle, 2 EqualCounts

  int make_leaf(int begin, int end, const Bounds &b) {
    BuildNode n;
    n.bounds = b;
    n.first = static_cast<int>(ordered.size());
    n.count = end - begin;
    for (int i = begin; i < end; ++i) ordered.push_back(prims[i].index);
    nodes.push_back(n);
    return static_cast<int>(nodes.size()) - 1;
  }

  int build(int begin, int end) {
    Bounds bounds;
    for (int i = begin; i < end; ++i) bounds.grow(prims[i].bounds);
    int n = end - begin;
    if (n <= 2 && n <= max_leaf) return make_leaf(begin, end, bounds);

    Bounds cb;
    for (int i = begin; i < end; ++i) cb.grow(prims[i].centroid);
    int axis = cb.max_axis();
    Vec3 ext = cb.extent();
    float ext_axis = axis == 0 ? ext.x : (axis == 1 ? ext.y : ext.z);
    auto cent = [axis](const PrimInfo &p) {
      return axis == 0 ? p.centroid.x : (axis == 1 ? p.centroid.y : p.centroid.z);
    };

    int mid = begin + n / 2;
    if (ext_axis < 1e-12f) {
      // degenerate spread: equal-count split or leaf
      if (n <= max_leaf) return make_leaf(begin, end, bounds);
      std::nth_element(prims.begin() + begin, prims.begin() + mid,
                       prims.begin() + end,
                       [&](const PrimInfo &a, const PrimInfo &b) {
                         return cent(a) < cent(b);
                       });
    } else if (method == 1) {  // Middle
      float pivot = (axis == 0 ? (cb.lo.x + cb.hi.x)
                    : axis == 1 ? (cb.lo.y + cb.hi.y)
                                : (cb.lo.z + cb.hi.z)) * 0.5f;
      auto *split = std::partition(
          prims.data() + begin, prims.data() + end,
          [&](const PrimInfo &p) { return cent(p) < pivot; });
      mid = static_cast<int>(split - prims.data());
      if (mid == begin || mid == end) mid = begin + n / 2;
    } else if (method == 2 || n <= 4) {  // EqualCounts (also tiny-n fallback)
      std::nth_element(prims.begin() + begin, prims.begin() + mid,
                       prims.begin() + end,
                       [&](const PrimInfo &a, const PrimInfo &b) {
                         return cent(a) < cent(b);
                       });
    } else {  // Binned SAH, 12 buckets, cost 0.125 + weighted child areas
      constexpr int kBuckets = 12;
      Bounds bb[kBuckets];
      int bc[kBuckets] = {0};
      float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      float inv = kBuckets / ext_axis;
      auto bucket_of = [&](const PrimInfo &p) {
        int b = static_cast<int>((cent(p) - lo) * inv);
        return std::min(b, kBuckets - 1);
      };
      for (int i = begin; i < end; ++i) {
        int b = bucket_of(prims[i]);
        bc[b]++;
        bb[b].grow(prims[i].bounds);
      }
      float cost[kBuckets - 1];
      for (int s = 0; s < kBuckets - 1; ++s) {
        Bounds b0, b1;
        int c0 = 0, c1 = 0;
        for (int j = 0; j <= s; ++j) { b0.grow(bb[j]); c0 += bc[j]; }
        for (int j = s + 1; j < kBuckets; ++j) { b1.grow(bb[j]); c1 += bc[j]; }
        cost[s] = 0.125f +
                  (c0 * b0.area() + c1 * b1.area()) / std::max(bounds.area(), 1e-30f);
      }
      int best = 0;
      for (int s = 1; s < kBuckets - 1; ++s)
        if (cost[s] < cost[best]) best = s;
      float leaf_cost = static_cast<float>(n);
      if (n > max_leaf || cost[best] < leaf_cost) {
        auto *split = std::partition(
            prims.data() + begin, prims.data() + end,
            [&](const PrimInfo &p) { return bucket_of(p) <= best; });
        mid = static_cast<int>(split - prims.data());
        if (mid == begin || mid == end) {
          mid = begin + n / 2;
          std::nth_element(prims.begin() + begin, prims.begin() + mid,
                           prims.begin() + end,
                           [&](const PrimInfo &a, const PrimInfo &b) {
                             return cent(a) < cent(b);
                           });
        }
      } else {
        return make_leaf(begin, end, bounds);
      }
    }

    BuildNode inner;
    inner.bounds = bounds;
    nodes.push_back(inner);
    int self = static_cast<int>(nodes.size()) - 1;
    int l = build(begin, mid);
    int r = build(mid, end);
    nodes[self].left = l;
    nodes[self].right = r;
    return self;
  }
};

// ---- LBVH (Morton radix build) --------------------------------------------

static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

static inline uint32_t morton3(float x, float y, float z) {
  auto clamp01 = [](float f) { return std::min(std::max(f, 0.f), 1.f); };
  uint32_t xx = static_cast<uint32_t>(clamp01(x) * 1023.f);
  uint32_t yy = static_cast<uint32_t>(clamp01(y) * 1023.f);
  uint32_t zz = static_cast<uint32_t>(clamp01(z) * 1023.f);
  return (expand_bits(xx) << 2) | (expand_bits(yy) << 1) | expand_bits(zz);
}

struct LBVHBuilder {
  // Sorted-Morton hierarchical split: recursive top-down on the sorted code
  // array (equivalent topology to Karras-style LBVH, serial build).
  std::vector<PrimInfo> prims;     // sorted by morton
  std::vector<uint32_t> codes;     // sorted
  std::vector<BuildNode> nodes;
  std::vector<int> ordered;
  int max_leaf;

  int make_leaf(int begin, int end) {
    Bounds b;
    for (int i = begin; i < end; ++i) b.grow(prims[i].bounds);
    BuildNode n;
    n.bounds = b;
    n.first = static_cast<int>(ordered.size());
    n.count = end - begin;
    for (int i = begin; i < end; ++i) ordered.push_back(prims[i].index);
    nodes.push_back(n);
    return static_cast<int>(nodes.size()) - 1;
  }

  int find_split(int begin, int end, int bit) {
    // highest differing bit partition within [begin,end)
    while (bit >= 0) {
      uint32_t mask = 1u << bit;
      if ((codes[begin] & mask) != (codes[end - 1] & mask)) {
        int lo = begin, hi = end - 1;
        while (lo < hi) {
          int mid = (lo + hi) / 2;
          if (codes[mid] & mask) hi = mid; else lo = mid + 1;
        }
        return lo;
      }
      --bit;
    }
    return (begin + end) / 2;
  }

  int build(int begin, int end, int bit) {
    int n = end - begin;
    if (n <= max_leaf) return make_leaf(begin, end);
    int mid = find_split(begin, end, bit);
    if (mid <= begin || mid >= end) mid = (begin + end) / 2;
    BuildNode inner;
    nodes.push_back(inner);
    int self = static_cast<int>(nodes.size()) - 1;
    int l = build(begin, mid, bit - 1);
    int r = build(mid, end, bit - 1);
    nodes[self].left = l;
    nodes[self].right = r;
    Bounds b = nodes[l].bounds;
    b.grow(nodes[r].bounds);
    nodes[self].bounds = b;
    return self;
  }
};

// ---- threaded flatten ------------------------------------------------------

struct Flattened {
  std::vector<float> bmin, bmax;
  std::vector<int> first, count, skip;
};

static void flatten(const std::vector<BuildNode> &nodes, int root, Flattened &out) {
  // iterative DFS assigning depth-first order; skip = DFS successor of subtree
  struct Item { int node; };
  int n_total = static_cast<int>(nodes.size());
  out.bmin.reserve(3 * n_total);
  std::vector<std::pair<int, int>> stack;  // (build node, flat skip target placeholder)
  // two passes: first compute DFS order, then skip links via subtree sizes
  std::vector<int> order;
  order.reserve(n_total);
  std::vector<int> subtree_size(n_total, 1);
  {
    // post-order subtree sizes
    std::vector<std::pair<int, bool>> st{{root, false}};
    while (!st.empty()) {
      auto [u, processed] = st.back();
      st.pop_back();
      if (processed) {
        if (nodes[u].left >= 0)
          subtree_size[u] = 1 + subtree_size[nodes[u].left] + subtree_size[nodes[u].right];
      } else {
        st.push_back({u, true});
        if (nodes[u].left >= 0) {
          st.push_back({nodes[u].left, false});
          st.push_back({nodes[u].right, false});
        }
      }
    }
  }
  // DFS emit
  std::vector<int> st2{root};
  std::vector<int> flat_index(n_total, -1);
  while (!st2.empty()) {
    int u = st2.back();
    st2.pop_back();
    flat_index[u] = static_cast<int>(order.size());
    order.push_back(u);
    if (nodes[u].left >= 0) {
      st2.push_back(nodes[u].right);  // right after left in DFS
      st2.push_back(nodes[u].left);
    }
  }
  int n_flat = static_cast<int>(order.size());
  out.bmin.resize(3 * n_flat);
  out.bmax.resize(3 * n_flat);
  out.first.resize(n_flat);
  out.count.resize(n_flat);
  out.skip.resize(n_flat);
  for (int i = 0; i < n_flat; ++i) {
    const BuildNode &bn = nodes[order[i]];
    out.bmin[3 * i + 0] = bn.bounds.lo.x;
    out.bmin[3 * i + 1] = bn.bounds.lo.y;
    out.bmin[3 * i + 2] = bn.bounds.lo.z;
    out.bmax[3 * i + 0] = bn.bounds.hi.x;
    out.bmax[3 * i + 1] = bn.bounds.hi.y;
    out.bmax[3 * i + 2] = bn.bounds.hi.z;
    out.first[i] = bn.count > 0 ? bn.first : 0;
    out.count[i] = bn.count;
    out.skip[i] = i + subtree_size[order[i]];  // DFS successor; == n_flat at end
  }
}

}  // namespace

extern "C" {

// method: 0=SAH, 1=Middle, 2=EqualCounts, 3=LBVH(Morton)
// Returns number of flat nodes (<= 2*n), or -1 on error.  Output arrays must
// have capacity 2*n (nodes) and n (prim_order).
int mcpt_bvh_build(const float *tri_bmin, const float *tri_bmax, int n,
                   int max_leaf, int method, int *prim_order, float *node_bmin,
                   float *node_bmax, int *node_first, int *node_count,
                   int *node_skip) {
  if (n <= 0 || max_leaf <= 0) return -1;
  std::vector<PrimInfo> prims(n);
  Bounds scene_cb;
  for (int i = 0; i < n; ++i) {
    prims[i].index = i;
    prims[i].bounds.lo = {tri_bmin[3 * i], tri_bmin[3 * i + 1], tri_bmin[3 * i + 2]};
    prims[i].bounds.hi = {tri_bmax[3 * i], tri_bmax[3 * i + 1], tri_bmax[3 * i + 2]};
    prims[i].centroid = {
        0.5f * (prims[i].bounds.lo.x + prims[i].bounds.hi.x),
        0.5f * (prims[i].bounds.lo.y + prims[i].bounds.hi.y),
        0.5f * (prims[i].bounds.lo.z + prims[i].bounds.hi.z)};
    scene_cb.grow(prims[i].centroid);
  }

  Flattened flat;
  if (method == 3) {
    LBVHBuilder b;
    b.max_leaf = max_leaf;
    Vec3 ext = scene_cb.extent();
    auto norm = [&](float v, float lo, float e) {
      return e > 1e-30f ? (v - lo) / e : 0.5f;
    };
    std::vector<std::pair<uint32_t, int>> keyed(n);
    for (int i = 0; i < n; ++i) {
      keyed[i] = {morton3(norm(prims[i].centroid.x, scene_cb.lo.x, ext.x),
                          norm(prims[i].centroid.y, scene_cb.lo.y, ext.y),
                          norm(prims[i].centroid.z, scene_cb.lo.z, ext.z)),
                  i};
    }
    std::sort(keyed.begin(), keyed.end());
    b.prims.resize(n);
    b.codes.resize(n);
    for (int i = 0; i < n; ++i) {
      b.prims[i] = prims[keyed[i].second];
      b.codes[i] = keyed[i].first;
    }
    b.nodes.reserve(2 * n);
    b.ordered.reserve(n);
    int root = b.build(0, n, 29);
    flatten(b.nodes, root, flat);
    std::memcpy(prim_order, b.ordered.data(), sizeof(int) * n);
  } else {
    Builder b;
    b.prims = std::move(prims);
    b.max_leaf = max_leaf;
    b.method = method;
    b.nodes.reserve(2 * n);
    b.ordered.reserve(n);
    int root = b.build(0, n);
    flatten(b.nodes, root, flat);
    std::memcpy(prim_order, b.ordered.data(), sizeof(int) * n);
  }

  int n_flat = static_cast<int>(flat.count.size());
  if (n_flat > 2 * n) return -1;
  std::memcpy(node_bmin, flat.bmin.data(), sizeof(float) * 3 * n_flat);
  std::memcpy(node_bmax, flat.bmax.data(), sizeof(float) * 3 * n_flat);
  std::memcpy(node_first, flat.first.data(), sizeof(int) * n_flat);
  std::memcpy(node_count, flat.count.data(), sizeof(int) * n_flat);
  std::memcpy(node_skip, flat.skip.data(), sizeof(int) * n_flat);
  return n_flat;
}

}  // extern "C"
