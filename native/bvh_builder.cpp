// Binned-SAH BVH2 builder — native (C++) build-side of the CrossRT analog.
//
// The reference builds its BVHs in native code (Embree3 via
// external/CrossRT/EmbreeRT.cpp:489, Vulkan AS via VulkanRTX.cpp); this is
// this renderer's equivalent: a fast host-side builder that emits the
// flat skip-pointer node arrays consumed by the JAX traversal and the GPU
// kernel (hydracore3/accel/traverse.py, traverse_gpu.py).  Same output contract as the pure
// Python builder in hydracore3/accel/build_bvh.py (which remains the
// fallback when this library is unavailable): nodes in DFS pre-order, an
// internal node's hit-successor is i+1, its miss-successor is skip[i];
// leaves reference a contiguous range of reordered triangles.
//
// Exposed through a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float half_area(const V3& mn, const V3& mx) {
  float dx = std::max(mx.x - mn.x, 0.0f);
  float dy = std::max(mx.y - mn.y, 0.0f);
  float dz = std::max(mx.z - mn.z, 0.0f);
  return dx * dy + dy * dz + dz * dx;
}

struct Node {
  V3 bmin, bmax;
  int32_t left = -1, right = -1;   // child node ids (internal)
  int32_t tri_begin = -1;          // into ids[] (leaf)
  int32_t tri_count = 0;
};

struct Builder {
  const V3* tmin;
  const V3* tmax;
  const V3* centroid;
  int max_leaf;
  std::vector<int32_t> ids;
  std::vector<Node> nodes;

  // Iterative DFS build with an explicit work stack (begin, end, node id).
  int32_t build() {
    struct Work {
      int32_t begin, end, node;
    };
    std::vector<Work> stack;
    nodes.reserve(ids.size() / 2 + 4);
    nodes.push_back(Node{});
    stack.push_back({0, (int32_t)ids.size(), 0});

    while (!stack.empty()) {
      Work w = stack.back();
      stack.pop_back();
      Node& n0 = nodes[w.node];
      V3 mn = {FLT_MAX, FLT_MAX, FLT_MAX};
      V3 mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      V3 cmn = mn, cmx = mx;
      for (int32_t i = w.begin; i < w.end; ++i) {
        int32_t t = ids[i];
        mn = vmin(mn, tmin[t]);
        mx = vmax(mx, tmax[t]);
        cmn = vmin(cmn, centroid[t]);
        cmx = vmax(cmx, centroid[t]);
      }
      n0.bmin = mn;
      n0.bmax = mx;
      int32_t count = w.end - w.begin;
      if (count <= max_leaf) {
        n0.tri_begin = w.begin;
        n0.tri_count = count;
        continue;
      }

      // widest centroid axis
      float ex = cmx.x - cmn.x, ey = cmx.y - cmn.y, ez = cmx.z - cmn.z;
      int axis = (ex >= ey && ex >= ez) ? 0 : (ey >= ez ? 1 : 2);
      float cmin_a = axis == 0 ? cmn.x : (axis == 1 ? cmn.y : cmn.z);
      float extent = axis == 0 ? ex : (axis == 1 ? ey : ez);

      int32_t mid;
      if (extent <= 1e-12f) {
        mid = w.begin + count / 2;
      } else {
        // binned SAH
        int32_t cnt[N_BINS] = {0};
        V3 bbmin[N_BINS], bbmax[N_BINS];
        for (int b = 0; b < N_BINS; ++b) {
          bbmin[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
          bbmax[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        }
        float scale = (float)N_BINS / extent;
        auto bin_of = [&](int32_t t) {
          const V3& c = centroid[t];
          float ca = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
          int b = (int)((ca - cmin_a) * scale);
          return std::min(std::max(b, 0), N_BINS - 1);
        };
        for (int32_t i = w.begin; i < w.end; ++i) {
          int32_t t = ids[i];
          int b = bin_of(t);
          cnt[b]++;
          bbmin[b] = vmin(bbmin[b], tmin[t]);
          bbmax[b] = vmax(bbmax[b], tmax[t]);
        }
        // prefix/suffix sweeps
        float larea[N_BINS], rarea[N_BINS];
        int64_t lcnt[N_BINS], rcnt[N_BINS];
        {
          V3 amn = {FLT_MAX, FLT_MAX, FLT_MAX},
             amx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
          int64_t c = 0;
          for (int b = 0; b < N_BINS; ++b) {
            amn = vmin(amn, bbmin[b]);
            amx = vmax(amx, bbmax[b]);
            c += cnt[b];
            larea[b] = half_area(amn, amx);
            lcnt[b] = c;
          }
        }
        {
          V3 amn = {FLT_MAX, FLT_MAX, FLT_MAX},
             amx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
          int64_t c = 0;
          for (int b = N_BINS - 1; b >= 0; --b) {
            amn = vmin(amn, bbmin[b]);
            amx = vmax(amx, bbmax[b]);
            c += cnt[b];
            rarea[b] = half_area(amn, amx);
            rcnt[b] = c;
          }
        }
        double best_cost = DBL_MAX;
        int best_split = -1;
        for (int s = 1; s < N_BINS; ++s) {
          if (lcnt[s - 1] == 0 || rcnt[s] == 0) continue;
          double cost = (double)larea[s - 1] * (double)lcnt[s - 1] +
                        (double)rarea[s] * (double)rcnt[s];
          if (cost < best_cost) {
            best_cost = cost;
            best_split = s;
          }
        }
        if (best_split < 0) {
          mid = w.begin + count / 2;
        } else {
          int32_t* p = std::stable_partition(
              ids.data() + w.begin, ids.data() + w.end,
              [&](int32_t t) { return bin_of(t) < best_split; });
          mid = (int32_t)(p - ids.data());
          if (mid == w.begin || mid == w.end) mid = w.begin + count / 2;
        }
      }

      int32_t li = (int32_t)nodes.size();
      nodes.push_back(Node{});
      int32_t ri = (int32_t)nodes.size();
      nodes.push_back(Node{});
      // push_back may reallocate: re-take the reference
      nodes[w.node].left = li;
      nodes[w.node].right = ri;
      // DFS order: process left first (stack => push right first)
      stack.push_back({mid, w.end, ri});
      stack.push_back({w.begin, mid, li});
    }
    return 0;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.  Output arrays must
// be preallocated with capacity for 2*T+1 nodes (bmin/bmax: 3 floats per
// node) and T ints for `order`.  Skip pointers are assigned in one pre-order
// pass using precomputed subtree sizes.
int32_t hydra_build_bvh(const float* tri_min, const float* tri_max,
                         int32_t num_tris, int32_t max_leaf,
                         float* out_bmin, float* out_bmax, int32_t* out_skip,
                         int32_t* out_tri_offset, int32_t* out_tri_count,
                         int32_t* out_order) {
  if (num_tris <= 0 || max_leaf <= 0) return -1;
  std::vector<V3> cents((size_t)num_tris);
  const V3* tmn = reinterpret_cast<const V3*>(tri_min);
  const V3* tmx = reinterpret_cast<const V3*>(tri_max);
  for (int32_t i = 0; i < num_tris; ++i) {
    cents[i] = {(tmn[i].x + tmx[i].x) * 0.5f, (tmn[i].y + tmx[i].y) * 0.5f,
                (tmn[i].z + tmx[i].z) * 0.5f};
  }
  Builder b;
  b.tmin = tmn;
  b.tmax = tmx;
  b.centroid = cents.data();
  b.max_leaf = max_leaf;
  b.ids.resize((size_t)num_tris);
  for (int32_t i = 0; i < num_tris; ++i) b.ids[i] = i;
  b.build();

  const int32_t M = (int32_t)b.nodes.size();
  // subtree sizes, children-before-parents (children have larger ids than
  // parents is NOT guaranteed by the work-stack order, so do a post-order
  // pass with an explicit stack)
  std::vector<int32_t> size(M, 1);
  {
    std::vector<std::pair<int32_t, bool>> st;
    st.push_back({0, false});
    while (!st.empty()) {
      auto [ni, expanded] = st.back();
      st.pop_back();
      const Node& n = b.nodes[ni];
      if (n.tri_count > 0) continue;
      if (expanded) {
        size[ni] = 1 + size[n.left] + size[n.right];
      } else {
        st.push_back({ni, true});
        st.push_back({n.left, false});
        st.push_back({n.right, false});
      }
    }
  }

  // Pre-order emit: node, then left subtree, then right subtree.
  std::vector<std::pair<int32_t, int32_t>> st;  // (node, skip_to)
  st.push_back({0, -1});
  int32_t flat = 0, tri_cursor = 0;
  while (!st.empty()) {
    auto [ni, skip_to] = st.back();
    st.pop_back();
    const Node& n = b.nodes[ni];
    int32_t my = flat++;
    out_bmin[my * 3 + 0] = n.bmin.x;
    out_bmin[my * 3 + 1] = n.bmin.y;
    out_bmin[my * 3 + 2] = n.bmin.z;
    out_bmax[my * 3 + 0] = n.bmax.x;
    out_bmax[my * 3 + 1] = n.bmax.y;
    out_bmax[my * 3 + 2] = n.bmax.z;
    out_skip[my] = skip_to;
    if (n.tri_count > 0) {
      out_tri_offset[my] = tri_cursor;
      out_tri_count[my] = n.tri_count;
      std::memcpy(out_order + tri_cursor, b.ids.data() + n.tri_begin,
                  (size_t)n.tri_count * sizeof(int32_t));
      tri_cursor += n.tri_count;
    } else {
      out_tri_offset[my] = -1;
      out_tri_count[my] = 0;
      int32_t right_flat = my + 1 + size[n.left];
      // right subtree inherits this node's skip; left subtree skips to right
      st.push_back({n.right, skip_to});
      st.push_back({n.left, right_flat});
    }
  }
  return flat;
}

}  // extern "C"
