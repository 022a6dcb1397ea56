// Native octree kernels for fourier_feature_nets_torch.
//
// A copy of fourier_feature_nets_tpu/octree/csrc/octree.cpp, which
// replaced the reference's numba @njit kernels (octree.py:200-541):
// the host-side tree construction and traversal are inherently
// sequential / irregular, so they live here as C++ compiled once per
// machine and loaded through ctypes. The data model is the classic
// *linear octree*: node ids encode their path from the root (children
// of node i occupy ids 8*i+1 .. 8*i+8); sorted id arrays + binary
// search stand in for pointers.
//
// Exposed C API (all arrays caller-allocated unless noted):
//   octree_build      BFS construction from a point cloud -> handle
//   octree_counts     node/leaf counts for a handle
//   octree_export     copy ids + leaf data out of a handle
//   octree_release    free a handle
//   octree_batch_query     point -> leaf index (or -1)
//   octree_batch_intersect ray marching through the sparse tree
//   octree_decode_ids      id -> (center, depth) without BFS

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <deque>
#include <map>
#include <mutex>
#include <numeric>
#include <vector>

namespace {

constexpr int X_POS = 0b100;
constexpr int Y_POS = 0b010;
constexpr int Z_POS = 0b001;

struct Cell {
  int64_t id;
  float x, y, z;   // center
  float scale;     // half side length
  int depth;
};

// Decode a node id into its center/scale/depth by walking the base-8
// digits of (id) root-down. Replaces the reference's BFS
// reconstruction (_leaf_nodes, octree.py:566-581) with O(depth)
// arithmetic per id.
Cell decode_id(int64_t id, float root_scale) {
  // collect child indices along the path, leaf-up
  int digits[64];
  int depth = 0;
  int64_t cur = id;
  while (cur > 0) {
    digits[depth++] = static_cast<int>((cur - 1) & 7);
    cur = (cur - 1) >> 3;
  }
  Cell cell{id, 0.f, 0.f, 0.f, root_scale, depth};
  float scale = root_scale;
  for (int level = depth - 1; level >= 0; --level) {
    scale *= 0.5f;
    int child = digits[level];
    cell.x += (child & X_POS) ? scale : -scale;
    cell.y += (child & Y_POS) ? scale : -scale;
    cell.z += (child & Z_POS) ? scale : -scale;
  }
  cell.scale = scale;
  return cell;
}

inline bool contains(const Cell& c, float px, float py, float pz) {
  return std::fabs(px - c.x) <= c.scale && std::fabs(py - c.y) <= c.scale &&
         std::fabs(pz - c.z) <= c.scale;
}

inline int child_octant(const Cell& c, float px, float py, float pz) {
  int child = 0;
  if (px >= c.x) child |= X_POS;
  if (py >= c.y) child |= Y_POS;
  if (pz >= c.z) child |= Z_POS;
  return child;
}

inline Cell child_cell(const Cell& c, int octant) {
  float s = c.scale * 0.5f;
  return Cell{(c.id << 3) + 1 + octant,
              c.x + ((octant & X_POS) ? s : -s),
              c.y + ((octant & Y_POS) ? s : -s),
              c.z + ((octant & Z_POS) ? s : -s),
              s, c.depth + 1};
}

inline bool sorted_contains(const int64_t* arr, int64_t n, int64_t id,
                            int64_t* index_out = nullptr) {
  const int64_t* end = arr + n;
  const int64_t* it = std::lower_bound(arr, end, id);
  if (index_out) *index_out = it - arr;
  return it != end && *it == id;
}

struct Tree {
  std::vector<int64_t> node_ids;   // sorted interior ids
  std::vector<int64_t> leaf_ids;   // sorted leaf ids
  std::vector<double> leaf_data;   // num_leaves x data_dim
  int data_dim = 0;
  float scale = 1.f;
};

std::mutex g_mutex;
std::map<int64_t, Tree*> g_trees;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

// BFS construction from a point cloud (octree.py:733-805 semantics):
// split while depth < depth-1; a node becomes a leaf at the target
// depth (if it holds >= min_leaf_size points) or earlier when no
// child clears min_leaf_size. Positions are centered by the caller.
// Returns a handle (>0) or 0 on error.
int64_t octree_build(const float* positions, int64_t num_points,
                     const double* data, int64_t data_dim,
                     int depth, int64_t min_leaf_size, float scale) {
  Tree* tree = new Tree();
  tree->scale = scale;
  tree->data_dim = static_cast<int>(data_dim);

  struct Item {
    Cell cell;
    std::vector<int64_t> index;
  };
  std::deque<Item> queue;
  Item root;
  root.cell = Cell{0, 0.f, 0.f, 0.f, scale, 0};
  root.index.resize(num_points);
  std::iota(root.index.begin(), root.index.end(), 0);
  queue.push_back(std::move(root));

  std::vector<std::pair<int64_t, std::vector<double>>> leaves;

  while (!queue.empty()) {
    Item item = std::move(queue.front());
    queue.pop_front();
    const Cell& cell = item.cell;

    auto make_leaf = [&]() {
      std::vector<double> mean(data_dim, 0.0);
      if (data_dim > 0 && !item.index.empty()) {
        for (int64_t i : item.index)
          for (int64_t d = 0; d < data_dim; ++d)
            mean[d] += data[i * data_dim + d];
        for (auto& v : mean) v /= static_cast<double>(item.index.size());
      }
      leaves.emplace_back(cell.id, std::move(mean));
    };

    if (cell.depth == depth - 1) {
      if (static_cast<int64_t>(item.index.size()) >= min_leaf_size)
        make_leaf();
    } else if (cell.depth < depth - 1) {
      tree->node_ids.push_back(cell.id);
      std::vector<std::vector<int64_t>> buckets(8);
      for (int64_t i : item.index) {
        int oct = child_octant(cell, positions[i * 3], positions[i * 3 + 1],
                               positions[i * 3 + 2]);
        buckets[oct].push_back(i);
      }
      bool valid_child = false;
      for (int oct = 0; oct < 8; ++oct) {
        if (static_cast<int64_t>(buckets[oct].size()) >= min_leaf_size) {
          Item child;
          child.cell = child_cell(cell, oct);
          child.index = std::move(buckets[oct]);
          queue.push_back(std::move(child));
          valid_child = true;
        }
      }
      if (!valid_child) {
        tree->node_ids.pop_back();  // not interior after all
        make_leaf();
      }
    }
  }

  std::sort(leaves.begin(), leaves.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  tree->leaf_ids.reserve(leaves.size());
  tree->leaf_data.reserve(leaves.size() * data_dim);
  for (auto& lf : leaves) {
    tree->leaf_ids.push_back(lf.first);
    for (double v : lf.second) tree->leaf_data.push_back(v);
  }
  std::sort(tree->node_ids.begin(), tree->node_ids.end());

  std::lock_guard<std::mutex> lock(g_mutex);
  int64_t handle = g_next_handle++;
  g_trees[handle] = tree;
  return handle;
}

void octree_counts(int64_t handle, int64_t* num_nodes, int64_t* num_leaves,
                   int64_t* data_dim) {
  std::lock_guard<std::mutex> lock(g_mutex);
  Tree* tree = g_trees.at(handle);
  *num_nodes = static_cast<int64_t>(tree->node_ids.size());
  *num_leaves = static_cast<int64_t>(tree->leaf_ids.size());
  *data_dim = tree->data_dim;
}

void octree_export(int64_t handle, int64_t* node_ids, int64_t* leaf_ids,
                   double* leaf_data) {
  std::lock_guard<std::mutex> lock(g_mutex);
  Tree* tree = g_trees.at(handle);
  std::memcpy(node_ids, tree->node_ids.data(),
              tree->node_ids.size() * sizeof(int64_t));
  std::memcpy(leaf_ids, tree->leaf_ids.data(),
              tree->leaf_ids.size() * sizeof(int64_t));
  if (tree->data_dim > 0)
    std::memcpy(leaf_data, tree->leaf_data.data(),
                tree->leaf_data.size() * sizeof(double));
}

void octree_release(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_trees.find(handle);
  if (it != g_trees.end()) {
    delete it->second;
    g_trees.erase(it);
  }
}

// Point -> leaf lookup: iterative descent from the root using the
// sorted id arrays (octree.py:513-541 semantics). result[i] is the
// index into leaf_ids, or -1 for out-of-bounds / empty space.
void octree_batch_query(float scale, const int64_t* node_ids,
                        int64_t num_nodes, const int64_t* leaf_ids,
                        int64_t num_leaves, const float* points,
                        int64_t num_points, int64_t* result) {
  for (int64_t p = 0; p < num_points; ++p) {
    float px = points[p * 3], py = points[p * 3 + 1], pz = points[p * 3 + 2];
    Cell cell{0, 0.f, 0.f, 0.f, scale, 0};
    int64_t out = -1;
    if (contains(cell, px, py, pz)) {
      int64_t max_id = num_leaves ? leaf_ids[num_leaves - 1] : -1;
      while (cell.id <= max_id) {
        cell = child_cell(cell, child_octant(cell, px, py, pz));
        int64_t index;
        if (sorted_contains(leaf_ids, num_leaves, cell.id, &index)) {
          out = index;
          break;
        }
        if (!sorted_contains(node_ids, num_nodes, cell.id)) break;
      }
    }
    result[p] = out;
  }
}

namespace {

// Slab intersection of a ray with a cell; returns (t_enter, t_exit).
inline void cell_near_far(const Cell& c, float ox, float oy, float oz,
                          float dx, float dy, float dz, float* t0,
                          float* t1) {
  float tx0 = (c.x - c.scale - ox) / dx, tx1 = (c.x + c.scale - ox) / dx;
  if (tx1 < tx0) std::swap(tx0, tx1);
  float ty0 = (c.y - c.scale - oy) / dy, ty1 = (c.y + c.scale - oy) / dy;
  if (ty1 < ty0) std::swap(ty0, ty1);
  float tz0 = (c.z - c.scale - oz) / dz, tz1 = (c.z + c.scale - oz) / dz;
  if (tz1 < tz0) std::swap(tz0, tz1);
  *t0 = std::max(tx0, std::max(ty0, tz0));
  *t1 = std::min(tx1, std::min(ty1, tz1));
}

}  // namespace

// Ray marching through the sparse tree (octree.py:418-501 contract):
// for each ray, walk cell to cell recording (t_entry, leaf_index or
// -1 for empty space); unvisited tail entries hold the root exit t
// and leaf -1. Descent restarts from the root per step — O(depth)
// with binary searches, simpler and equally fast in practice as the
// reference's stack/sibling bookkeeping.
void octree_batch_intersect(float scale, const int64_t* node_ids,
                            int64_t num_nodes, const int64_t* leaf_ids,
                            int64_t num_leaves, const float* starts,
                            const float* directions, int64_t num_rays,
                            int64_t max_length, float* t_stops,
                            int64_t* leaves) {
  for (int64_t r = 0; r < num_rays; ++r) {
    float ox = starts[r * 3], oy = starts[r * 3 + 1], oz = starts[r * 3 + 2];
    float dx = directions[r * 3], dy = directions[r * 3 + 1],
          dz = directions[r * 3 + 2];
    if (dx == 0) dx = 1e-8f;
    if (dy == 0) dy = 1e-8f;
    if (dz == 0) dz = 1e-8f;

    Cell root{0, 0.f, 0.f, 0.f, scale, 0};
    float root_t0, root_t1;
    cell_near_far(root, ox, oy, oz, dx, dy, dz, &root_t0, &root_t1);

    float* ray_t = t_stops + r * max_length;
    int64_t* ray_leaves = leaves + r * max_length;
    for (int64_t i = 0; i < max_length; ++i) {
      ray_t[i] = root_t1;
      ray_leaves[i] = -1;
    }
    if (root_t0 >= root_t1) continue;  // ray misses the volume

    float t = root_t0 + 1e-5f;
    int64_t stop = 0;
    while (t < root_t1 && stop < max_length - 1) {
      float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
      if (!contains(root, px, py, pz)) break;

      // descend to the deepest cell containing the point
      Cell cell = root;
      int64_t leaf_index = -1;
      bool is_empty = false;
      while (true) {
        int64_t index;
        if (sorted_contains(leaf_ids, num_leaves, cell.id, &index)) {
          leaf_index = index;
          break;
        }
        if (cell.id != 0 &&
            !sorted_contains(node_ids, num_nodes, cell.id)) {
          is_empty = true;
          break;
        }
        if (cell.depth > 60) {  // malformed tree guard
          is_empty = true;
          break;
        }
        cell = child_cell(cell, child_octant(cell, px, py, pz));
      }
      (void)is_empty;

      ray_t[stop] = t;
      ray_leaves[stop] = leaf_index;
      ++stop;

      float c_t0, c_t1;
      cell_near_far(cell, ox, oy, oz, dx, dy, dz, &c_t0, &c_t1);
      float next_t = c_t1 + 1e-5f;
      // paranoia from the reference (octree.py:468-474): guarantee
      // forward progress out of the current cell
      while (next_t <= t) next_t = std::nextafter(next_t, 1e30f) + 1e-5f;
      float qx = ox + next_t * dx, qy = oy + next_t * dy,
            qz = oz + next_t * dz;
      while (contains(cell, qx, qy, qz)) {
        next_t += 1e-5f;
        qx = ox + next_t * dx;
        qy = oy + next_t * dy;
        qz = oz + next_t * dz;
      }
      t = next_t;
    }
  }
}

// Vectorized id -> (center xyz, depth) decoding.
void octree_decode_ids(const int64_t* ids, int64_t num_ids, float scale,
                       float* centers, int32_t* depths) {
  for (int64_t i = 0; i < num_ids; ++i) {
    Cell c = decode_id(ids[i], scale);
    centers[i * 3] = c.x;
    centers[i * 3 + 1] = c.y;
    centers[i * 3 + 2] = c.z;
    depths[i] = c.depth;
  }
}

}  // extern "C"
