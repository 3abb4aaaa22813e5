// Union-find (disjoint-set forest) for 2D track formation.
//
// The port's copy of gtsfm_tpu/native/dsf.cpp: the native counterpart of
// tracks/dsf.py::_union_find_numpy, mirroring GTSfM's choice of C++ for DSF
// track generation (gtsam.gtsfm.tracksFromPairwiseMatches,
// gtsfm/data_association/cpp_dsf_tracks_estimator.py:74 upstream).
// Path-halving find + union-by-size; exposed via a C ABI for ctypes.
//
// Built with g++ at first use by native/build.py into build/torch_native/.

#include <cstdint>
#include <vector>

extern "C" {

// a, b: edge endpoint node ids (length n_edges); n_nodes: id space size.
// out: root label per node (length n_nodes).
void dsf_union_find(const int64_t* a, const int64_t* b, int64_t n_edges,
                    int64_t n_nodes, int64_t* out) {
  std::vector<int64_t> parent(n_nodes);
  std::vector<int64_t> size(n_nodes, 1);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };

  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ra = find(a[e]);
    int64_t rb = find(b[e]);
    if (ra == rb) continue;
    if (size[ra] < size[rb]) {
      parent[ra] = rb;
      size[rb] += size[ra];
    } else {
      parent[rb] = ra;
      size[ra] += size[rb];
    }
  }
  for (int64_t i = 0; i < n_nodes; ++i) out[i] = find(i);
}

}  // extern "C"
