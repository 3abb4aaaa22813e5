// Greedy minimum-feedback-arc-set ordering (Eades et al. heuristic).
//
// The port's copy of gtsfm_tpu/native/mfas.cpp: the native counterpart of
// averaging/translation/averaging.py's greedy MFAS order, mirroring GTSfM's
// use of GTSAM's C++ MFAS (gtsam.MFAS,
// gtsfm/averaging/translation/averaging_1dsfm.py:216-296 upstream). MFAS
// ordering is inherently sequential, so the hot loop lives here; exposed
// via a C ABI for ctypes.
//
// Built with g++ at first use by native/build.py into build/torch_native/.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

// Greedy MFAS ordering (the 1DSfM / gtsam heuristic): repeatedly pick the
// unremoved node maximizing (wout + eps) / (win + eps). A source (win = 0)
// always dominates non-sources, so on a DAG this is a topological sort with
// ZERO violations — the property the outlier sweep relies on: inlier-
// consistent tournaments are DAGs, only genuinely cyclic (outlier)
// structure must break. Ties go to the lowest index (matches the numpy
// fallback's argmax).
void greedy_order(const int64_t* src, const int64_t* dst, const double* wgt,
                  int64_t n_edges, int64_t n_nodes, int64_t* out_order) {
  constexpr double kEps = 1e-8;
  std::vector<double> wout(n_nodes, 0.0), win(n_nodes, 0.0);
  std::vector<std::vector<std::pair<int64_t, double>>> out_adj(n_nodes),
      in_adj(n_nodes);
  for (int64_t e = 0; e < n_edges; ++e) {
    out_adj[src[e]].push_back({dst[e], wgt[e]});
    in_adj[dst[e]].push_back({src[e], wgt[e]});
    wout[src[e]] += wgt[e];
    win[dst[e]] += wgt[e];
  }
  std::vector<char> removed(n_nodes, 0);
  for (int64_t k = 0; k < n_nodes; ++k) {
    int64_t best = -1;
    double best_score = -std::numeric_limits<double>::infinity();
    for (int64_t i = 0; i < n_nodes; ++i) {
      if (!removed[i]) {
        double s = (wout[i] + kEps) / (win[i] + kEps);
        if (s > best_score) {
          best_score = s;
          best = i;
        }
      }
    }
    out_order[k] = best;
    removed[best] = 1;
    for (auto& [v, w] : out_adj[best]) {
      if (!removed[v]) win[v] = win[v] - w > 0.0 ? win[v] - w : 0.0;
    }
    for (auto& [v, w] : in_adj[best]) {
      if (!removed[v]) wout[v] = wout[v] - w > 0.0 ? wout[v] - w : 0.0;
    }
  }
}

// Insertion-move local refinement of an ordering: each node is moved to the
// position that maximally reduces broken edge weight (only crossings with
// the node's own neighbors change anything, so a pass is O(E log deg)).
// Runs until a pass makes no move (bounded by max_passes). On the 1DSfM
// tournaments this roughly halves the broken weight left by the greedy and
// concentrates it on the planted outliers.
void refine_order(const int64_t* src, const int64_t* dst, const double* wgt,
                  int64_t n_edges, int64_t n_nodes, int64_t* order,
                  int64_t max_passes) {
  std::vector<std::vector<std::pair<int64_t, double>>> fwd(n_nodes),
      bwd(n_nodes);
  for (int64_t e = 0; e < n_edges; ++e) {
    fwd[src[e]].push_back({dst[e], wgt[e]});  // u before v satisfies
    bwd[dst[e]].push_back({src[e], wgt[e]});  // u after v satisfies
  }
  std::vector<int64_t> pos(n_nodes);
  for (int64_t k = 0; k < n_nodes; ++k) pos[order[k]] = k;
  std::vector<std::pair<int64_t, double>> evs;  // (neighbor pos, gain of passing it rightwards)
  for (int64_t pass = 0; pass < max_passes; ++pass) {
    bool improved = false;
    for (int64_t u = 0; u < n_nodes; ++u) {
      int64_t pu = pos[u];
      evs.clear();
      for (auto& [v, w] : fwd[u]) evs.push_back({pos[v], -w});
      for (auto& [v, w] : bwd[u]) evs.push_back({pos[v], +w});
      if (evs.empty()) continue;
      std::sort(evs.begin(), evs.end());
      double best_gain = 0.0;
      int64_t best_t = pu;
      double g = 0.0;
      for (auto& [pv, dw] : evs) {
        if (pv > pu) {
          g += dw;
          if (g > best_gain + 1e-12) {
            best_gain = g;
            best_t = pv;  // insert just after the node at pv
          }
        }
      }
      g = 0.0;
      for (auto it = evs.rbegin(); it != evs.rend(); ++it) {
        if (it->first < pu) {
          g -= it->second;  // moving left past v reverses the crossing
          if (g > best_gain + 1e-12) {
            best_gain = g;
            best_t = it->first;  // insert just before the node at pv
          }
        }
      }
      if (best_t == pu) continue;
      improved = true;
      // shift the block between pu and best_t by one, place u at best_t
      if (best_t > pu) {
        for (int64_t k = pu; k < best_t; ++k) {
          order[k] = order[k + 1];
          pos[order[k]] = k;
        }
      } else {
        for (int64_t k = pu; k > best_t; --k) {
          order[k] = order[k - 1];
          pos[order[k]] = k;
        }
      }
      order[best_t] = u;
      pos[u] = best_t;
    }
    if (!improved) break;
  }
}

}  // namespace

extern "C" {

// src, dst: directed edge endpoints; wgt: edge weights (length n_edges);
// n_nodes: node count. out_order: node ordering (length n_nodes).
void mfas_order(const int64_t* src, const int64_t* dst, const double* wgt,
                int64_t n_edges, int64_t n_nodes, int64_t* out_order) {
  greedy_order(src, dst, wgt, n_edges, n_nodes, out_order);
  refine_order(src, dst, wgt, n_edges, n_nodes, out_order, 8);
}

// Batched 1DSfM outlier weights (averaging_1dsfm.py:216-296 regime at the
// reference's full 2000-direction budget, averaging_1dsfm.py:51): for each
// projection direction, project the edge directions, orient edges by the
// projection sign, run greedy MFAS, and accumulate the weight of order-
// violating edges. Threaded over directions (each direction's ordering is
// independent); out_weights[e] = broken_weight / total_weight in [0, 1].
//
// edges: (i, j) pairs, length 2*n_edges, meaning t_i - t_j ~ s * w_dir[e].
// w_dirs: unit world directions, length 3*n_edges.
// proj_dirs: unit projection directions, length 3*n_proj.
void mfas_outlier_weights(const int64_t* edges, const double* w_dirs,
                          int64_t n_edges, int64_t n_nodes,
                          const double* proj_dirs, int64_t n_proj,
                          int64_t n_threads, double* out_weights) {
  if (n_edges == 0) return;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_proj) n_threads = n_proj;
  std::vector<std::vector<double>> broken_acc(n_threads),
      total_acc(n_threads);

  auto worker = [&](int64_t t) {
    auto& broken = broken_acc[t];
    auto& total = total_acc[t];
    broken.assign(n_edges, 0.0);
    total.assign(n_edges, 0.0);
    std::vector<int64_t> src(n_edges), dst(n_edges), order(n_nodes),
        pos(n_nodes);
    std::vector<double> wgt(n_edges);
    for (int64_t p = t; p < n_proj; p += n_threads) {
      const double* d = proj_dirs + 3 * p;
      for (int64_t e = 0; e < n_edges; ++e) {
        const double* u = w_dirs + 3 * e;
        double proj = u[0] * d[0] + u[1] * d[1] + u[2] * d[2];
        // t_i - t_j ~ s*dir, s>0: proj>0 => t_i after t_j along d => j -> i
        if (proj > 0) {
          src[e] = edges[2 * e + 1];
          dst[e] = edges[2 * e];
        } else {
          src[e] = edges[2 * e];
          dst[e] = edges[2 * e + 1];
        }
        wgt[e] = proj > 0 ? proj : -proj;
      }
      greedy_order(src.data(), dst.data(), wgt.data(), n_edges, n_nodes,
                   order.data());
      refine_order(src.data(), dst.data(), wgt.data(), n_edges, n_nodes,
                   order.data(), 8);
      for (int64_t k = 0; k < n_nodes; ++k) pos[order[k]] = k;
      for (int64_t e = 0; e < n_edges; ++e) {
        if (pos[src[e]] > pos[dst[e]]) broken[e] += wgt[e];
        total[e] += wgt[e];
      }
    }
  };

  std::vector<std::thread> threads;
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  for (int64_t e = 0; e < n_edges; ++e) {
    double b = 0.0, s = 0.0;
    for (int64_t t = 0; t < n_threads; ++t) {
      b += broken_acc[t][e];
      s += total_acc[t][e];
    }
    out_weights[e] = b / (s > 1e-12 ? s : 1e-12);
  }
}

}  // extern "C"
