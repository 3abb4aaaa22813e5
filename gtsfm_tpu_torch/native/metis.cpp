// Multilevel 2-way graph partitioning (METIS-class: heavy-edge-matching
// coarsening, greedy region-growing initial partition, FM boundary
// refinement at every level).
//
// The port's copy of gtsfm_tpu/native/metis.cpp, code unchanged: the native
// counterpart of GTSfM's METIS dependency (vendored inside GTSAM and used by
// graph_partitioner/metis_partitioner.py:32-80 upstream). Recursive
// bisection on the host shapes the device workload (the cluster tree); it
// is sequential graph work, so it lives in C++ behind a C ABI for ctypes.
//
// Built with g++ at first use by native/build.py into build/torch_native/.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Graph {
  int64_t n = 0;
  std::vector<int64_t> xadj;    // CSR offsets (n+1)
  std::vector<int64_t> adjncy;  // neighbors
  std::vector<double> adjwgt;   // edge weights
  std::vector<int64_t> vwgt;    // vertex weights
};

// Deterministic LCG so partitions are reproducible run to run.
struct Rng {
  uint64_t s = 0x9E3779B97F4A7C15ull;
  uint64_t next() {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    return s >> 33;
  }
};

Graph build_csr(const int64_t* u, const int64_t* v, const double* w,
                int64_t n_edges, int64_t n_nodes) {
  Graph g;
  g.n = n_nodes;
  g.vwgt.assign(n_nodes, 1);
  std::vector<int64_t> deg(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (u[e] == v[e]) continue;
    ++deg[u[e]];
    ++deg[v[e]];
  }
  g.xadj.assign(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_nodes; ++i) g.xadj[i + 1] = g.xadj[i] + deg[i];
  g.adjncy.assign(g.xadj[n_nodes], 0);
  g.adjwgt.assign(g.xadj[n_nodes], 0.0);
  std::vector<int64_t> fill(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (u[e] == v[e]) continue;
    double ww = w ? w[e] : 1.0;
    int64_t a = u[e], b = v[e];
    g.adjncy[g.xadj[a] + fill[a]] = b;
    g.adjwgt[g.xadj[a] + fill[a]++] = ww;
    g.adjncy[g.xadj[b] + fill[b]] = a;
    g.adjwgt[g.xadj[b] + fill[b]++] = ww;
  }
  return g;
}

// Heavy-edge matching: returns cmap (fine node -> coarse node) and the
// number of coarse nodes. Unmatched nodes map alone.
int64_t hem_match(const Graph& g, Rng& rng, std::vector<int64_t>& cmap) {
  std::vector<int64_t> order(g.n);
  std::iota(order.begin(), order.end(), 0);
  for (int64_t i = g.n - 1; i > 0; --i)
    std::swap(order[i], order[rng.next() % (i + 1)]);
  std::vector<int64_t> match(g.n, -1);
  for (int64_t oi = 0; oi < g.n; ++oi) {
    int64_t i = order[oi];
    if (match[i] != -1) continue;
    int64_t best = -1;
    double best_w = -1.0;
    for (int64_t k = g.xadj[i]; k < g.xadj[i + 1]; ++k) {
      int64_t j = g.adjncy[k];
      if (match[j] == -1 && g.adjwgt[k] > best_w) {
        best_w = g.adjwgt[k];
        best = j;
      }
    }
    match[i] = (best == -1) ? i : best;
    if (best != -1) match[best] = i;
  }
  cmap.assign(g.n, -1);
  int64_t nc = 0;
  for (int64_t i = 0; i < g.n; ++i) {
    if (cmap[i] != -1) continue;
    cmap[i] = nc;
    if (match[i] != i) cmap[match[i]] = nc;
    ++nc;
  }
  return nc;
}

Graph contract(const Graph& g, const std::vector<int64_t>& cmap, int64_t nc) {
  Graph c;
  c.n = nc;
  c.vwgt.assign(nc, 0);
  for (int64_t i = 0; i < g.n; ++i) c.vwgt[cmap[i]] += g.vwgt[i];
  // collect coarse edges via hashing per coarse node
  std::vector<std::vector<std::pair<int64_t, double>>> adj(nc);
  for (int64_t i = 0; i < g.n; ++i) {
    int64_t ci = cmap[i];
    for (int64_t k = g.xadj[i]; k < g.xadj[i + 1]; ++k) {
      int64_t cj = cmap[g.adjncy[k]];
      if (ci == cj) continue;
      adj[ci].push_back({cj, g.adjwgt[k]});
    }
  }
  c.xadj.assign(nc + 1, 0);
  for (int64_t i = 0; i < nc; ++i) {
    auto& a = adj[i];
    std::sort(a.begin(), a.end());
    int64_t uniq = 0;
    for (size_t k = 0; k < a.size(); ++k)
      if (k == 0 || a[k].first != a[k - 1].first) ++uniq;
    c.xadj[i + 1] = c.xadj[i] + uniq;
  }
  c.adjncy.assign(c.xadj[nc], 0);
  c.adjwgt.assign(c.xadj[nc], 0.0);
  for (int64_t i = 0; i < nc; ++i) {
    auto& a = adj[i];
    int64_t p = c.xadj[i] - 1;
    for (size_t k = 0; k < a.size(); ++k) {
      if (k == 0 || a[k].first != a[k - 1].first) {
        ++p;
        c.adjncy[p] = a[k].first;
        c.adjwgt[p] = a[k].second;
      } else {
        c.adjwgt[p] += a[k].second;
      }
    }
  }
  return c;
}

// Greedy region growing from a pseudo-peripheral seed to ~half total weight.
void initial_partition(const Graph& g, std::vector<int8_t>& part) {
  part.assign(g.n, 1);
  int64_t total = std::accumulate(g.vwgt.begin(), g.vwgt.end(), int64_t(0));
  int64_t target = total / 2;
  // pseudo-peripheral: BFS twice from node 0
  auto bfs_far = [&](int64_t s) {
    std::vector<int64_t> dist(g.n, -1);
    std::vector<int64_t> q{s};
    dist[s] = 0;
    int64_t last = s;
    for (size_t h = 0; h < q.size(); ++h) {
      int64_t x = q[h];
      last = x;
      for (int64_t k = g.xadj[x]; k < g.xadj[x + 1]; ++k) {
        int64_t y = g.adjncy[k];
        if (dist[y] == -1) {
          dist[y] = dist[x] + 1;
          q.push_back(y);
        }
      }
    }
    return last;
  };
  int64_t seed = bfs_far(bfs_far(0));
  // grow side 0 by max-connection greedy BFS
  std::vector<double> conn(g.n, 0.0);
  std::vector<int8_t> in(g.n, 0);
  int64_t grown = 0;
  int64_t cur = seed;
  while (grown < target) {
    in[cur] = 1;
    part[cur] = 0;
    grown += g.vwgt[cur];
    for (int64_t k = g.xadj[cur]; k < g.xadj[cur + 1]; ++k)
      conn[g.adjncy[k]] += g.adjwgt[k];
    int64_t best = -1;
    double best_c = -1.0;
    for (int64_t i = 0; i < g.n; ++i)
      if (!in[i] && conn[i] > best_c) {
        best_c = conn[i];
        best = i;
      }
    if (best == -1 || best_c <= 0.0) {
      // disconnected: restart growth from any remaining node
      for (int64_t i = 0; i < g.n; ++i)
        if (!in[i]) {
          best = i;
          break;
        }
      if (best == -1) break;
    }
    cur = best;
  }
}

// FM-style boundary refinement with balance constraint. Greedy positive-
// gain passes with a small hill-climbing window and rollback to best.
void fm_refine(const Graph& g, std::vector<int8_t>& part, double balance_tol,
               int max_passes = 8) {
  int64_t total = std::accumulate(g.vwgt.begin(), g.vwgt.end(), int64_t(0));
  double lo = total * (0.5 - balance_tol), hi = total * (0.5 + balance_tol);
  int64_t w0 = 0;
  for (int64_t i = 0; i < g.n; ++i)
    if (part[i] == 0) w0 += g.vwgt[i];

  for (int pass = 0; pass < max_passes; ++pass) {
    std::vector<int8_t> locked(g.n, 0);
    std::vector<double> gain(g.n, 0.0);
    auto recompute_gain = [&](int64_t i) {
      double ext = 0, internal = 0;
      for (int64_t k = g.xadj[i]; k < g.xadj[i + 1]; ++k) {
        if (part[g.adjncy[k]] == part[i])
          internal += g.adjwgt[k];
        else
          ext += g.adjwgt[k];
      }
      gain[i] = ext - internal;
    };
    for (int64_t i = 0; i < g.n; ++i) recompute_gain(i);

    double cum = 0.0, best_cum = 0.0;
    std::vector<int64_t> moves;
    int64_t best_prefix = 0;
    int64_t budget = std::min<int64_t>(g.n, 2 * g.n / 3 + 16);
    for (int64_t m = 0; m < budget; ++m) {
      int64_t best = -1;
      double best_g = -1e300;
      for (int64_t i = 0; i < g.n; ++i) {
        if (locked[i]) continue;
        // balance feasibility of moving i to the other side
        int64_t nw0 = part[i] == 0 ? w0 - g.vwgt[i] : w0 + g.vwgt[i];
        if (nw0 < lo || nw0 > hi) continue;
        if (gain[i] > best_g) {
          best_g = gain[i];
          best = i;
        }
      }
      if (best == -1) break;
      // apply move
      w0 += part[best] == 0 ? -g.vwgt[best] : g.vwgt[best];
      part[best] = 1 - part[best];
      locked[best] = 1;
      cum += best_g;
      moves.push_back(best);
      for (int64_t k = g.xadj[best]; k < g.xadj[best + 1]; ++k)
        if (!locked[g.adjncy[k]]) recompute_gain(g.adjncy[k]);
      if (cum > best_cum + 1e-12) {
        best_cum = cum;
        best_prefix = (int64_t)moves.size();
      }
      if (cum < best_cum - 8.0 * (std::abs(best_cum) + 1.0)) break;
    }
    // roll back to the best prefix
    for (int64_t m = (int64_t)moves.size() - 1; m >= best_prefix; --m) {
      int64_t i = moves[m];
      w0 += part[i] == 0 ? -g.vwgt[i] : g.vwgt[i];
      part[i] = 1 - part[i];
    }
    if (best_prefix == 0) break;  // no improvement this pass
  }
}

void bisect(const Graph& g, Rng& rng, double balance_tol,
            std::vector<int8_t>& part) {
  if (g.n <= 64) {
    initial_partition(g, part);
    fm_refine(g, part, balance_tol);
    return;
  }
  std::vector<int64_t> cmap;
  int64_t nc = hem_match(g, rng, cmap);
  if (nc >= g.n) {  // matching made no progress
    initial_partition(g, part);
    fm_refine(g, part, balance_tol);
    return;
  }
  Graph cg = contract(g, cmap, nc);
  std::vector<int8_t> cpart;
  bisect(cg, rng, balance_tol, cpart);
  part.assign(g.n, 0);
  for (int64_t i = 0; i < g.n; ++i) part[i] = cpart[cmap[i]];
  fm_refine(g, part, balance_tol);
}

}  // namespace

extern "C" {

// u, v: edge endpoints (n_edges) in [0, n_nodes); w: edge weights or NULL;
// balance_tol: allowed deviation of each side from half the total vertex
// weight, as a fraction (e.g. 0.1). part_out: 0/1 side per node.
void metis_bisect(const int64_t* u, const int64_t* v, const double* w,
                  int64_t n_edges, int64_t n_nodes, double balance_tol,
                  int8_t* part_out) {
  Graph g = build_csr(u, v, w, n_edges, n_nodes);
  Rng rng;
  std::vector<int8_t> part;
  bisect(g, rng, balance_tol, part);
  for (int64_t i = 0; i < n_nodes; ++i) part_out[i] = part[i];
}

}  // extern "C"
