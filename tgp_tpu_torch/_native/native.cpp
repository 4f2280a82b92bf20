// Host-side native kernels for tgp_tpu_torch: the same C++ as
// tgp_tpu/_native/native.cpp, for the offline (precoarsening) path, where
// greedy sequential algorithms run on the host:
//   * graclus_matching — heaviest-first greedy matching (the numpy twin is
//     precoarsen/graclus.py::graclus_matching_numpy).
//   * maximal_matching_ranked — greedy maximal matching by edge rank.
//   * propagate_assignments — BFS majority-vote assignment rounds.
//   * sep_merge_tree — SEP's greedy structural-entropy merge (the Python
//     twin is precoarsen/sep.py's heap agglomeration).
//
// Built by tgp_tpu_torch/_native/__init__.py at first use with
// g++ -O2 -ffp-contract=off (no FMA: the numpy twins' bits are a tested
// contract) and loaded through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Graclus: deterministic weight-sorted greedy matching (same flavor as the
// device path, tgp_tpu/select/graclus.py).  The reference's matcher scans
// vertices in RANDOM order (torch_cluster::graclus_cluster); processing
// edges in descending weight order instead dominates its expected matched
// weight (bound tested in tests/test_ref_parity_graclus.py).  `seed` is
// kept for ABI compatibility and ignored.
// cluster_out[n]: consecutive cluster ids.
void graclus_matching(int64_t n, int64_t e, const int64_t* src,
                      const int64_t* dst, const double* w, uint64_t seed,
                      int64_t* cluster_out) {
  (void)seed;
  std::vector<int64_t> order(e);
  for (int64_t i = 0; i < e; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    double wa = w ? w[a] : 1.0, wb = w ? w[b] : 1.0;
    if (wa != wb) return wa > wb;  // heaviest first
    // deterministic tie-break: smaller (min,max) endpoint pair first
    int64_t amin = std::min(src[a], dst[a]), bmin = std::min(src[b], dst[b]);
    if (amin != bmin) return amin < bmin;
    return std::max(src[a], dst[a]) < std::max(src[b], dst[b]);
  });
  std::fill(cluster_out, cluster_out + n, int64_t(-1));
  int64_t next_id = 0;
  for (int64_t oi = 0; oi < e; ++oi) {
    int64_t i = order[oi];
    int64_t u = src[i], v = dst[i];
    if (u == v || cluster_out[u] >= 0 || cluster_out[v] >= 0) continue;
    cluster_out[u] = cluster_out[v] = next_id++;
  }
  for (int64_t u = 0; u < n; ++u)
    if (cluster_out[u] < 0) cluster_out[u] = next_id++;
}

// Greedy maximal matching processing edges in rank order.
// match_out[e]: 1 if edge is in the matching.
void maximal_matching_ranked(int64_t n, int64_t e, const int64_t* src,
                             const int64_t* dst, const int64_t* rank,
                             uint8_t* match_out) {
  std::vector<int64_t> order(e);
  for (int64_t i = 0; i < e; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return rank[a] < rank[b]; });
  std::vector<uint8_t> used(n, 0);
  std::memset(match_out, 0, e);
  for (int64_t oi = 0; oi < e; ++oi) {
    int64_t i = order[oi];
    int64_t u = src[i], v = dst[i];
    if (u == v || used[u] || used[v]) continue;
    match_out[i] = 1;
    used[u] = used[v] = 1;
  }
}

// Majority-vote assignment propagation (max_iter rounds + first-kept
// fallback).  assignments[n]: -1 unassigned, else cluster id.
void propagate_assignments(int64_t n, int64_t e, const int64_t* src,
                           const int64_t* dst, int64_t max_iter,
                           int64_t num_clusters, int64_t* assignments) {
  for (int64_t it = 0; it < max_iter; ++it) {
    std::vector<int64_t> updates(n, -1);
    bool any = false;
    // group votes per destination: simple per-node count pass
    std::vector<std::vector<std::pair<int64_t, int64_t>>> votes(n);
    for (int64_t i = 0; i < e; ++i) {
      int64_t u = src[i], v = dst[i];
      if (assignments[u] >= 0 && assignments[v] < 0)
        votes[v].push_back({assignments[u], 0});
    }
    for (int64_t v = 0; v < n; ++v) {
      if (votes[v].empty()) continue;
      std::sort(votes[v].begin(), votes[v].end());
      int64_t best_c = -1, best_cnt = 0;
      int64_t i = 0;
      while (i < (int64_t)votes[v].size()) {
        int64_t j = i;
        while (j < (int64_t)votes[v].size() &&
               votes[v][j].first == votes[v][i].first)
          ++j;
        if (j - i > best_cnt) {
          best_cnt = j - i;
          best_c = votes[v][i].first;
        }
        i = j;
      }
      updates[v] = best_c;
      any = true;
    }
    for (int64_t v = 0; v < n; ++v)
      if (updates[v] >= 0) assignments[v] = updates[v];
    if (!any) break;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SEP structural-entropy merge phase (precoarsen/sep.py's Python
// agglomeration in C++): greedy pairwise merging of root children while the
// two-level structural entropy decreases.  Outputs a forest: parent[i] for
// each of up to 2n-1 nodes (leaves 0..n-1, internals appended), -1 for roots,
// plus per-node volume and cut.  Height compression stays in Python (small).
extern "C" {

void sep_merge_tree(int64_t n, int64_t e, const int64_t* src,
                    const int64_t* dst, const double* w, int64_t* parent_out,
                    double* vol_out, double* cut_out, int64_t* n_total_out) {
  const int64_t cap = 2 * n;
  std::vector<double> vol(cap, 0.0), cut(cap, 0.0);
  std::vector<int64_t> parent(cap, -1);
  std::vector<char> alive(cap, 0);

  // degrees / self-cut from (assumed symmetric) edge list
  std::vector<double> deg(n, 0.0), selfw(n, 0.0);
  for (int64_t i = 0; i < e; ++i) {
    deg[src[i]] += w ? w[i] : 1.0;
    if (src[i] == dst[i]) selfw[src[i]] += w ? w[i] : 1.0;
  }
  double V = 0.0;
  for (int64_t i = 0; i < n; ++i) V += deg[i];
  if (V <= 0) V = 1.0;

  // cross weights between current clusters
  std::unordered_map<int64_t, std::unordered_map<int64_t, double>> cross;
  for (int64_t i = 0; i < e; ++i) {
    int64_t a = src[i], b = dst[i];
    if (a < b) {
      double ww = w ? w[i] : 1.0;
      cross[a][b] += ww;
      cross[b][a] += ww;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    vol[i] = deg[i];
    cut[i] = deg[i] - selfw[i];
    alive[i] = 1;
  }

  auto merge_delta = [&](int64_t a, int64_t b, double w_ab) {
    double vol_m = vol[a] + vol[b];
    if (vol_m <= 0) return -1e300;
    double g_m = cut[a] + cut[b] - 2 * w_ab;
    double before = 0.0, after = 0.0;
    for (int64_t x : {a, b}) {
      if (vol[x] > 0) {
        before += -(cut[x] / V) * std::log2(std::max(vol[x] / V, 1e-12));
        after += -(cut[x] / V) * std::log2(std::max(vol[x] / vol_m, 1e-12));
      }
    }
    after += -(g_m / V) * std::log2(std::max(vol_m / V, 1e-12));
    return before - after;
  };

  // lazy max-heap of candidate merges
  // tie-break like the Python heap's (-d, a, b) tuples so both paths
  // produce the same tree on unweighted graphs (heavy delta ties)
  struct Cand { double d; int64_t a, b; };
  auto cmp = [](const Cand& x, const Cand& y) {
    if (x.d != y.d) return x.d < y.d;
    if (x.a != y.a) return x.a > y.a;
    return x.b > y.b;
  };
  std::vector<Cand> heap;
  for (auto& [a, row] : cross)
    for (auto& [b, ww] : row)
      if (a < b) heap.push_back({merge_delta(a, b, ww), a, b});
  std::make_heap(heap.begin(), heap.end(), cmp);

  int64_t next_id = n;
  while (!heap.empty() && next_id < cap - 1) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    Cand c = heap.back();
    heap.pop_back();
    if (!alive[c.a] || !alive[c.b]) continue;
    double w_ab = 0.0;
    auto it = cross.find(c.a);
    if (it != cross.end()) {
      auto jt = it->second.find(c.b);
      if (jt != it->second.end()) w_ab = jt->second;
    }
    double d = merge_delta(c.a, c.b, w_ab);
    // FULL agglomeration: merge the best pair even when entropy-increasing
    // (the compression phase picks the surviving layers — reference
    // PartitionTree structure); early-stopping strands singleton clusters.
    if (std::abs(c.d - d) > 1e-9) {  // stale entry: refresh and re-rank
      heap.push_back({d, c.a, c.b});
      std::push_heap(heap.begin(), heap.end(), cmp);
      continue;
    }
    int64_t m = next_id++;
    vol[m] = vol[c.a] + vol[c.b];
    cut[m] = cut[c.a] + cut[c.b] - 2 * w_ab;
    parent[c.a] = m;
    parent[c.b] = m;
    alive[c.a] = alive[c.b] = 0;
    alive[m] = 1;
    // merge cross rows
    std::unordered_map<int64_t, double> row;
    for (int64_t xsrc : {c.a, c.b}) {
      auto r = cross.find(xsrc);
      if (r == cross.end()) continue;
      for (auto& [nb, ww] : r->second)
        if (alive[nb]) row[nb] += ww;
      cross.erase(r);
    }
    for (auto& [nb, ww] : row) {
      cross[nb].erase(c.a);
      cross[nb].erase(c.b);
      cross[nb][m] = ww;
      double d2 = merge_delta(m, nb, ww);
      heap.push_back({d2, std::min(m, nb), std::max(m, nb)});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    cross[m] = std::move(row);
  }

  *n_total_out = next_id;
  std::copy(parent.begin(), parent.begin() + next_id, parent_out);
  std::copy(vol.begin(), vol.begin() + next_id, vol_out);
  std::copy(cut.begin(), cut.begin() + next_id, cut_out);
}

}  // extern "C"
