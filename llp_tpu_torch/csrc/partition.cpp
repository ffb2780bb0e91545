// Host-side balanced locality partitioner of llp_tpu_torch (the port's own
// copy of the partitioning part of llp_tpu/native/sampler.cpp).  Host code,
// not a device kernel: it runs once per dataset when --reorder locality
// relabels the nodes (llp_tpu_torch/data/partition.py), and its numpy
// fallback (llp_tpu_torch/data/native.py) gives the flat method's result
// when no g++ is found.
//
// Entry points, extern "C" for ctypes:
// * llp_partition_graph: one LDG stream pass over a caller-supplied node
//   order, then capacitated label-propagation restreams.
// * llp_partition_multilevel: a METIS-style V-cycle (heavy-edge matching,
//   a weighted LDG + label propagation on the coarsest graph, refinement on
//   the way back).
// * llp_build_csr_perm: the stable counting sort behind build_csr.
//
// Deterministic: no RNG, ties resolve to the lowest part (or node) id, and
// moves happen only on strict improvement, so the assignment equals the JAX
// package's for the same graph.
//
// Build: g++ -O3 -shared -fPIC -std=c++17

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct CsrLevel {
  std::vector<int64_t> row_ptr;
  std::vector<int32_t> col;
  std::vector<int64_t> ew;    // edge weights (merged multi-edge counts)
  std::vector<int64_t> nw;    // node weights (cluster sizes)
  std::vector<int32_t> cmap;  // finer-level node -> this level's node
  int64_t n = 0;
};

// One capacitated weighted label-propagation restream pass.
int64_t lp_pass_weighted(const CsrLevel& L, int32_t num_parts,
                         std::vector<int64_t>& load, int64_t cap2,
                         int32_t* assign) {
  std::vector<int64_t> nb((size_t)num_parts);
  int64_t moved = 0;
  for (int64_t v = 0; v < L.n; ++v) {
    int32_t cur = assign[v];
    std::fill(nb.begin(), nb.end(), 0);
    for (int64_t e = L.row_ptr[v]; e < L.row_ptr[v + 1]; ++e)
      nb[(size_t)assign[L.col[e]]] += L.ew[e];
    int64_t best_score = -1;
    int32_t best = cur;
    int64_t w = L.nw[v];
    for (int32_t p = 0; p < num_parts; ++p) {
      if (p != cur && load[p] + w > cap2) continue;
      if (nb[(size_t)p] > best_score) {
        best_score = nb[(size_t)p];
        best = p;
      }
    }
    if (best != cur && best_score > nb[(size_t)cur]) {
      load[(size_t)cur] -= w;
      load[(size_t)best] += w;
      assign[v] = best;
      ++moved;
    }
  }
  return moved;
}

// Weighted LDG stream (ascending id) for the coarsest level's first
// partition; the least-loaded part takes a node that fits nowhere.
void ldg_weighted(const CsrLevel& L, int32_t num_parts, int64_t cap,
                  std::vector<int64_t>& load, int32_t* assign) {
  std::fill(assign, assign + L.n, (int32_t)-1);
  std::vector<int64_t> nb((size_t)num_parts);
  for (int64_t v = 0; v < L.n; ++v) {
    std::fill(nb.begin(), nb.end(), 0);
    for (int64_t e = L.row_ptr[v]; e < L.row_ptr[v + 1]; ++e) {
      int32_t a = assign[L.col[e]];
      if (a >= 0) nb[(size_t)a] += L.ew[e];
    }
    int64_t w = L.nw[v];
    int64_t best_score = INT64_MIN;
    int32_t best = -1;
    for (int32_t p = 0; p < num_parts; ++p) {
      if (load[p] + w > cap) continue;
      int64_t s = nb[(size_t)p] * (cap - load[p]);
      if (s > best_score) {
        best_score = s;
        best = p;
      }
    }
    if (best < 0) {
      best = 0;
      for (int32_t p = 1; p < num_parts; ++p)
        if (load[p] < load[best]) best = p;
    }
    assign[v] = best;
    load[(size_t)best] += w;
  }
}

// Heavy-edge matching and contraction: nodes visited ascending, the
// heaviest unmatched neighbour wins (ties to the lowest id), clusters no
// heavier than maxnw.
CsrLevel coarsen_level(const CsrLevel& L, int64_t maxnw) {
  std::vector<int32_t> match((size_t)L.n, -1);
  for (int64_t v = 0; v < L.n; ++v) {
    if (match[v] >= 0) continue;
    int64_t bestw = -1;
    int32_t bestu = -1;
    for (int64_t e = L.row_ptr[v]; e < L.row_ptr[v + 1]; ++e) {
      int32_t u = L.col[e];
      if ((int64_t)u == v || match[u] >= 0) continue;
      if (L.nw[v] + L.nw[u] > maxnw) continue;
      if (L.ew[e] > bestw) {
        bestw = L.ew[e];
        bestu = u;
      }
    }
    if (bestu >= 0) {
      match[v] = bestu;
      match[bestu] = (int32_t)v;
    } else {
      match[v] = (int32_t)v;
    }
  }
  CsrLevel C;
  C.cmap.assign((size_t)L.n, -1);
  int64_t nc = 0;
  for (int64_t v = 0; v < L.n; ++v) {
    if (C.cmap[v] >= 0) continue;
    C.cmap[v] = (int32_t)nc;
    C.cmap[(size_t)match[v]] = (int32_t)nc;
    ++nc;
  }
  C.n = nc;
  C.nw.assign((size_t)nc, 0);
  for (int64_t v = 0; v < L.n; ++v) C.nw[(size_t)C.cmap[v]] += L.nw[v];
  // Coarse adjacency: counting-sort the fine edges by coarse row, then sort
  // each row and merge duplicate columns.
  std::vector<int64_t> cnt((size_t)nc + 1, 0);
  for (int64_t v = 0; v < L.n; ++v)
    for (int64_t e = L.row_ptr[v]; e < L.row_ptr[v + 1]; ++e)
      if (C.cmap[L.col[e]] != C.cmap[v]) cnt[(size_t)C.cmap[v] + 1]++;
  for (int64_t r = 0; r < nc; ++r) cnt[(size_t)r + 1] += cnt[(size_t)r];
  std::vector<int32_t> tcol((size_t)cnt[(size_t)nc]);
  std::vector<int64_t> tw((size_t)cnt[(size_t)nc]);
  std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
  for (int64_t v = 0; v < L.n; ++v) {
    int32_t cv = C.cmap[v];
    for (int64_t e = L.row_ptr[v]; e < L.row_ptr[v + 1]; ++e) {
      int32_t cu = C.cmap[L.col[e]];
      if (cu == cv) continue;
      int64_t pos = cursor[(size_t)cv]++;
      tcol[(size_t)pos] = cu;
      tw[(size_t)pos] = L.ew[e];
    }
  }
  C.row_ptr.assign((size_t)nc + 1, 0);
  std::vector<int64_t> idx;
  for (int64_t r = 0; r < nc; ++r) {
    int64_t beg = cnt[(size_t)r], end = cnt[(size_t)r + 1];
    idx.resize((size_t)(end - beg));
    for (int64_t i = 0; i < end - beg; ++i) idx[(size_t)i] = beg + i;
    std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      return tcol[(size_t)a] < tcol[(size_t)b];
    });
    int64_t out = C.col.size();
    for (int64_t i = 0; i < (int64_t)idx.size(); ++i) {
      int32_t u = tcol[(size_t)idx[(size_t)i]];
      int64_t w = tw[(size_t)idx[(size_t)i]];
      if ((int64_t)C.col.size() > out && C.col.back() == u) {
        C.ew.back() += w;
      } else {
        C.col.push_back(u);
        C.ew.push_back(w);
      }
    }
    C.row_ptr[(size_t)r + 1] = (int64_t)C.col.size();
  }
  return C;
}

}  // namespace

extern "C" {

// Multilevel partition into num_parts groups: coarsen by heavy-edge
// matching until `coarsest` nodes remain (or matching stalls), partition
// the coarsest graph (weighted LDG, then label propagation to convergence),
// and project back level by level with capacitated weighted refinement.
// The caller rebalances to exact fills afterwards.
void llp_partition_multilevel(const int32_t* row_ptr, const int32_t* col,
                              int32_t n, int32_t num_parts, int32_t coarsest,
                              int32_t refine_passes, double slack,
                              int32_t* assign) {
  std::vector<CsrLevel> levels(1);
  CsrLevel& L0 = levels[0];
  L0.n = n;
  L0.row_ptr.assign(row_ptr, row_ptr + n + 1);
  L0.col.assign(col, col + row_ptr[n]);
  L0.ew.assign((size_t)row_ptr[n], 1);
  L0.nw.assign((size_t)n, 1);
  int64_t total_w = n;
  int64_t maxnw = std::max<int64_t>(1, (2 * total_w) / std::max(coarsest, 1));
  while (levels.back().n > coarsest) {
    CsrLevel next = coarsen_level(levels.back(), maxnw);
    if (next.n >= levels.back().n * 97 / 100) break;  // matching stalled
    levels.push_back(std::move(next));
  }
  int64_t cap_base = (total_w + num_parts - 1) / num_parts;
  int64_t cap2 =
      cap_base + std::max<int64_t>(1, (int64_t)((double)cap_base * slack));
  CsrLevel& Lc = levels.back();
  std::vector<int64_t> load((size_t)num_parts, 0);
  std::vector<int32_t> ac((size_t)Lc.n);
  ldg_weighted(Lc, num_parts, cap2 + maxnw, load, ac.data());
  for (int32_t pass = 0; pass < 4 * refine_passes; ++pass)
    if (lp_pass_weighted(Lc, num_parts, load, cap2, ac.data()) == 0) break;
  std::vector<int32_t> cur = std::move(ac);
  for (int64_t lev = (int64_t)levels.size() - 2; lev >= 0; --lev) {
    CsrLevel& Lf = levels[(size_t)lev];
    const std::vector<int32_t>& cmap = levels[(size_t)lev + 1].cmap;
    std::vector<int32_t> fine((size_t)Lf.n);
    for (int64_t v = 0; v < Lf.n; ++v)
      fine[(size_t)v] = cur[(size_t)cmap[(size_t)v]];
    std::fill(load.begin(), load.end(), 0);
    for (int64_t v = 0; v < Lf.n; ++v)
      load[(size_t)fine[(size_t)v]] += Lf.nw[(size_t)v];
    for (int32_t pass = 0; pass < refine_passes; ++pass)
      if (lp_pass_weighted(Lf, num_parts, load, cap2, fine.data()) == 0)
        break;
    cur = std::move(fine);
  }
  std::copy(cur.begin(), cur.end(), assign);
}

// Flat partition into num_parts groups of at most cap nodes: one LDG pass
// over `order` (score = assigned neighbours x remaining capacity, hard
// cap), then label-propagation restreams (score = neighbour count, slack
// cap2 >= cap) until no node moves or max_passes is reached.
// O(max_passes * (E + n * num_parts)).
void llp_partition_graph(const int32_t* row_ptr, const int32_t* col,
                         int32_t n, int32_t num_parts, int32_t max_passes,
                         int32_t cap, int32_t cap2, const int32_t* order,
                         int32_t* assign) {
  std::vector<int64_t> load((size_t)num_parts, 0);
  std::vector<int64_t> nb((size_t)num_parts, 0);
  std::fill(assign, assign + n, (int32_t)-1);
  for (int32_t i = 0; i < n; ++i) {
    int32_t v = order[i];
    std::fill(nb.begin(), nb.end(), 0);
    for (int32_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      int32_t a = assign[col[e]];
      if (a >= 0) nb[(size_t)a]++;
    }
    int64_t best_score = INT64_MIN;
    int32_t best = 0;
    for (int32_t p = 0; p < num_parts; ++p) {
      if (load[p] >= cap) continue;
      int64_t s = nb[(size_t)p] * (int64_t)(cap - load[p]);
      if (s > best_score) {
        best_score = s;
        best = p;
      }
    }
    assign[v] = best;
    load[(size_t)best]++;
  }
  for (int32_t pass = 0; pass < max_passes; ++pass) {
    int64_t moved = 0;
    for (int32_t v = 0; v < n; ++v) {
      int32_t cur = assign[v];
      std::fill(nb.begin(), nb.end(), 0);
      for (int32_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
        nb[(size_t)assign[col[e]]]++;
      }
      int64_t best_score = -1;
      int32_t best = cur;
      for (int32_t p = 0; p < num_parts; ++p) {
        if (p != cur && load[p] >= cap2) continue;
        if (nb[(size_t)p] > best_score) {
          best_score = nb[(size_t)p];
          best = p;
        }
      }
      if (best != cur && best_score > nb[(size_t)cur]) {
        load[(size_t)cur]--;
        load[(size_t)best]++;
        assign[v] = best;
        moved++;
      }
    }
    if (moved == 0) break;
  }
}

// Stable counting sort of the edges by sender: row_ptr (n_nodes + 1) and
// perm (E), the edge order sorted by sender; the caller gathers
// col = receivers[perm].
void llp_build_csr_perm(const int32_t* senders, int64_t n_edges,
                        int32_t n_nodes, int32_t* row_ptr, int64_t* perm) {
  std::vector<int64_t> counts((size_t)n_nodes + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) counts[(size_t)senders[e] + 1]++;
  for (int32_t v = 0; v < n_nodes; ++v) counts[(size_t)v + 1] += counts[v];
  for (int32_t v = 0; v <= n_nodes; ++v) row_ptr[v] = (int32_t)counts[v];
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    perm[cursor[(size_t)senders[e]]++] = e;
  }
}

}  // extern "C"
