// Native graph-ordering kernels for the KKT structure planner.
//
// Role parity with the reference's native layer: TensCalc leans on
// native code at build time for factorization planning (symamd ordering
// over an instantiated sparsity pattern, lib/@csparse/sparsity_ldl.m:40-62,
// and the C instruction table lib/csparse/instructionsTableUTHash.c).
// Here the planning pass computes a bandwidth-reducing reverse
// Cuthill-McKee ordering of the KKT adjacency graph; this C++
// implementation replaces the scipy fallback for large patterns.
//
// C API (ctypes-friendly, CSR graph over int64):
//   tc_rcm(n, indptr, indices, perm_out)      -> 0 on success
//   tc_bandwidth(n, indptr, indices, perm)    -> half bandwidth
//   tc_version()                              -> ABI version

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

int64_t tc_version() { return 1; }

// Breadth-first level structure rooted at `root`; returns eccentricity
// and fills `last_level` with the nodes of the deepest level.
static int64_t level_structure(int64_t n, const int64_t* indptr,
                               const int64_t* indices, int64_t root,
                               std::vector<int64_t>& order,
                               std::vector<int64_t>& last_level) {
  std::vector<int64_t> depth(n, -1);
  order.clear();
  order.reserve(n);
  order.push_back(root);
  depth[root] = 0;
  int64_t maxd = 0;
  for (size_t h = 0; h < order.size(); ++h) {
    int64_t u = order[h];
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
      int64_t v = indices[k];
      if (depth[v] < 0) {
        depth[v] = depth[u] + 1;
        maxd = std::max(maxd, depth[v]);
        order.push_back(v);
      }
    }
  }
  last_level.clear();
  for (int64_t v : order)
    if (depth[v] == maxd) last_level.push_back(v);
  return maxd;
}

// George-Liu pseudo-peripheral node finder.
static int64_t pseudo_peripheral(int64_t n, const int64_t* indptr,
                                 const int64_t* indices, int64_t start) {
  std::vector<int64_t> order, last;
  int64_t root = start;
  int64_t ecc = level_structure(n, indptr, indices, root, order, last);
  for (int iter = 0; iter < 16; ++iter) {
    // candidate: minimum-degree node of the last level
    int64_t best = last[0];
    int64_t bestdeg = indptr[best + 1] - indptr[best];
    for (int64_t v : last) {
      int64_t d = indptr[v + 1] - indptr[v];
      if (d < bestdeg) {
        best = v;
        bestdeg = d;
      }
    }
    int64_t ecc2 = level_structure(n, indptr, indices, best, order, last);
    if (ecc2 <= ecc) break;
    ecc = ecc2;
    root = best;
  }
  return root;
}

// Reverse Cuthill-McKee over a possibly-disconnected undirected CSR graph.
int tc_rcm(int64_t n, const int64_t* indptr, const int64_t* indices,
           int64_t* perm_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> nbrs;

  for (int64_t seed = 0; seed < n; ++seed) {
    if (visited[seed]) continue;
    int64_t root = pseudo_peripheral(n, indptr, indices, seed);
    if (visited[root]) root = seed;  // disconnected oddity guard
    // Cuthill-McKee BFS with neighbors sorted by increasing degree
    std::queue<int64_t> q;
    q.push(root);
    visited[root] = 1;
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int64_t v = indices[k];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return deg[a] < deg[b] || (deg[a] == deg[b] && a < b);
      });
      for (int64_t v : nbrs) q.push(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
  return 0;
}

// Half bandwidth of the permuted pattern: max |pos[i]-pos[j]| over edges.
int64_t tc_bandwidth(int64_t n, const int64_t* indptr, const int64_t* indices,
                     const int64_t* perm) {
  std::vector<int64_t> pos(n);
  for (int64_t i = 0; i < n; ++i) pos[perm[i]] = i;
  int64_t bw = 0;
  for (int64_t u = 0; u < n; ++u)
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
      int64_t d = pos[u] - pos[indices[k]];
      if (d < 0) d = -d;
      bw = std::max(bw, d);
    }
  return bw;
}

}  // extern "C"
