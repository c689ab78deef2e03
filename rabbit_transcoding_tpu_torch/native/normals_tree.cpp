// Spanning-tree normal-sign orientation (host-sequential by nature).
//
// Semantics follow PCCNormalsGenerator3::orientNormals / addNeighbors
// (source/lib/PccLibEncoder/source/PCCNormalsGenerator.cpp:
// 178-234, 505-533 — linked for parity, re-implemented, never copied):
//
//  * per unvisited seed (ascending index): seed sign from the sum of
//    already-visited neighbours' normals; if none, from the previous
//    point's normal (or the viewpoint ray for point 0);
//  * grow a MAXIMUM spanning tree over the KNN graph, edge weight
//    |n_a . n_b| (strongest-agreement-first Prim), flipping each newly
//    visited point to agree with its tree parent;
//  * final global flip if the majority points away from the viewpoint.
//
// The tie-break on equal weights matches the reference's PCCWeightedEdge
// operator< (weight, then start, then end — max first), so orientation is
// bit-reproducible against the same KNN graph.
//
// The KNN graph arrives precomputed from the host cKDTree (the same graph
// the PCA estimation used); radius gating was applied by the caller when
// building the ok mask.

#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Edge {
  float weight;
  uint32_t start;
  uint32_t end;
  bool operator<(const Edge& rhs) const {
    if (weight == rhs.weight) {
      return start == rhs.start ? end < rhs.end : start < rhs.start;
    }
    return weight < rhs.weight;
  }
};

inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

}  // namespace

extern "C" {

// normals: (n, 3) float32, flipped in place.
// points:  (n, 3) float32.
// nbr_idx: (n, k) int32 (self typically in column 0).
// nbr_ok:  (n, k) uint8 — radius-gated adjacency mask for tree growth.
// viewpoint: (3,) float32.
// Returns the number of connected components seeded (>=1), or -1 on error.
int64_t rbv_orient_normals_tree(float* normals, const float* points,
                                const int32_t* nbr_idx,
                                const uint8_t* nbr_ok, int64_t n,
                                int64_t k, const float* viewpoint) {
  if (n <= 0 || k <= 0) return -1;
  std::vector<uint8_t> visited(n, 0);
  std::priority_queue<Edge> edges;
  int64_t components = 0;

  auto add_neighbors = [&](uint32_t current, double* acc,
                           int64_t* n_acc, bool gate) {
    acc[0] = acc[1] = acc[2] = 0.0;
    *n_acc = 0;
    const int32_t* row = nbr_idx + (int64_t)current * k;
    const uint8_t* okr = nbr_ok + (int64_t)current * k;
    const float* ncur = normals + (int64_t)current * 3;
    for (int64_t i = 0; i < k; i++) {
      // seeds scan the full-k neighbourhood (the reference's unbounded
      // nNQuery2); tree growth honours the radius gate (nNQuery)
      if (gate && okr[i] == 0) continue;
      uint32_t idx = (uint32_t)row[i];
      if ((int64_t)idx >= n) return false;
      if (!visited[idx]) {
        const float* nn = normals + (int64_t)idx * 3;
        edges.push(Edge{std::fabs(dot3(ncur, nn)), current, idx});
      } else if (idx != current) {
        const float* nn = normals + (int64_t)idx * 3;
        acc[0] += nn[0];
        acc[1] += nn[1];
        acc[2] += nn[2];
        (*n_acc)++;
      }
    }
    return true;
  };

  double acc[3];
  int64_t n_acc = 0;
  for (int64_t pt = 0; pt < n; pt++) {
    if (visited[pt]) continue;
    components++;
    visited[pt] = 1;
    if (!add_neighbors((uint32_t)pt, acc, &n_acc, /*gate=*/false)) return -1;
    float seed[3];
    if (n_acc == 0) {
      if (pt != 0) {
        seed[0] = normals[(pt - 1) * 3 + 0];
        seed[1] = normals[(pt - 1) * 3 + 1];
        seed[2] = normals[(pt - 1) * 3 + 2];
      } else {
        seed[0] = viewpoint[0] - points[pt * 3 + 0];
        seed[1] = viewpoint[1] - points[pt * 3 + 1];
        seed[2] = viewpoint[2] - points[pt * 3 + 2];
      }
    } else {
      seed[0] = (float)acc[0];
      seed[1] = (float)acc[1];
      seed[2] = (float)acc[2];
    }
    float* npt = normals + pt * 3;
    if (dot3(npt, seed) < 0.0f) {
      npt[0] = -npt[0];
      npt[1] = -npt[1];
      npt[2] = -npt[2];
    }
    while (!edges.empty()) {
      Edge e = edges.top();
      edges.pop();
      uint32_t cur = e.end;
      if (visited[cur]) continue;
      visited[cur] = 1;
      const float* ns = normals + (int64_t)e.start * 3;
      float* nc = normals + (int64_t)cur * 3;
      if (dot3(ns, nc) < 0.0f) {
        nc[0] = -nc[0];
        nc[1] = -nc[1];
        nc[2] = -nc[2];
      }
      if (!add_neighbors(cur, acc, &n_acc, /*gate=*/true)) return -1;
    }
  }

  // global majority flip toward the viewpoint (orientNormals :227-234)
  int64_t neg = 0;
  for (int64_t pt = 0; pt < n; pt++) {
    float ray[3] = {viewpoint[0] - points[pt * 3 + 0],
                    viewpoint[1] - points[pt * 3 + 1],
                    viewpoint[2] - points[pt * 3 + 2]};
    if (dot3(normals + pt * 3, ray) < 0.0f) neg++;
  }
  if (neg > (n + 1) / 2) {
    for (int64_t i = 0; i < n * 3; i++) normals[i] = -normals[i];
  }
  return components;
}

}  // extern "C"
