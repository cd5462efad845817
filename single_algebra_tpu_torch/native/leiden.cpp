// Leiden community detection over a symmetric CSR adjacency.
//
// The clustering stage of the scRNA pipeline (scanpy tl.leiden /
// leidenalg RBConfigurationVertexPartition semantics): queue-based local
// moving, a refinement phase that guarantees connected communities, and
// graph aggregation, iterated to a fixed point (Traag, Waltman & van Eck
// 2019). The reference ships no clustering; its downstream consumers run
// leidenalg on CPU — this is the native-runtime equivalent, a pointer-
// chasing irregular-graph workload that belongs on the host next to the
// TPU doing the kNN/embedding math.
//
// Quality: Q = sum_c [ e_c / m2 - gamma * (tot_c / m2)^2 ], where e_c is
// the double-counted intra-community weight, tot_c the community
// strength, m2 the double-counted total weight. Gain of moving v into c
// (v currently unassigned): k_{v->c} - gamma * k_v * tot_c / m2.
//
// Plain C ABI for ctypes (no pybind11 in this image). Deterministic for
// a fixed seed (xorshift64* order, greedy tie-break on lowest id).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545f4914f6cdd1dULL;
  }
  // uniform in [0, n)
  int64_t below(int64_t n) { return static_cast<int64_t>(next() % static_cast<uint64_t>(n)); }
};

void shuffle_order(std::vector<int64_t>& order, Rng& rng) {
  for (int64_t i = static_cast<int64_t>(order.size()) - 1; i > 0; --i) {
    std::swap(order[i], order[rng.below(i + 1)]);
  }
}

struct Graph {
  int64_t n;
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<double> weights;
  std::vector<double> strength;   // k_v incl. self-loop weight
  std::vector<double> self_loop;  // A_vv
  double m2;                      // sum of strengths

  void finalize() {
    strength.assign(n, 0.0);
    self_loop.assign(n, 0.0);
    m2 = 0.0;
    for (int64_t v = 0; v < n; ++v) {
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        strength[v] += weights[e];
        if (indices[e] == v) self_loop[v] += weights[e];
      }
      m2 += strength[v];
    }
  }
};

// Queue-based local moving. `comm` holds the (possibly non-singleton)
// starting partition; returns the number of moves made.
int64_t local_move(const Graph& g, std::vector<int32_t>& comm,
                   double gamma, Rng& rng) {
  const int64_t n = g.n;
  std::vector<double> tot(n, 0.0);
  std::vector<int64_t> csize(n, 0);
  int32_t max_id = 0;
  for (int64_t v = 0; v < n; ++v) {
    tot[comm[v]] += g.strength[v];
    csize[comm[v]] += 1;
    max_id = std::max(max_id, comm[v]);
  }
  // ids never used by the start partition are available as fresh
  // singleton communities (the "empty community" candidate)
  std::vector<int32_t> free_ids;
  for (int64_t c = n - 1; c > max_id; --c) {
    free_ids.push_back(static_cast<int32_t>(c));
  }

  std::vector<int64_t> queue(n);
  for (int64_t i = 0; i < n; ++i) queue[i] = i;
  shuffle_order(queue, rng);
  std::vector<uint8_t> in_queue(n, 1);
  size_t head = 0;

  // scratch: neighbor-community weights
  std::vector<double> kvc(n, 0.0);
  std::vector<int32_t> touched;
  touched.reserve(64);

  int64_t moves = 0;
  const double inv_m2 = g.m2 > 0 ? 1.0 / g.m2 : 0.0;

  while (head < queue.size()) {
    const int64_t v = queue[head++];
    in_queue[v] = 0;
    const int32_t cv = comm[v];
    tot[cv] -= g.strength[v];
    csize[cv] -= 1;
    if (csize[cv] == 0) free_ids.push_back(cv);

    touched.clear();
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      const int32_t u = g.indices[e];
      if (u == v) continue;
      const int32_t cu = comm[u];
      if (kvc[cu] == 0.0) touched.push_back(cu);
      kvc[cu] += g.weights[e];
    }

    // best community: staying singleton (gain 0) is the baseline; the
    // current community competes like any other
    int32_t best = cv;
    double best_gain = kvc[cv] - gamma * g.strength[v] * tot[cv] * inv_m2;
    if (best_gain < 0.0) { best_gain = 0.0; best = -1; }
    for (const int32_t c : touched) {
      const double gain = kvc[c] - gamma * g.strength[v] * tot[c] * inv_m2;
      if (gain > best_gain + 1e-15 ||
          (gain > best_gain - 1e-15 && best != -1 && c < best)) {
        best_gain = gain;
        best = c;
      }
    }
    if (best == -1) {
      // fresh singleton community beats every negative-gain option;
      // if v's old community just emptied, its id is on the stack
      best = free_ids.back();
      free_ids.pop_back();
    }

    for (const int32_t c : touched) kvc[c] = 0.0;

    if (csize[best] == 0 && !free_ids.empty() && free_ids.back() == best) {
      free_ids.pop_back();  // reusing the id we just freed
    }
    tot[best] += g.strength[v];
    csize[best] += 1;
    if (best != cv) {
      comm[v] = best;
      ++moves;
      // re-queue neighbors now outside v's new community
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
        const int32_t u = g.indices[e];
        if (u != v && comm[u] != best && !in_queue[u]) {
          in_queue[u] = 1;
          queue.push_back(u);
        }
      }
    }
  }
  return moves;
}

// Refinement: within each local-move community, rebuild communities from
// singletons so every refined community is connected. Only well-connected
// singleton nodes merge (greedy best positive gain), visiting nodes in
// seeded random order.
int64_t refine(const Graph& g, const std::vector<int32_t>& comm,
               std::vector<int32_t>& refined, double gamma, Rng& rng) {
  const int64_t n = g.n;
  refined.resize(n);
  for (int64_t v = 0; v < n; ++v) refined[v] = static_cast<int32_t>(v);

  std::vector<double> rtot(g.strength);       // refined community strength
  std::vector<double> ctot(n, 0.0);           // coarse community strength
  std::vector<double> kv_in(n, 0.0);          // weight from v into comm[v]\{v}
  for (int64_t v = 0; v < n; ++v) {
    ctot[comm[v]] += g.strength[v];
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      const int32_t u = g.indices[e];
      if (u != v && comm[u] == comm[v]) kv_in[v] += g.weights[e];
    }
  }
  std::vector<int64_t> rsize(n, 1);  // nodes per refined community

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  shuffle_order(order, rng);

  std::vector<double> kvc(n, 0.0);
  std::vector<int32_t> touched;
  touched.reserve(64);
  const double inv_m2 = g.m2 > 0 ? 1.0 / g.m2 : 0.0;
  int64_t merges = 0;

  for (const int64_t v : order) {
    if (rsize[refined[v]] != 1) continue;  // only singletons initiate merges
    // well-connectedness of v within its coarse community
    if (kv_in[v] + 1e-15 <
        gamma * g.strength[v] * (ctot[comm[v]] - g.strength[v]) * inv_m2) {
      continue;
    }
    touched.clear();
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      const int32_t u = g.indices[e];
      if (u == v || comm[u] != comm[v]) continue;
      const int32_t rc = refined[u];
      if (kvc[rc] == 0.0) touched.push_back(rc);
      kvc[rc] += g.weights[e];
    }
    int32_t best = -1;
    double best_gain = 0.0;
    for (const int32_t c : touched) {
      if (c == refined[v]) continue;
      const double gain = kvc[c] - gamma * g.strength[v] * rtot[c] * inv_m2;
      if (gain > best_gain + 1e-15 ||
          (gain > best_gain - 1e-15 && best != -1 && c < best)) {
        best_gain = gain;
        best = c;
      }
    }
    for (const int32_t c : touched) kvc[c] = 0.0;
    if (best != -1) {
      rtot[best] += g.strength[v];
      rtot[refined[v]] -= g.strength[v];
      rsize[best] += 1;
      rsize[refined[v]] -= 1;
      refined[v] = best;
      ++merges;
    }
  }
  return merges;
}

// Relabel to contiguous [0, k); returns k.
int64_t compress(std::vector<int32_t>& labels) {
  std::vector<int32_t> remap(labels.size(), -1);
  int32_t next = 0;
  for (auto& l : labels) {
    if (remap[l] == -1) remap[l] = next++;
    l = remap[l];
  }
  return next;
}

// Aggregate g by `part` (contiguous, k communities) into `out`.
void aggregate(const Graph& g, const std::vector<int32_t>& part, int64_t k,
               Graph& out) {
  out.n = k;
  std::vector<double> row(k, 0.0);
  std::vector<int32_t> touched;
  touched.reserve(64);
  // group original nodes by aggregate id
  std::vector<int64_t> count(k, 0);
  for (int64_t v = 0; v < g.n; ++v) count[part[v]]++;
  std::vector<int64_t> start(k + 1, 0);
  for (int64_t a = 0; a < k; ++a) start[a + 1] = start[a] + count[a];
  std::vector<int64_t> members(g.n);
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    for (int64_t v = 0; v < g.n; ++v) members[cur[part[v]]++] = v;
  }
  out.indptr.assign(k + 1, 0);
  out.indices.clear();
  out.weights.clear();
  for (int64_t a = 0; a < k; ++a) {
    touched.clear();
    for (int64_t i = start[a]; i < start[a + 1]; ++i) {
      const int64_t v = members[i];
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
        const int32_t b = part[g.indices[e]];
        if (row[b] == 0.0) touched.push_back(b);
        row[b] += g.weights[e];
      }
    }
    std::sort(touched.begin(), touched.end());
    for (const int32_t b : touched) {
      out.indices.push_back(b);
      out.weights.push_back(row[b]);
      row[b] = 0.0;
    }
    out.indptr[a + 1] = static_cast<int64_t>(out.indices.size());
  }
  out.finalize();
}

double quality(const Graph& g, const std::vector<int32_t>& comm,
               int64_t k, double gamma) {
  if (g.m2 <= 0) return 0.0;
  std::vector<double> e_c(k, 0.0), tot(k, 0.0);
  for (int64_t v = 0; v < g.n; ++v) {
    tot[comm[v]] += g.strength[v];
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      if (comm[g.indices[e]] == comm[v]) e_c[comm[v]] += g.weights[e];
    }
  }
  double q = 0.0;
  for (int64_t c = 0; c < k; ++c) {
    q += e_c[c] / g.m2 - gamma * (tot[c] / g.m2) * (tot[c] / g.m2);
  }
  return q;
}

}  // namespace

extern "C" {

// Returns the number of communities (or -1 on invalid input). labels_out
// must hold n int32. quality_out (1 double) receives the final quality.
int64_t leiden_cluster(const int64_t* indptr, const int32_t* indices,
                       const float* weights, int64_t n, double resolution,
                       uint64_t seed, int64_t max_levels,
                       int32_t* labels_out, double* quality_out) {
  if (n <= 0) return -1;
  Graph g;
  g.n = n;
  g.indptr.assign(indptr, indptr + n + 1);
  const int64_t nnz = indptr[n];
  g.indices.assign(indices, indices + nnz);
  g.weights.resize(nnz);
  for (int64_t i = 0; i < nnz; ++i) g.weights[i] = weights[i];
  g.finalize();

  Rng rng(seed);
  std::vector<int32_t> labels(n);  // original node -> current community
  for (int64_t v = 0; v < n; ++v) labels[v] = static_cast<int32_t>(v);

  std::vector<int32_t> comm(labels);  // partition of the CURRENT graph
  Graph cur = g;

  for (int64_t level = 0; level < max_levels; ++level) {
    const int64_t moves = local_move(cur, comm, resolution, rng);
    int64_t k = compress(comm);
    if (moves == 0 || k == cur.n) {
      // fixed point: push the final partition down to original nodes
      for (int64_t v = 0; v < n; ++v) labels[v] = comm[labels[v]];
      break;
    }

    std::vector<int32_t> refined;
    refine(cur, comm, refined, resolution, rng);
    const int64_t rk = compress(refined);

    // aggregate over the REFINED partition; the local-move partition
    // becomes the starting partition of the aggregate graph
    std::vector<int32_t> agg_comm(rk, -1);
    for (int64_t v = 0; v < cur.n; ++v) {
      agg_comm[refined[v]] = comm[v];
    }
    for (int64_t v = 0; v < n; ++v) labels[v] = refined[labels[v]];

    Graph next;
    aggregate(cur, refined, rk, next);
    cur = std::move(next);
    comm = std::move(agg_comm);

    if (level == max_levels - 1) {
      // out of levels: collapse to the current coarse partition
      for (int64_t v = 0; v < n; ++v) labels[v] = comm[labels[v]];
    }
  }

  const int64_t k = compress(labels);
  if (quality_out) *quality_out = quality(g, labels, k, resolution);
  std::memcpy(labels_out, labels.data(), n * sizeof(int32_t));
  return k;
}

}  // extern "C"
