// Native neighbor-sampling core for NeighborLoader (sampling.py).
//
// The port's copy of graphneuralnetworks_tpu/native/sampler.cc, unchanged in
// what it computes, so that for one seed the two packages draw the same
// batches bit for bit. The reference's NeighborLoader
// (GNNGraphs/src/samplers.jl:28-105) walks a per-node neighbor cache in
// Julia; here the layered fixed-fanout expansion is a C++ hot loop
// (epoch-stamped node dedup + xorshift RNG) feeding the host->device batch
// pipeline. Built with g++ as a plain shared library into the repository's
// build/ (ops/cuda/build.py:load with host=True) and bound via ctypes, which
// releases the GIL for the call: Prefetcher threads sample while the step
// runs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  // unbiased-enough bounded draw for sampling fanouts
  uint64_t bounded(uint64_t n) { return n ? next() % n : 0; }
};

}  // namespace

extern "C" {

namespace {

// Epoch-stamped node->local-id table: O(1) dedup with zero hashing. The
// 2*n int32 scratch persists across calls (thread_local, so concurrent
// sampler workers — sampling.Prefetcher(workers=N) — never share state);
// a bump of `epoch` invalidates the whole table for free.
struct LocalTable {
  std::vector<int32_t> stamp;
  std::vector<int32_t> localid;
  int32_t epoch = 0;

  void begin(int64_t n) {
    if (static_cast<int64_t>(stamp.size()) < n) {
      stamp.assign(n, 0);
      localid.resize(n);
      epoch = 0;
    }
    if (++epoch == 0) {  // wrapped: hard reset
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 1;
    }
  }
  // returns local id, or -1 if unseen
  int32_t find(int64_t v) const {
    return stamp[v] == epoch ? localid[v] : -1;
  }
  void put(int64_t v, int32_t loc) {
    stamp[v] = epoch;
    localid[v] = loc;
  }
};

thread_local LocalTable g_table;

}  // namespace

// Layered neighbor expansion.
//
// The sampler is DRAM-latency-bound at 100M+ edge scale (each sampled edge
// is a random access into GB-sized arrays), so the layout is tuned for it:
// the caller pre-gathers senders and edge ids into CSR position order
// (csr_send / csr_eid, both int32 — half the footprint of the old
// order->senders chain and, crucially, two INDEPENDENT loads instead of a
// dependent chain), and the pick loop issues software prefetches a full
// node ahead.
//
//   csr_send[e_total] : sender per CSR slot (= senders[order])
//   csr_eid[e_total]  : original edge id per CSR slot (= order)
//   ptr[n+1]          : CSR row pointers over receivers
//   seeds[n_seeds]    : seed node ids
//   fanouts[n_layers]
//   n_nodes           : total node count (sizes the stamped dedup table)
// Outputs (caller-allocated to capacity):
//   nid_out[cap_nodes]          : unique node ids, seeds first
//   es_out / er_out[cap_edges]  : edges in local ids
//   eid_out[cap_edges]          : global (original) edge id per sampled edge
//                                 (the reference's EID, sampling.jl:72-75)
// Returns 0 on success; writes actual counts to n_nodes_out / n_edges_out.
int64_t gnn_sample_layers(
    const int32_t* csr_send, const int32_t* csr_eid, const int64_t* ptr,
    const int64_t* seeds, int64_t n_seeds, const int64_t* fanouts,
    int64_t n_layers, int32_t replace, uint64_t seed, int64_t n_nodes,
    int64_t cap_nodes, int64_t cap_edges,
    int64_t* nid_out, int32_t* es_out, int32_t* er_out, int64_t* eid_out,
    int64_t* n_nodes_out, int64_t* n_edges_out) {
  XorShift rng(seed);
  LocalTable& local = g_table;
  local.begin(n_nodes);
  int64_t n_nid = 0;
  for (int64_t i = 0; i < n_seeds; ++i) {
    int64_t v = seeds[i];
    if (local.find(v) < 0) {
      local.put(v, static_cast<int32_t>(n_nid));
      nid_out[n_nid++] = v;
    }
  }
  std::vector<int64_t> frontier(seeds, seeds + n_seeds);
  std::vector<int64_t> next_frontier;
  // pick positions are generated one frontier node AHEAD so their target
  // cache lines (csr_send / csr_eid, and the next node's ptr row) can be
  // prefetched while the current node's edges are consumed
  std::vector<int64_t> picks, picks_next;
  int64_t n_edges = 0;

  auto gen_picks = [&](int64_t v, int64_t k, std::vector<int64_t>& out) {
    out.clear();
    const int64_t lo = ptr[v], hi = ptr[v + 1];
    const int64_t deg = hi - lo;
    if (deg == 0) return;
    if (replace) {
      for (int64_t j = 0; j < k; ++j)
        out.push_back(lo + static_cast<int64_t>(rng.bounded(deg)));
    } else if (k >= deg) {
      for (int64_t j = lo; j < hi; ++j) out.push_back(j);
    } else {
      // Floyd's algorithm: k distinct draws from [0, deg)
      std::unordered_map<int64_t, int64_t> repl;
      for (int64_t j = deg - k; j < deg; ++j) {
        int64_t t = static_cast<int64_t>(rng.bounded(j + 1));
        auto it = repl.find(t);
        int64_t val = (it == repl.end()) ? t : it->second;
        auto jt = repl.find(j);
        repl[t] = (jt == repl.end()) ? j : jt->second;
        out.push_back(lo + val);
      }
    }
    for (int64_t p : out) {
      __builtin_prefetch(csr_send + p, 0, 1);
      __builtin_prefetch(csr_eid + p, 0, 1);
    }
  };

  for (int64_t layer = 0; layer < n_layers; ++layer) {
    const int64_t k = fanouts[layer];
    next_frontier.clear();
    const int64_t fsz = static_cast<int64_t>(frontier.size());
    if (fsz == 0) break;
    gen_picks(frontier[0], k, picks);
    for (int64_t fi = 0; fi < fsz; ++fi) {
      const int64_t v = frontier[fi];
      if (fi + 1 < fsz) {
        __builtin_prefetch(ptr + frontier[fi + 1], 0, 1);
        gen_picks(frontier[fi + 1], k, picks_next);
      }
      const int32_t v_loc = local.find(v);
      for (int64_t p : picks) {
        const int32_t u = csr_send[p];
        int32_t u_loc = local.find(u);
        if (u_loc < 0) {
          if (n_nid >= cap_nodes) return -1;
          u_loc = static_cast<int32_t>(n_nid);
          local.put(u, u_loc);
          nid_out[n_nid++] = u;
          next_frontier.push_back(u);
        }
        if (n_edges >= cap_edges) return -2;
        es_out[n_edges] = u_loc;
        er_out[n_edges] = v_loc;
        eid_out[n_edges] = csr_eid[p];
        ++n_edges;
      }
      picks.swap(picks_next);
    }
    frontier.swap(next_frontier);
  }
  *n_nodes_out = n_nid;
  *n_edges_out = n_edges;
  return 0;
}

}  // extern "C"
