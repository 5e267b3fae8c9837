// Native mesh-IO runtime for the JAX rebuild.
//
// The reference implements its data path natively in C++: CSV mesh readers
// (reference: src/fea_petsc.cpp:42-82), per-step snapshot writers
// (src/mycelium_sim_2D.cpp:463-475), and rounded-coordinate node
// deduplication for geometry export (src/mycelium_sim_2D.cpp:477-515).
// This module is the rebuild's native equivalent: a small C library exposed
// to Python via ctypes (no pybind11 in the image), handling the host-side
// hot paths that sit outside the XLA compute graph — bulk CSV parsing and
// first-appearance node dedup.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 meshio.cpp -o libmeshio.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <algorithm>
#include <string>
#include <vector>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// Numeric CSV parsing (header row skipped). Returns a malloc'd row-major
// double buffer; caller frees with meshio_free. Non-numeric cells parse as
// the prefix strtod accepts (matching the std::stod usage in the reference
// readers). Returns 0 on success.
// ---------------------------------------------------------------------------
int meshio_read_csv(const char* path, double** out_data, int64_t* out_rows,
                    int64_t* out_cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  // skip header line
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;

  std::vector<double> vals;
  vals.reserve(1 << 16);
  int64_t cols = -1;
  int64_t rows = 0;
  while (p < end) {
    // skip empty lines
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    int64_t c = 0;
    while (p < end && *p != '\n') {
      char* next = nullptr;
      double v = std::strtod(p, &next);
      if (next == p) return 5;  // unparsable cell: caller falls back
      vals.push_back(v);
      ++c;
      p = (next && next > p) ? next : p;
      while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
      if (p < end && *p == ',') ++p;
      if (p < end && *p == '\r') ++p;
    }
    if (p < end) ++p;  // consume '\n'
    if (cols < 0) cols = c;
    if (c != cols) return 3;  // ragged row
    ++rows;
  }
  double* data =
      static_cast<double*>(std::malloc(sizeof(double) * vals.size()));
  if (!data && !vals.empty()) return 4;
  std::memcpy(data, vals.data(), sizeof(double) * vals.size());
  *out_data = data;
  *out_rows = rows;
  *out_cols = cols < 0 ? 0 : cols;
  return 0;
}

void meshio_free(double* p) { std::free(p); }

// ---------------------------------------------------------------------------
// First-appearance node dedup on coordinates rounded to `decimals` places —
// the geometry-export contract (reference rounds with np.round to 6 decimals
// in Python and formats "%.6f" keys in C++; both quantize to 1e-6).
//
// pts: (n, 3) row-major. nodes_out: capacity n*3. inv_out: capacity n.
// Returns the number of unique nodes, or -1 on error.
// ---------------------------------------------------------------------------
struct Key3 {
  int64_t a, b, c;
  bool operator==(const Key3& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};
struct Key3Hash {
  size_t operator()(const Key3& k) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    mix(static_cast<uint64_t>(k.a));
    mix(static_cast<uint64_t>(k.b));
    mix(static_cast<uint64_t>(k.c));
    return static_cast<size_t>(h);
  }
};

static inline int64_t round_q(double v, double scale) {
  // match np.round (round-half-to-even is irrelevant at 1e-6 of float noise;
  // nearbyint uses the current rounding mode = to-nearest)
  return static_cast<int64_t>(std::llround(v * scale));
}

int64_t meshio_dedup_nodes(const double* pts, int64_t n, int decimals,
                           double* nodes_out, int64_t* inv_out) {
  if (n < 0) return -1;
  const double scale = std::pow(10.0, decimals);
  std::unordered_map<Key3, int64_t, Key3Hash> map;
  map.reserve(static_cast<size_t>(n) * 2);
  int64_t next_id = 0;
  for (int64_t i = 0; i < n; ++i) {
    Key3 k{round_q(pts[3 * i + 0], scale), round_q(pts[3 * i + 1], scale),
           round_q(pts[3 * i + 2], scale)};
    auto it = map.find(k);
    int64_t id;
    if (it == map.end()) {
      id = next_id++;
      map.emplace(k, id);
      nodes_out[3 * id + 0] = pts[3 * i + 0];
      nodes_out[3 * id + 1] = pts[3 * i + 1];
      nodes_out[3 * id + 2] = pts[3 * i + 2];
    } else {
      id = it->second;
    }
    inv_out[i] = id;
  }
  return next_id;
}

// ---------------------------------------------------------------------------
// Greedy path cover over the element graph — the host-side ordering pass
// behind the chain-ordered operator (mycelium_tpu/fea/chain.py).
// Semantics match chain.greedy_path_cover exactly: adjacency lists hold,
// for node v, first the opposite endpoints of elements where v is endpoint
// 0 (in element order), then those where v is endpoint 1; walk starts are
// taken in increasing-degree order (stable); each walk continues along the
// first unvisited neighbor. ~50x the pure-numpy/python implementation at
// 1e6 edges.
//
// conn: (n_elems, 2) int64 row-major. perm_out: capacity n_nodes.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int meshio_path_cover(const int64_t* conn, int64_t n_elems, int64_t n_nodes,
                      int64_t* perm_out) {
  if (n_elems < 0 || n_nodes <= 0) return 1;
  std::vector<int64_t> deg(static_cast<size_t>(n_nodes), 0);
  for (int64_t e = 0; e < n_elems; ++e) {
    int64_t a = conn[2 * e], b = conn[2 * e + 1];
    if (a < 0 || a >= n_nodes || b < 0 || b >= n_nodes) return 2;
    ++deg[a];
    ++deg[b];
  }
  std::vector<int64_t> indptr(static_cast<size_t>(n_nodes) + 1, 0);
  for (int64_t v = 0; v < n_nodes; ++v) indptr[v + 1] = indptr[v] + deg[v];
  std::vector<int64_t> adj(static_cast<size_t>(2 * n_elems));
  {
    std::vector<int64_t> cursor(indptr.begin(), indptr.end() - 1);
    for (int64_t e = 0; e < n_elems; ++e)  // endpoint-0 entries first
      adj[cursor[conn[2 * e]]++] = conn[2 * e + 1];
    for (int64_t e = 0; e < n_elems; ++e)
      adj[cursor[conn[2 * e + 1]]++] = conn[2 * e];
  }
  // stable counting sort of nodes by degree (path endpoints first)
  std::vector<int64_t> starts(static_cast<size_t>(n_nodes));
  {
    int64_t max_deg = 0;
    for (int64_t v = 0; v < n_nodes; ++v)
      if (deg[v] > max_deg) max_deg = deg[v];
    std::vector<int64_t> count(static_cast<size_t>(max_deg) + 2, 0);
    for (int64_t v = 0; v < n_nodes; ++v) ++count[deg[v] + 1];
    for (int64_t d = 0; d <= max_deg; ++d) count[d + 1] += count[d];
    for (int64_t v = 0; v < n_nodes; ++v) starts[count[deg[v]]++] = v;
  }
  std::vector<uint8_t> visited(static_cast<size_t>(n_nodes), 0);
  // per-node cursor over its adjacency list: neighbors before it are
  // already visited, so each list is scanned once across the whole run
  std::vector<int64_t> scan(indptr.begin(), indptr.end() - 1);
  int64_t out = 0;
  for (int64_t si = 0; si < n_nodes; ++si) {
    int64_t cur = starts[si];
    if (visited[cur]) continue;
    for (;;) {
      visited[cur] = 1;
      perm_out[out++] = cur;
      int64_t nxt = -1;
      int64_t& k = scan[cur];
      while (k < indptr[cur + 1]) {
        int64_t nb = adj[k];
        if (!visited[nb]) { nxt = nb; break; }
        ++k;
      }
      if (nxt < 0) break;
      cur = nxt;
    }
  }
  return out == n_nodes ? 0 : 3;
}

// ---------------------------------------------------------------------------
// Union-find spanning forest in edge order (mycelium_tpu/fea/tree.py
// spanning_forest): tree_out[e] = 1 iff edge e joins two components.
// Self-loops and out-of-range endpoints are left 0 / rejected as in the
// Python oracle. Returns 0 on success.
// ---------------------------------------------------------------------------
int meshio_spanning_forest(const int64_t* conn, int64_t n_elems,
                           int64_t n_nodes, uint8_t* tree_out) {
  if (n_elems < 0 || n_nodes <= 0) return 1;
  std::vector<int64_t> parent(static_cast<size_t>(n_nodes));
  for (int64_t v = 0; v < n_nodes; ++v) parent[v] = v;
  auto find = [&parent](int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t nxt = parent[x];
      parent[x] = root;
      x = nxt;
    }
    return root;
  };
  for (int64_t e = 0; e < n_elems; ++e) {
    int64_t a = conn[2 * e], b = conn[2 * e + 1];
    if (a < 0 || a >= n_nodes || b < 0 || b >= n_nodes) return 2;
    int64_t ra = find(a), rb = find(b);
    if (ra != rb) {
      parent[rb] = ra;
      tree_out[e] = 1;
    } else {
      tree_out[e] = 0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Tree-elimination schedule peel (mycelium_tpu/fea/tree.py
// build_tree_schedule): simulate the spanning-forest peel on the host and
// record the static per-level schedule. Semantics are replicated from the
// Python oracle EXACTLY (seed order = increasing node id; walk follows
// adjacency insertion order; per-seed demotion interleaves with emission;
// the single-slot-path two-junction quirk) — the Python build stays in
// tree.py as the fallback and the equality oracle. The python walk costs
// ~2-4 minutes at 1e6 nodes; this is ~1 s.
//
// Outputs are caller-allocated flat arrays (slot arrays: capacity n_nodes —
// each node is eliminated at most once; path arrays: capacity n_nodes;
// att_* are (P,2) row-major). first_pos/last_pos/att_pos are LEVEL-LOCAL
// slot indices, matching the Python schedule layout. Returns 0 on success,
// 4 if the peel stalls (non-forest structure), 5 if max_levels exceeded.
// ---------------------------------------------------------------------------
int meshio_tree_peel(
    const int64_t* conn, int64_t n_elems, int64_t n_nodes,
    const uint8_t* tree_edge, const uint8_t* free_mask,
    int64_t max_path_len,
    int32_t* slots_out, uint8_t* path_start_out, int8_t* left_kind_out,
    int32_t* left_id_out, uint8_t* left_flip_out,
    int32_t* first_pos_out, int32_t* last_pos_out,
    int8_t* att_kind_out, int32_t* att_id_out, uint8_t* att_flip_out,
    int32_t* att_level_out, int32_t* att_pos_out, int32_t* fill_out_out,
    int64_t max_levels, int64_t* slot_off_out, int64_t* path_off_out,
    int64_t* n_levels_out, int64_t* n_fill_out) {
  if (n_elems < 0 || n_nodes <= 0) return 1;
  constexpr int8_t KIND_NONE = 0, KIND_ELEM = 1, KIND_FILL = 2;
  struct Entry { int64_t nbr; int32_t id; int8_t kind; uint8_t flip; };
  std::vector<std::vector<Entry>> adj(static_cast<size_t>(n_nodes));
  std::vector<int64_t> edge_a, edge_b;  // alive-degree edge list (+fills)
  edge_a.reserve(static_cast<size_t>(n_elems));
  edge_b.reserve(static_cast<size_t>(n_elems));
  for (int64_t e = 0; e < n_elems; ++e) {
    if (!tree_edge[e]) continue;
    int64_t a = conn[2 * e], b = conn[2 * e + 1];
    if (a < 0 || a >= n_nodes || b < 0 || b >= n_nodes) return 2;
    if (free_mask[a] && free_mask[b] && a != b) {
      adj[a].push_back({b, static_cast<int32_t>(e), KIND_ELEM, 0});
      adj[b].push_back({a, static_cast<int32_t>(e), KIND_ELEM, 0});
      edge_a.push_back(a);
      edge_b.push_back(b);
    }
  }

  std::vector<uint8_t> alive(free_mask, free_mask + n_nodes);
  std::vector<int64_t> deg(static_cast<size_t>(n_nodes), 0);
  std::vector<uint8_t> elim(static_cast<size_t>(n_nodes), 0);
  // per-level visited via epoch stamps (avoids a 1 MB clear per level)
  std::vector<int32_t> visit_ep(static_cast<size_t>(n_nodes), -1);
  std::vector<int32_t> node_level(static_cast<size_t>(n_nodes), -1);
  std::vector<int32_t> node_pos(static_cast<size_t>(n_nodes), -1);
  struct Pending { int64_t path; int32_t side; int64_t jnode; };
  std::vector<Pending> pending;
  std::vector<int64_t> walk_buf;  // path node scratch

  int64_t n_fill = 0, slot_cnt = 0, path_cnt = 0, level_idx = 0;
  slot_off_out[0] = 0;
  path_off_out[0] = 0;

  auto any_alive = [&]() {
    for (int64_t v = 0; v < n_nodes; ++v)
      if (alive[v]) return true;
    return false;
  };

  while (any_alive()) {
    if (level_idx >= max_levels) return 5;
    const int32_t ep = static_cast<int32_t>(level_idx);
    // vectorized-equivalent degree over alive-alive edges
    std::fill(deg.begin(), deg.end(), 0);
    for (size_t k = 0; k < edge_a.size(); ++k) {
      if (alive[edge_a[k]] && alive[edge_b[k]]) {
        ++deg[edge_a[k]];
        ++deg[edge_b[k]];
      }
    }
    bool any_elim = false;
    for (int64_t v = 0; v < n_nodes; ++v) {
      elim[v] = alive[v] && deg[v] <= 2;
      any_elim |= elim[v];
    }
    if (!any_elim) return 4;  // peel stuck: non-forest structure

    const int64_t level_slot_base = slot_cnt;

    auto walk = [&](int64_t start, int64_t avoid, bool reverse_into) {
      // follow unvisited elim nodes from start (excluded), first-match in
      // adjacency order, never stepping back to the immediate prev
      size_t mark = walk_buf.size();
      int64_t cur = start, prev = avoid;
      for (;;) {
        int64_t nxt = -1;
        for (const Entry& nb : adj[cur]) {
          if (alive[nb.nbr] && elim[nb.nbr] && nb.nbr != prev &&
              visit_ep[nb.nbr] != ep) {
            nxt = nb.nbr;
            break;
          }
        }
        if (nxt < 0) break;
        visit_ep[nxt] = ep;
        walk_buf.push_back(nxt);
        prev = cur;
        cur = nxt;
      }
      if (reverse_into)  // back-walk: python prepends reversed
        std::reverse(walk_buf.begin() + mark, walk_buf.end());
      return walk_buf.size() - mark;
    };

    auto emit_path = [&](const int64_t* nodes, int64_t len) -> int {
      const int64_t base = slot_cnt - level_slot_base;  // level-local
      const int64_t p = path_cnt;
      for (int64_t i = 0; i < len; ++i) {
        const int64_t nd = nodes[i];
        slots_out[slot_cnt] = static_cast<int32_t>(nd);
        path_start_out[slot_cnt] = (i == 0);
        if (i == 0) {
          left_kind_out[slot_cnt] = KIND_NONE;
          left_id_out[slot_cnt] = 0;
          left_flip_out[slot_cnt] = 0;
        } else {
          const Entry* found = nullptr;
          for (const Entry& nb : adj[nodes[i - 1]])
            if (nb.nbr == nd) { found = &nb; break; }
          if (!found) return 6;  // path edge missing
          left_kind_out[slot_cnt] = found->kind;
          left_id_out[slot_cnt] = found->id;
          left_flip_out[slot_cnt] = found->flip;
        }
        node_level[nd] = static_cast<int32_t>(level_idx);
        node_pos[nd] = static_cast<int32_t>(base + i);
        ++slot_cnt;
      }
      first_pos_out[p] = static_cast<int32_t>(base);
      last_pos_out[p] = static_cast<int32_t>(base + len - 1);

      int8_t pk[2] = {KIND_NONE, KIND_NONE};
      int32_t pi[2] = {0, 0};
      uint8_t pf[2] = {0, 0};
      int64_t juncs[2] = {-1, -1};
      for (int side = 0; side < 2; ++side) {
        const int64_t endn = nodes[side == 0 ? 0 : len - 1];
        // candidates = alive non-elim neighbors, adjacency order
        const Entry* cand = nullptr;
        int64_t n_cands = 0, cand_rank = 0;
        // single-slot path, side 1: skip the first candidate (two
        // junctions), or none at all if the single junction is taken
        int64_t skip = 0;
        if (len == 1 && side == 1) {
          for (const Entry& nb : adj[endn])
            if (alive[nb.nbr] && !elim[nb.nbr]) ++n_cands;
          if (n_cands > 1) skip = 1;
          else if (n_cands == 1 && juncs[0] >= 0) skip = n_cands + 1;
        }
        for (const Entry& nb : adj[endn]) {
          if (alive[nb.nbr] && !elim[nb.nbr]) {
            if (cand_rank++ == skip) { cand = &nb; break; }
          }
        }
        if (cand) {
          pk[side] = cand->kind;
          pi[side] = cand->id;
          pf[side] = !cand->flip;
          juncs[side] = cand->nbr;
          pending.push_back({p, side, cand->nbr});
        }
      }
      att_kind_out[2 * p] = pk[0];
      att_kind_out[2 * p + 1] = pk[1];
      att_id_out[2 * p] = pi[0];
      att_id_out[2 * p + 1] = pi[1];
      att_flip_out[2 * p] = pf[0];
      att_flip_out[2 * p + 1] = pf[1];
      if (juncs[0] >= 0 && juncs[1] >= 0) {
        const int32_t fid = static_cast<int32_t>(n_fill++);
        fill_out_out[p] = fid;
        adj[juncs[0]].push_back({juncs[1], fid, KIND_FILL, 0});
        adj[juncs[1]].push_back({juncs[0], fid, KIND_FILL, 1});
        edge_a.push_back(juncs[0]);
        edge_b.push_back(juncs[1]);
      } else {
        fill_out_out[p] = -1;
      }
      ++path_cnt;
      return 0;
    };

    for (int64_t seed = 0; seed < n_nodes; ++seed) {
      if (!elim[seed] || visit_ep[seed] == ep) continue;
      visit_ep[seed] = ep;
      walk_buf.clear();
      const size_t n_back = walk(seed, -1, /*reverse_into=*/true);
      walk_buf.push_back(seed);
      // the python walks fwd from the SEED avoiding back[0] (the seed's
      // immediate back-neighbor); after the back-walk reversal that node
      // sits at walk_buf[n_back - 1], directly before the seed
      walk(seed, n_back ? walk_buf[n_back - 1] : -1,
           /*reverse_into=*/false);
      const int64_t len_full = static_cast<int64_t>(walk_buf.size());
      const int64_t* nodes_full = walk_buf.data();
      if (max_path_len > 0 && len_full > max_path_len) {
        int64_t i = 0;
        while (i < len_full) {
          const int64_t clen = std::min(max_path_len, len_full - i);
          if (i + max_path_len < len_full)
            elim[nodes_full[i + max_path_len]] = 0;  // demote
          const int rc = emit_path(nodes_full + i, clen);
          if (rc) return rc;
          i += max_path_len + 1;
        }
      } else {
        const int rc = emit_path(nodes_full, len_full);
        if (rc) return rc;
      }
    }

    slot_off_out[level_idx + 1] = slot_cnt;
    path_off_out[level_idx + 1] = path_cnt;
    for (int64_t v = 0; v < n_nodes; ++v)
      alive[v] = alive[v] && !elim[v];
    ++level_idx;
  }

  for (const Pending& pd : pending) {
    att_level_out[2 * pd.path + pd.side] = node_level[pd.jnode];
    att_pos_out[2 * pd.path + pd.side] = node_pos[pd.jnode];
  }
  *n_levels_out = level_idx;
  *n_fill_out = n_fill;
  return 0;
}

}  // extern "C"
