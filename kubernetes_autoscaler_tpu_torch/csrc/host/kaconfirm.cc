// Native sequential confirmation pass for scale-down.
//
// Reference counterpart: the commit-on-success ordering of
// simulator/cluster.go:174-188 driven by core/scaledown/planner NodesToDelete —
// the one latency-critical HOST-side loop of the control loop, where Python
// would be too slow. The PyTorch port's own copy of the reference package's
// sidecar/native/kaconfirm.cc: the same algorithm and C entry point.
//
// Semantics (mirrors core/scaledown/planner.py attempt()):
//   * candidates processed in the given order (oldest unneeded clock first)
//   * per candidate: its victim slots (original residents + pods RECEIVED
//     from earlier accepted drains) re-place group-by-group, first feasible
//     node in index order, against live free capacity
//   * all-or-nothing: failure reverts the candidate's placements
//   * group min-size room, empty/drain/total budgets, and min-quota gates
//     applied exactly as the Python pass does
//   * ANY number of PodDisruptionBudgets ride as a per-slot MULTI-WORD
//     membership bitmask ([pdb_words] u64 per slot)
//   * CONSTRAINED TIER: zone- and host-scope
//     topology spread and host/zone-scope required anti-affinity evaluate natively
//     against incrementally-maintained count planes, mirroring the Python
//     pass's ConfirmOracle verdicts (utils/oracle.py spread_ok /
//     anti_affinity_ok): domain counts over ELIGIBLE nodes, global minimum
//     over eligible domains, self-match term, per-pod re-evaluation as
//     counts shift; host-kind spread maintains its global minimum O(1)
//     through a per-group count histogram over eligible nodes. Groups
//     needing more (pod affinity, lossy
//     encodings, min_domains/policies, host ports) stay on the Python pass —
//     the planner's gate routes them there.
//
// Build: compiled on first use with the host C++ compiler into the port's
// _build/ directory (ops/kernels/build.build_host, loaded by
// core/scaledown/native_confirm.py); std headers only.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Move {
  int slot;
  int node;
  int group;
};

// Constrained-tier state: per-group count planes + zone aggregates.
// Aggregation convention follows the Python oracle: spread counts aggregate
// over ELIGIBLE nodes only and zones are domains only while they still hold
// at least one eligible node; anti counts aggregate over all nodes.
struct ConState {
  int n = 0, g = 0, nz = 0;
  const int32_t* zone_id = nullptr;       // [n]; 0 = no zone
  const uint8_t* spread_kind = nullptr;   // [g]; 0 none, 1 host, 2 zone
  const int32_t* max_skew = nullptr;      // [g]
  const uint8_t* spread_self = nullptr;   // [g]
  const uint8_t* has_anti_host = nullptr; // [g]
  const uint8_t* has_anti_zone = nullptr; // [g]
  const uint8_t* aff_kind = nullptr;      // [g]; 0 none, 1 host, 2 zone
  const uint8_t* aff_self = nullptr;      // [g] pod matches its own term
  const uint8_t* one_per_node = nullptr;  // [g] limit_g: anti-self | ports
  // python's exact path ORACLE-MOVES only need_exact groups; pods of
  // limit-only (pure port) groups leave the count planes stale there —
  // mirror that staleness or plans diverge
  const uint8_t* oracle_moved = nullptr;  // [g] = need_exact
  const uint8_t* elig = nullptr;          // [g*n] spread domain eligibility
  int32_t* cnt_node = nullptr;            // [g*n] spread matches per node
  int32_t* anti_host_node = nullptr;      // [g*n]
  int32_t* anti_zone_node = nullptr;      // [g*n]
  int32_t* aff_node = nullptr;            // [g*n]
  const uint8_t* m_spread = nullptr;      // [g*g]: pod of b counts for a
  const uint8_t* m_anti_h = nullptr;      // [g*g]
  const uint8_t* m_anti_z = nullptr;      // [g*g]
  const uint8_t* m_aff = nullptr;         // [g*g]
  const uint8_t* con_path = nullptr;      // [g] group places via this tier
  std::vector<int64_t> cnt_zone, anti_zone, elig_zone;  // [g*nz]
  // one-per-node marks, mirroring the Python pass's moved_marks EXACTLY:
  // a destination a limit_g group placed on stays excluded for that group
  // for the rest of the pass (STICKY — python never clears marks, even
  // when the pod later cascades away); local marks vanish on candidate
  // revert, committed marks persist
  std::vector<uint8_t> marks_committed, marks_local;  // [g*n]
  std::vector<int64_t> aff_zone;          // [g*nz]
  std::vector<int64_t> aff_total;         // [g] matches anywhere alive
  std::vector<int> con_groups;            // groups with any constraint rows
  // host-kind spread (kind 1): every ELIGIBLE node is a domain; the global
  // minimum is maintained O(1) via a per-group count histogram over
  // eligible nodes (counts clamp at kHistMax; a min that large means the
  // skew check can never bind for realistic max_skew values)
  static constexpr int kHistMax = 1023;
  // packed: one (kHistMax+1)-bucket row PER HOST-SPREAD GROUP only (zero
  // allocation when no group has kind 1)
  std::vector<int64_t> hist;
  std::vector<int> hist_row;              // [g] packed row index or -1
  std::vector<int> hist_min;              // [g] current minimum count
  std::vector<int64_t> elig_alive;        // [g] eligible nodes still alive

  static int clampc(int64_t c) {
    return c < 0 ? 0 : (c > kHistMax ? kHistMax : (int)c);
  }

  void hist_move(int a, int from, int to) {
    int64_t* h = hist.data() + (size_t)hist_row[a] * (kHistMax + 1);
    h[clampc(from)] -= 1;
    h[clampc(to)] += 1;
    if (to < hist_min[a]) {
      hist_min[a] = clampc(to);
    } else if (from == hist_min[a] && h[clampc(from)] == 0) {
      int m = hist_min[a];
      while (m <= kHistMax && h[m] == 0) ++m;
      hist_min[a] = m > kHistMax ? 0 : m;  // no eligible nodes left -> min 0
    }
  }

  bool active() const { return zone_id != nullptr; }

  void init() {
    cnt_zone.assign((size_t)g * nz, 0);
    anti_zone.assign((size_t)g * nz, 0);
    elig_zone.assign((size_t)g * nz, 0);
    aff_zone.assign((size_t)g * nz, 0);
    aff_total.assign(g, 0);
    marks_committed.assign((size_t)g * n, 0);
    marks_local.assign((size_t)g * n, 0);
    hist_row.assign(g, -1);
    hist_min.assign(g, 0);
    elig_alive.assign(g, 0);
    int n_host = 0;
    for (int a = 0; a < g; ++a)
      if (spread_kind[a] == 1) hist_row[a] = n_host++;
    hist.assign((size_t)n_host * (kHistMax + 1), 0);
    for (int a = 0; a < g; ++a) {
      // marks work without con_groups membership: pure one-per-node
      // (port-only) groups stay OUT so apply()/remove_node() never iterate
      // their all-zero count-plane rows
      const bool any = spread_kind[a] != 0 || has_anti_host[a] ||
                       has_anti_zone[a] || aff_kind[a] != 0;
      if (any) con_groups.push_back(a);
      const bool host_spread = spread_kind[a] == 1;
      int64_t* h = host_spread
          ? hist.data() + (size_t)hist_row[a] * (kHistMax + 1) : nullptr;
      int mn = kHistMax + 1;
      for (int i = 0; i < n; ++i) {
        const bool el = elig[(size_t)a * n + i];
        if (host_spread && el) {
          const int c = clampc(cnt_node[(size_t)a * n + i]);
          h[c] += 1;
          elig_alive[a] += 1;
          if (c < mn) mn = c;
        }
        aff_total[a] += aff_node[(size_t)a * n + i];
        const int z = zone_id[i];
        if (z <= 0 || z >= nz) continue;
        if (el) {
          elig_zone[(size_t)a * nz + z] += 1;
          cnt_zone[(size_t)a * nz + z] += cnt_node[(size_t)a * n + i];
        }
        anti_zone[(size_t)a * nz + z] += anti_zone_node[(size_t)a * n + i];
        aff_zone[(size_t)a * nz + z] += aff_node[(size_t)a * n + i];
      }
      hist_min[a] = mn > kHistMax ? 0 : mn;
    }
  }

  // one pod of group b lands on (+1) / leaves (-1) node i, `count` at a time
  void apply(int b, int i, int sign, int count = 1) {
    const int z = zone_id[i];
    for (int a : con_groups) {
      const size_t an = (size_t)a * n + i;
      if (m_spread[(size_t)a * g + b]) {
        const int64_t before = cnt_node[an];
        cnt_node[an] += sign * count;
        if (z > 0 && z < nz && elig[an])
          cnt_zone[(size_t)a * nz + z] += sign * count;
        if (spread_kind[a] == 1 && elig[an])
          hist_move(a, (int)before, (int)cnt_node[an]);
      }
      if (m_anti_h[(size_t)a * g + b]) anti_host_node[an] += sign * count;
      if (m_anti_z[(size_t)a * g + b]) {
        anti_zone_node[an] += sign * count;
        if (z > 0 && z < nz) anti_zone[(size_t)a * nz + z] += sign * count;
      }
      if (m_aff[(size_t)a * g + b]) {
        aff_node[an] += sign * count;
        aff_total[a] += sign * count;
        if (z > 0 && z < nz) aff_zone[(size_t)a * nz + z] += sign * count;
      }
    }
  }

  // can one pod of group a land on node i right now?
  bool ok(int a, int i) const {
    const int z = zone_id[i];
    if (one_per_node[a]) {
      const size_t an = (size_t)a * n + i;
      if (marks_committed[an] || marks_local[an]) return false;
    }
    if (has_anti_host[a] && anti_host_node[(size_t)a * n + i] > 0)
      return false;
    if (has_anti_zone[a] && z > 0 && z < nz &&
        anti_zone[(size_t)a * nz + z] > 0)
      return false;
    if (aff_kind[a] != 0) {
      int64_t here = 0;
      if (aff_kind[a] == 1) {
        here = aff_node[(size_t)a * n + i];
      } else if (z > 0 && z < nz) {
        here = aff_zone[(size_t)a * nz + z];
      } else {
        return false;  // zone term, node without the key
      }
      if (here <= 0 && !(aff_total[a] == 0 && aff_self[a])) return false;
    }
    if (spread_kind[a] == 1) {
      // every eligible alive node is a domain; min over them is hist_min
      const int64_t minc = elig_alive[a] > 0 ? hist_min[a] : 0;
      const int64_t here =
          elig[(size_t)a * n + i] ? cnt_node[(size_t)a * n + i] : 0;
      if (here + (spread_self[a] ? 1 : 0) - minc > max_skew[a]) return false;
    }
    if (spread_kind[a] == 2) {
      if (z <= 0 || z >= nz) return false;  // no key -> cannot satisfy
      int64_t minc = INT64_MAX;
      bool any = false;
      for (int zz = 1; zz < nz; ++zz) {
        if (elig_zone[(size_t)a * nz + zz] > 0) {
          any = true;
          const int64_t cc = cnt_zone[(size_t)a * nz + zz];
          if (cc < minc) minc = cc;
        }
      }
      if (!any) minc = 0;
      const int64_t here =
          elig_zone[(size_t)a * nz + z] > 0 ? cnt_zone[(size_t)a * nz + z] : 0;
      if (here + (spread_self[a] ? 1 : 0) - minc > max_skew[a]) return false;
    }
    return true;
  }

  // candidate node removed from the world: residual (non-moved) pods vanish
  // with it and it stops being an eligible domain member (the Python pass's
  // oracle remove_node)
  void remove_node(int i) {
    const int z = zone_id[i];
    for (int a : con_groups) {
      const size_t an = (size_t)a * n + i;
      if (spread_kind[a] == 1 && elig[an]) {
        // the node stops being a domain: drop its histogram bucket and
        // recompute the min if it owned it
        int64_t* h = hist.data() + (size_t)hist_row[a] * (kHistMax + 1);
        const int c = clampc(cnt_node[an]);
        h[c] -= 1;
        elig_alive[a] -= 1;
        if (c == hist_min[a] && h[c] == 0) {
          int m = hist_min[a];
          while (m <= kHistMax && h[m] == 0) ++m;
          hist_min[a] = m > kHistMax ? 0 : m;
        }
      }
      aff_total[a] -= aff_node[an];
      if (z > 0 && z < nz) {
        if (elig[an]) {
          cnt_zone[(size_t)a * nz + z] -= cnt_node[an];
          elig_zone[(size_t)a * nz + z] -= 1;
        }
        anti_zone[(size_t)a * nz + z] -= anti_zone_node[an];
        aff_zone[(size_t)a * nz + z] -= aff_node[an];
      }
      cnt_node[an] = 0;
      anti_zone_node[an] = 0;
      anti_host_node[an] = 0;
      aff_node[an] = 0;
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of accepted candidates, or -1 on bad arguments.
// reason_out: 0 accepted, 1 no-place, 2 group-room, 3 quota, 4 budget-skip,
//             5 pdb-budget.
// The con_* block is the constrained tier; pass con_zone_id = null to
// disable it (plain capacity-first-fit semantics).
int ka_confirm_c(
    int n, int r, int g,
    int64_t* free_io,            // [n*r] free capacity, mutated in place
    const uint8_t* feas,         // [g*n] predicate plane (pre-capacity)
    const uint8_t* node_valid,   // [n] valid & ready & schedulable
    const int32_t* greq,         // [g*r] per-group request vectors
    int n_cand,
    const int32_t* cand_node,    // [n_cand]
    const int32_t* slot_ids,     // [total_slots] scheduled-pod slot ids
    const int32_t* slot_group,   // [total_slots] group per slot
    const int32_t* slot_off,     // [n_cand+1] per-candidate ranges
    const int32_t* cand_group_idx,  // [n_cand] index into group_room
    int n_room,
    int32_t* group_room,         // [n_room] remaining deletions per node group
    int64_t* quota_totals,       // [r] running cluster totals (or null)
    const int64_t* quota_min,    // [r] min limits (or null)
    const int64_t* node_cap,     // [n*r] per-node capacity (for quota deduct)
    int empty_budget, int drain_budget, int total_budget,
    int n_pdbs,                  // >= 0 (0 = no PDB gating)
    int pdb_words,               // words per slot = ceil(n_pdbs / 64)
    const uint64_t* slot_pdb,    // [(max_slot_id+1) * pdb_words] bitmask rows
    int64_t* pdb_remaining,      // [n_pdbs] budgets, deducted on accept
    // ---- constrained tier (all null/0 to disable) ----
    int n_zones,
    const int32_t* con_zone_id,
    const uint8_t* con_spread_kind,
    const int32_t* con_max_skew,
    const uint8_t* con_spread_self,
    const uint8_t* con_has_anti_host,
    const uint8_t* con_has_anti_zone,
    const uint8_t* con_aff_kind,
    const uint8_t* con_aff_self,
    const uint8_t* con_one_per_node,
    const uint8_t* con_oracle_moved,
    const uint8_t* con_elig,
    int32_t* con_cnt_node,
    int32_t* con_anti_host_node,
    int32_t* con_anti_zone_node,
    int32_t* con_aff_node,
    const uint8_t* con_m_spread,
    const uint8_t* con_m_anti_h,
    const uint8_t* con_m_anti_z,
    const uint8_t* con_m_aff,
    const uint8_t* con_path_flag,  // [g] group routes through the tier
    // ---- outputs ----
    uint8_t* accept_out,         // [n_cand]
    uint8_t* reason_out,         // [n_cand]
    int32_t* dest_out)           // slot id -> destination (indexed by slot id;
                                 // caller sizes it max_slot_id+1, fills -1)
{
  if (n <= 0 || r <= 0 || g <= 0 || n_cand < 0) return -1;
  if (n_pdbs < 0) return -1;
  if (n_pdbs > 0 && (slot_pdb == nullptr || pdb_remaining == nullptr ||
                     pdb_words != (n_pdbs + 63) / 64))
    return -1;
  ConState con;
  if (con_zone_id != nullptr) {
    if (n_zones <= 0 || con_spread_kind == nullptr ||
        con_max_skew == nullptr || con_spread_self == nullptr ||
        con_has_anti_host == nullptr || con_has_anti_zone == nullptr ||
        con_aff_kind == nullptr || con_aff_self == nullptr ||
        con_one_per_node == nullptr || con_oracle_moved == nullptr ||
        con_elig == nullptr || con_cnt_node == nullptr ||
        con_anti_host_node == nullptr || con_anti_zone_node == nullptr ||
        con_aff_node == nullptr || con_m_spread == nullptr ||
        con_m_anti_h == nullptr || con_m_anti_z == nullptr ||
        con_m_aff == nullptr || con_path_flag == nullptr)
      return -1;
    con.n = n;
    con.g = g;
    con.nz = n_zones;
    con.zone_id = con_zone_id;
    con.spread_kind = con_spread_kind;
    con.max_skew = con_max_skew;
    con.spread_self = con_spread_self;
    con.has_anti_host = con_has_anti_host;
    con.has_anti_zone = con_has_anti_zone;
    con.aff_kind = con_aff_kind;
    con.aff_self = con_aff_self;
    con.one_per_node = con_one_per_node;
    con.oracle_moved = con_oracle_moved;
    con.elig = con_elig;
    con.cnt_node = con_cnt_node;
    con.anti_host_node = con_anti_host_node;
    con.anti_zone_node = con_anti_zone_node;
    con.aff_node = con_aff_node;
    con.m_spread = con_m_spread;
    con.m_anti_h = con_m_anti_h;
    con.m_anti_z = con_m_anti_z;
    con.m_aff = con_m_aff;
    con.con_path = con_path_flag;
    con.init();
  }
  // KA_CONFIRM_TRACE=1: per-placement records on stderr, for diffing the
  // native pass against the Python pass when chasing plan-equality bugs
  static const bool trace = std::getenv("KA_CONFIRM_TRACE") != nullptr;
  std::vector<uint8_t> deleted(n, 0);
  // pods moved ONTO a node (re-placed again if that node later drains)
  std::vector<std::vector<Move>> received(n);
  // first-fit frontier hint per group: nodes before the hint are known full
  // for that group's request (capacity only shrinks; reverts rewind the hint)
  std::vector<int> hint(g, 0);
  // per-candidate scratch, hoisted out of the hot loop (no per-candidate
  // heap traffic)
  std::vector<int64_t> pdb_need(n_pdbs > 0 ? n_pdbs : 0);
  int accepted = 0;

  for (int c = 0; c < n_cand; ++c) {
    accept_out[c] = 0;
    reason_out[c] = 4;
    if (accepted >= total_budget) continue;
    const int cand = cand_node[c];
    if (cand < 0 || cand >= n) continue;

    const int gi_room = cand_group_idx[c];
    if (gi_room < 0 || gi_room >= n_room || group_room[gi_room] <= 0) {
      reason_out[c] = 2;
      continue;
    }
    if (quota_totals && quota_min) {
      bool quota_ok = true;
      for (int k = 0; k < r; ++k) {
        if (quota_totals[k] - node_cap[(int64_t)cand * r + k] < quota_min[k]) {
          quota_ok = false;
          break;
        }
      }
      if (!quota_ok) {
        reason_out[c] = 3;
        continue;
      }
    }

    // victim set: original slots + received pods
    std::vector<Move> victims;
    for (int s = slot_off[c]; s < slot_off[c + 1]; ++s)
      victims.push_back({slot_ids[s], -1, slot_group[s]});
    for (const Move& m : received[cand]) victims.push_back(m);
    const bool is_empty = victims.empty();
    if (is_empty) {
      if (empty_budget <= 0) continue;
    } else {
      if (drain_budget <= 0) continue;
    }

    // PDB gate over the ORIGINAL resident slots only (received pods were
    // accounted when their own node was confirmed — planner.py comment)
    if (n_pdbs > 0) {
      std::fill(pdb_need.begin(), pdb_need.end(), 0);
      for (int s = slot_off[c]; s < slot_off[c + 1]; ++s) {
        const uint64_t* row = slot_pdb + (int64_t)slot_ids[s] * pdb_words;
        for (int w = 0; w < pdb_words; ++w) {
          uint64_t mask = row[w];
          while (mask) {
            int p = (w << 6) + __builtin_ctzll(mask);
            mask &= mask - 1;
            ++pdb_need[p];
          }
        }
      }
      bool pdb_ok = true;
      for (int p = 0; p < n_pdbs; ++p) {
        if (pdb_need[p] > pdb_remaining[p]) {
          pdb_ok = false;
          break;
        }
      }
      if (!pdb_ok) {
        reason_out[c] = 5;
        continue;
      }
    }

    // place group-by-group (stable-sorted so equal groups are consecutive),
    // first-fit in node index order
    std::stable_sort(victims.begin(), victims.end(),
                     [](const Move& a, const Move& b) { return a.group < b.group; });
    std::vector<Move> placed;
    placed.reserve(victims.size());
    // constrained-tier pods whose contribution left `cand` but found no
    // destination yet (revert must re-add them)
    int out_unplaced_group = -1;
    bool ok = true;
    size_t v = 0;
    while (v < victims.size() && ok) {
      const int gg = victims[v].group;
      size_t v_end = v;
      while (v_end < victims.size() && victims[v_end].group == gg) ++v_end;
      int want = (int)(v_end - v);
      const int32_t* req = greq + (int64_t)gg * r;
      const uint8_t* fg = feas + (int64_t)gg * n;
      const bool con_gg = con.active() && con.con_path[gg];

      if (con_gg) {
        // per-pod path, mirroring the Python exact path: move the pod's
        // contribution off the candidate, then scan destinations re-checking
        // the constraint as counts shift (pure-limit groups skip the count
        // planes exactly as python skips their oracle moves)
        const bool track = con.oracle_moved[gg] != 0;
        for (int t = 0; t < want && ok; ++t) {
          if (track) con.apply(gg, cand, -1);
          int d_found = -1;
          for (int node = 0; node < n; ++node) {
            if (node == cand || deleted[node] || !node_valid[node] ||
                !fg[node])
              continue;
            int64_t* fr = free_io + (int64_t)node * r;
            bool fits = true;
            for (int k = 0; k < r; ++k) {
              if (req[k] > 0 && fr[k] < req[k]) {
                fits = false;
                break;
              }
            }
            if (!fits) continue;
            if (!con.ok(gg, node)) continue;
            d_found = node;
            break;
          }
          if (d_found < 0) {
            ok = false;
            out_unplaced_group = gg;
            break;
          }
          int64_t* fr = free_io + (int64_t)d_found * r;
          for (int k = 0; k < r; ++k) fr[k] -= req[k];
          if (track) con.apply(gg, d_found, +1);
          if (con.one_per_node[gg])
            con.marks_local[(size_t)gg * n + d_found] = 1;
          if (trace)
            fprintf(stderr, "[kaconfirm] cand=%d con slot=%d g=%d -> %d\n",
                    cand, victims[v + t].slot, gg, d_found);
          placed.push_back({victims[v + t].slot, d_found, gg});
        }
        v = v_end;
        continue;
      }

      int node = hint[gg];
      bool advancing_frontier = true;
      while (want > 0 && node < n) {
        if (node == cand) {
          // the candidate itself is only transiently excluded — never
          // advance the persistent frontier past it
          advancing_frontier = false;
          ++node;
          continue;
        }
        if (deleted[node] || !node_valid[node] || !fg[node]) {
          if (advancing_frontier && node == hint[gg]) ++hint[gg];
          ++node;
          continue;
        }
        int64_t* fr = free_io + (int64_t)node * r;
        int64_t fits = INT64_MAX;
        for (int k = 0; k < r; ++k) {
          if (req[k] > 0) {
            int64_t f = fr[k] / req[k];
            if (f < fits) fits = f;
          }
        }
        if (fits <= 0) {
          if (advancing_frontier && node == hint[gg]) ++hint[gg];
          ++node;
          continue;
        }
        advancing_frontier = false;
        int take = (int)(fits < want ? fits : want);
        for (int t = 0; t < take; ++t) {
          if (trace)
            fprintf(stderr, "[kaconfirm] cand=%d blk slot=%d g=%d -> %d\n",
                    cand, victims[v + (v_end - v - want) + t].slot, gg, node);
          placed.push_back({victims[v + (v_end - v - want) + t].slot, node, gg});
        }
        for (int k = 0; k < r; ++k) fr[k] -= (int64_t)req[k] * take;
        want -= take;
        ++node;
      }
      if (want > 0) ok = false;
      v = v_end;
    }

    if (!ok) {
      if (trace) fprintf(stderr, "[kaconfirm] cand=%d REVERT\n", cand);
      int min_reverted = n;
      for (const Move& m : placed) {
        const int32_t* req = greq + (int64_t)m.group * r;
        int64_t* fr = free_io + (int64_t)m.node * r;
        for (int k = 0; k < r; ++k) fr[k] += req[k];
        if (m.node < min_reverted) min_reverted = m.node;
        if (con.active() && con.con_path[m.group]) {
          if (con.oracle_moved[m.group]) {
            con.apply(m.group, m.node, -1);
            con.apply(m.group, cand, +1);
          }
          con.marks_local[(size_t)m.group * n + m.node] = 0;
        }
      }
      if (out_unplaced_group >= 0 && con.oracle_moved[out_unplaced_group])
        con.apply(out_unplaced_group, cand, +1);
      // Restoring capacity can re-open a node that ANOTHER group's frontier
      // already skipped as full while this candidate was being placed, so
      // every group's hint must rewind to the earliest reverted destination —
      // not just the placing group's. (Hints are pure optimization: rewinding
      // too far only costs a rescan of permanently-bad nodes.)
      if (min_reverted < n)
        for (int gg2 = 0; gg2 < g; ++gg2)
          if (min_reverted < hint[gg2]) hint[gg2] = min_reverted;
      reason_out[c] = 1;
      continue;
    }

    // accept
    accept_out[c] = 1;
    reason_out[c] = 0;
    ++accepted;
    if (n_pdbs > 0)
      for (int p = 0; p < n_pdbs; ++p) pdb_remaining[p] -= pdb_need[p];
    deleted[cand] = 1;
    if (con.active()) {
      for (const Move& m : placed) {
        const size_t mi = (size_t)m.group * n + m.node;
        if (con.marks_local[mi]) {
          con.marks_local[mi] = 0;
          con.marks_committed[mi] = 1;
        }
      }
      con.remove_node(cand);
    }
    group_room[gi_room] -= 1;
    if (is_empty) --empty_budget; else --drain_budget;
    if (quota_totals) {
      for (int k = 0; k < r; ++k)
        quota_totals[k] -= node_cap[(int64_t)cand * r + k];
    }
    received[cand].clear();
    for (const Move& m : placed) {
      dest_out[m.slot] = m.node;
      received[m.node].push_back(m);
    }
  }
  return accepted;
}

}  // extern "C"
