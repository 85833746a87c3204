// kacodec: native snapshot-delta codec for the TPU autoscaling sidecar.
//
// Role (SURVEY.md §7 "Components in C++"): the latency-critical host-side
// boundary — decoding versioned snapshot deltas from the control plane
// (the reference's DeltaSnapshotStore idea moved onto the wire,
// cluster-autoscaler/simulator/clustersnapshot/store/delta.go:33-54) and
// lowering the string world (labels/taints/selectors/ports) into the dense
// int32 hash tables the TPU kernels consume, directly into caller-provided
// (pinned) buffers. The Python encoder (models/encode.py) is the semantics
// oracle; this codec must produce bit-identical tables (tests/test_sidecar.py).
//
// Wire format "KAD1" (little-endian):
//   header:  'K''A''D''1'  u32 record_count
//   str:     u16 len, bytes (utf-8)
//   record:  u8 op
//     op=1 UPSERT_NODE: str name, u16 n_labels ×{str k, str v},
//          u8 n_taints ×{str key, str value, u8 effect(0=NoSchedule,1=NoExecute,2=other)},
//          i32 cap[R], u8 flags (bit0 ready, bit1 unschedulable), i32 group_id,
//          str zone
//     op=2 DELETE_NODE: str name
//     op=3 UPSERT_POD: str uid, str node_name (empty ⇒ pending), i32 req[R],
//          u16 n_sel ×{str k, str v},
//          u8 n_tol ×{str key, u8 tolop(0=Equal,1=Exists), str value,
//                     u8 effect(0=NoSchedule,1=NoExecute,2=all)},
//          u8 n_ports ×{u16 port, u8 proto(0=TCP,1=UDP)},
//          u8 flags (bit0 movable, bit1 blocks, bit2 anti_affinity_self),
//          str eqkey (equivalence-group key, '' ⇒ uid)
//     op=4 DELETE_POD: str uid
//
// Build: make -C kubernetes_autoscaler_tpu/sidecar  (→ libkacodec.so)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;
constexpr int R = 8;  // resource slots; must match models/resources.NUM_RESOURCES

uint64_t fnv1a64(const char* data, size_t n) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < n; i++) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

// fold32: must mirror utils/hashing.py (nonzero signed int32).
int32_t fold32(const std::string& s) {
  uint64_t h = fnv1a64(s.data(), s.size());
  uint32_t h32 = static_cast<uint32_t>(h ^ (h >> 32));
  if (h32 == 0) h32 = 1;
  return static_cast<int32_t>(h32);
}

const char kKeyMark = '\x01';
const char* kNoSchedule = "NoSchedule";
const char* kNoExecute = "NoExecute";

struct Dims {
  int max_labels, max_taints, max_tolerations, max_sel_terms, max_sel_alts,
      max_neg_terms, max_pod_ports, max_node_ports;
};

struct NodeRow {
  std::string name;
  int32_t cap[R] = {0};
  std::vector<int32_t> label_hash;
  std::vector<int32_t> taint_exact, taint_key;
  std::vector<int32_t> used_ports;  // rebuilt from resident pods on export
  int32_t zone_id = 0, group_id = -1;
  bool ready = true, schedulable = true, valid = true;
};

struct GroupRow {
  std::string eqkey;
  int32_t req[R] = {0};
  std::vector<int32_t> sel_req;  // [S*A]
  std::vector<int32_t> sel_neg;
  std::vector<int32_t> tol_exact, tol_key;
  bool tolerate_all = false;
  std::vector<int32_t> port_hash;
  bool anti_self = false;
  bool lossy = false;
};

struct PodRow {
  std::string uid;
  int32_t req[R] = {0};
  int32_t node_idx = -1;  // -1 = pending
  int32_t group_ref = 0;
  std::vector<int32_t> port_hash;
  bool movable = false, blocks = false, valid = true;
};

// Export-section dirtiness bits: which of the three export surfaces
// (ka_export_nodes / ka_export_groups / ka_export_pods) a delta op can
// change. Node ops touch the node tensors only; a PENDING pod touches the
// group tensors only (its row spec + the pending count); a RESIDENT pod
// touches the scheduled-pod tensors AND the node tensors (alloc/used_ports
// are derived from resident pods at export time).
constexpr unsigned kSecNodes = 1u << 0;
constexpr unsigned kSecGroups = 1u << 1;
constexpr unsigned kSecPods = 1u << 2;

struct State {
  Dims dims;
  std::vector<NodeRow> nodes;
  std::vector<PodRow> pods;
  std::vector<GroupRow> groups;
  std::unordered_map<std::string, int> node_index;   // name -> row
  std::unordered_map<std::string, int> pod_index;    // uid -> row
  std::unordered_map<std::string, int> group_index;  // eqkey -> row
  std::unordered_map<std::string, int32_t> zone_ids;
  std::vector<int> free_node_rows, free_pod_rows;
  uint64_t version = 0;
  // per-export-section versions (0 = nodes, 1 = groups, 2 = pods): bumped
  // once per apply_delta for each section the delta's ops could change —
  // the python sidecar keys its plane-granular export/device caches on
  // these so a single-pod delta never re-materializes untouched planes
  // (ISSUE 11 satellite; ka_section_version).
  uint64_t section_versions[3] = {0, 0, 0};
  std::string error;
};

class Reader {
 public:
  Reader(const uint8_t* buf, size_t len) : p_(buf), end_(buf + len) {}
  bool ok() const { return ok_; }
  uint8_t u8() { return static_cast<uint8_t>(byte()); }
  uint16_t u16() {
    uint16_t lo = u8(), hi = u8();
    return static_cast<uint16_t>(lo | (hi << 8));
  }
  uint32_t u32() {
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v |= static_cast<uint32_t>(u8()) << (8 * i);
    return v;
  }
  int32_t i32() { return static_cast<int32_t>(u32()); }
  std::string str() {
    uint16_t n = u16();
    if (p_ + n > end_) {
      ok_ = false;
      return std::string();
    }
    std::string s(reinterpret_cast<const char*>(p_), n);
    p_ += n;
    return s;
  }

 private:
  uint8_t byte() {
    if (p_ >= end_) {
      ok_ = false;
      return 0;
    }
    return *p_++;
  }
  const uint8_t* p_;
  const uint8_t* end_;
  bool ok_ = true;
};

const char* effect_name(uint8_t e) {
  return e == 0 ? kNoSchedule : (e == 1 ? kNoExecute : "");
}

void fill(std::vector<int32_t>& dst, size_t cap, const std::vector<int32_t>& src,
          bool* overflow) {
  dst.assign(cap, 0);
  if (src.size() > cap && overflow) *overflow = true;
  size_t n = src.size() < cap ? src.size() : cap;
  for (size_t i = 0; i < n; i++) dst[i] = src[i];
}

int32_t zone_id_for(State* st, const std::string& zone) {
  if (zone.empty()) return 0;
  auto it = st->zone_ids.find(zone);
  if (it != st->zone_ids.end()) return it->second;
  int32_t id = static_cast<int32_t>(st->zone_ids.size()) + 1;
  st->zone_ids.emplace(zone, id);
  return id;
}

bool parse_node(State* st, Reader* r) {
  NodeRow row;
  row.name = r->str();
  std::vector<int32_t> labels;
  uint16_t nl = r->u16();
  for (int i = 0; i < nl; i++) {
    std::string k = r->str(), v = r->str();
    labels.push_back(fold32(k + "=" + v));
    labels.push_back(fold32(k + kKeyMark));
  }
  std::vector<int32_t> tx, tk;
  bool blocked = false;
  uint8_t nt = r->u8();
  for (int i = 0; i < nt; i++) {
    std::string key = r->str(), value = r->str();
    uint8_t eff = r->u8();
    if (eff > 1) continue;  // PreferNoSchedule etc: score-only
    if (key == "ToBeDeletedByClusterAutoscaler") blocked = true;
    std::string e = effect_name(eff);
    tx.push_back(fold32(key + '\0' + value + '\0' + e));
    tk.push_back(fold32(key + '\0' + e));
  }
  for (int i = 0; i < R; i++) row.cap[i] = r->i32();
  uint8_t flags = r->u8();
  row.group_id = r->i32();
  std::string zone = r->str();
  if (!r->ok()) return false;

  bool overflow = false;
  fill(row.label_hash, st->dims.max_labels, labels, &overflow);
  fill(row.taint_exact, st->dims.max_taints, tx, &overflow);
  fill(row.taint_key, st->dims.max_taints, tk, &overflow);
  if (overflow) {
    st->error = "node table overflow: " + row.name;
    return false;  // mirror encode.py fail-fast semantics
  }
  row.used_ports.assign(st->dims.max_node_ports, 0);
  row.zone_id = zone_id_for(st, zone);
  row.ready = flags & 1;
  row.schedulable = !(flags & 2) && !blocked;

  auto it = st->node_index.find(row.name);
  if (it != st->node_index.end()) {
    st->nodes[it->second] = row;
  } else if (!st->free_node_rows.empty()) {
    int slot = st->free_node_rows.back();
    st->free_node_rows.pop_back();
    st->nodes[slot] = row;
    st->node_index[row.name] = slot;
  } else {
    st->node_index[row.name] = static_cast<int>(st->nodes.size());
    st->nodes.push_back(std::move(row));
  }
  return true;
}

bool parse_pod(State* st, Reader* r, unsigned* mask) {
  PodRow pod;
  GroupRow g;
  pod.uid = r->str();
  std::string node_name = r->str();
  for (int i = 0; i < R; i++) {
    pod.req[i] = r->i32();
    g.req[i] = pod.req[i];
  }
  std::vector<int32_t> sel_flat;
  uint16_t ns = r->u16();
  for (int i = 0; i < ns; i++) {
    std::string k = r->str(), v = r->str();
    sel_flat.push_back(fold32(k + "=" + v));
  }
  std::vector<int32_t> tex, tky;
  uint8_t ntl = r->u8();
  for (int i = 0; i < ntl; i++) {
    std::string key = r->str();
    uint8_t op = r->u8();
    std::string value = r->str();
    uint8_t eff = r->u8();
    std::vector<uint8_t> effects;
    if (eff == 2) {
      effects = {0, 1};
    } else {
      effects = {eff};
    }
    if (op == 1) {  // Exists
      if (key.empty()) {
        g.tolerate_all = true;
        continue;
      }
      for (uint8_t e : effects) tky.push_back(fold32(key + '\0' + effect_name(e)));
    } else {
      for (uint8_t e : effects)
        tex.push_back(fold32(key + '\0' + value + '\0' + effect_name(e)));
    }
  }
  std::vector<int32_t> ports;
  uint8_t np = r->u8();
  for (int i = 0; i < np; i++) {
    uint16_t port = r->u16();
    uint8_t proto = r->u8();
    ports.push_back(
        fold32(std::to_string(port) + "/" + (proto == 1 ? "UDP" : "TCP")));
  }
  uint8_t flags = r->u8();
  std::string eqkey = r->str();
  if (!r->ok()) return false;
  if (eqkey.empty()) eqkey = pod.uid;

  pod.movable = flags & 1;
  pod.blocks = flags & 2;
  g.anti_self = flags & 4;

  // group row (selector terms: single-alt per nodeSelector pair; richer
  // affinity shapes arrive pre-flagged via the lossy bit on the wire — the
  // control plane computes them, mirroring _encode_pod_spec)
  const Dims& d = st->dims;
  g.sel_req.assign(d.max_sel_terms * d.max_sel_alts, 0);
  bool lossy = flags & 8;
  if (static_cast<int>(sel_flat.size()) > d.max_sel_terms) lossy = true;
  for (size_t i = 0;
       i < sel_flat.size() && i < static_cast<size_t>(d.max_sel_terms); i++) {
    g.sel_req[i * d.max_sel_alts] = sel_flat[i];
  }
  g.sel_neg.assign(d.max_neg_terms, 0);
  bool overflow = false;
  fill(g.tol_exact, d.max_tolerations, tex, &overflow);
  fill(g.tol_key, d.max_tolerations, tky, &overflow);
  fill(g.port_hash, d.max_pod_ports, ports, &overflow);
  if (overflow) lossy = true;
  g.lossy = lossy;
  g.eqkey = eqkey;
  pod.port_hash = g.port_hash;

  auto git = st->group_index.find(eqkey);
  if (git == st->group_index.end()) {
    *mask |= kSecGroups;  // fresh equivalence row enters the group export
    st->group_index[eqkey] = static_cast<int>(st->groups.size());
    st->groups.push_back(std::move(g));
    git = st->group_index.find(eqkey);
  }
  pod.group_ref = git->second;

  if (!node_name.empty()) {
    auto nit = st->node_index.find(node_name);
    if (nit == st->node_index.end()) {
      st->error = "pod " + pod.uid + ": unknown node " + node_name;
      return false;
    }
    pod.node_idx = nit->second;
  }
  // new residency decides the sections this op changes; a replaced pod's
  // OLD residency changes them too (a bind moves a pod from the pending
  // count into alloc/scheduled rows: groups AND pods+nodes are dirty)
  *mask |= pod.node_idx >= 0 ? (kSecPods | kSecNodes) : kSecGroups;

  auto pit = st->pod_index.find(pod.uid);
  if (pit != st->pod_index.end()) {
    const PodRow& old = st->pods[pit->second];
    *mask |= old.node_idx >= 0 ? (kSecPods | kSecNodes) : kSecGroups;
    st->pods[pit->second] = pod;
  } else if (!st->free_pod_rows.empty()) {
    int slot = st->free_pod_rows.back();
    st->free_pod_rows.pop_back();
    st->pods[slot] = pod;
    st->pod_index[pod.uid] = slot;
  } else {
    st->pod_index[pod.uid] = static_cast<int>(st->pods.size());
    st->pods.push_back(std::move(pod));
  }
  return true;
}

}  // namespace

extern "C" {

void* ka_state_new(int max_labels, int max_taints, int max_tolerations,
                   int max_sel_terms, int max_sel_alts, int max_neg_terms,
                   int max_pod_ports, int max_node_ports) {
  State* st = new State();
  st->dims = Dims{max_labels, max_taints,   max_tolerations, max_sel_terms,
                  max_sel_alts, max_neg_terms, max_pod_ports,   max_node_ports};
  return st;
}

void ka_state_free(void* handle) { delete static_cast<State*>(handle); }

const char* ka_last_error(void* handle) {
  return static_cast<State*>(handle)->error.c_str();
}

// Returns 0 on success; <0 on malformed input (state unchanged semantics are
// NOT transactional — callers should rebuild on error, like the reference
// falls back to a full SetClusterState).
int ka_apply_delta(void* handle, const uint8_t* buf, uint64_t len) {
  State* st = static_cast<State*>(handle);
  st->error.clear();
  Reader r(buf, len);
  if (len < 8 || r.u8() != 'K' || r.u8() != 'A' || r.u8() != 'D' ||
      r.u8() != '1') {
    st->error = "bad magic";
    return -1;
  }
  uint32_t count = r.u32();
  unsigned mask = 0;
  for (uint32_t i = 0; i < count; i++) {
    uint8_t op = r.u8();
    if (!r.ok()) {
      st->error = "truncated";
      return -2;
    }
    switch (op) {
      case 1:
        if (!parse_node(st, &r)) return -3;
        mask |= kSecNodes;
        break;
      case 2: {
        std::string name = r.str();
        auto it = st->node_index.find(name);
        if (it != st->node_index.end()) {
          st->nodes[it->second].valid = false;
          st->free_node_rows.push_back(it->second);
          st->node_index.erase(it);
          mask |= kSecNodes;
        }
        break;
      }
      case 3:
        if (!parse_pod(st, &r, &mask)) return -4;
        break;
      case 4: {
        std::string uid = r.str();
        auto it = st->pod_index.find(uid);
        if (it != st->pod_index.end()) {
          // a removed RESIDENT pod uncharges alloc/ports and drops a
          // scheduled row; a removed PENDING pod drops a group count
          mask |= st->pods[it->second].node_idx >= 0
                      ? (kSecPods | kSecNodes)
                      : kSecGroups;
          st->pods[it->second].valid = false;
          st->free_pod_rows.push_back(it->second);
          st->pod_index.erase(it);
        }
        break;
      }
      default:
        st->error = "unknown op";
        return -5;
    }
  }
  st->version++;
  if (mask & kSecNodes) st->section_versions[0]++;
  if (mask & kSecGroups) st->section_versions[1]++;
  if (mask & kSecPods) st->section_versions[2]++;
  return 0;
}

uint64_t ka_version(void* handle) { return static_cast<State*>(handle)->version; }

// Per-export-section version (0 = nodes, 1 = groups, 2 = pods) — the
// python sidecar's plane-granular export/device caches key on these
// (ISSUE 11: a single-pod delta must not re-materialize untouched planes).
uint64_t ka_section_version(void* handle, int section) {
  State* st = static_cast<State*>(handle);
  if (section < 0 || section > 2) return 0;
  return st->section_versions[section];
}

// Group row -> its equivalence key (for the python-side constraint
// side-channel to map aux pod records onto exported rows). Returns the key
// length, or -1 when out of range; truncates to cap.
int ka_group_key(void* handle, int row, char* buf, int cap) {
  State* st = static_cast<State*>(handle);
  if (row < 0 || row >= static_cast<int>(st->groups.size())) return -1;
  const std::string& k = st->groups[row].eqkey;
  int n = static_cast<int>(k.size());
  int c = n < cap ? n : cap;
  std::memcpy(buf, k.data(), c);
  return n;
}

// Node name -> row index (-1 when absent).
int ka_node_row(void* handle, const char* name) {
  State* st = static_cast<State*>(handle);
  auto it = st->node_index.find(name);
  return it == st->node_index.end() ? -1 : it->second;
}

// Zone string -> the codec's interned id (-1 when the zone is unknown; 0 is
// the reserved "no zone" id). Lets the python side encode TEMPLATES in the
// same zone-id space as the exported node tensors.
int ka_zone_id(void* handle, const char* zone) {
  State* st = static_cast<State*>(handle);
  if (zone == nullptr || *zone == '\0') return 0;
  auto it = st->zone_ids.find(zone);
  return it == st->zone_ids.end() ? -1 : it->second;
}

int ka_num_zones(void* handle) {
  return static_cast<int>(static_cast<State*>(handle)->zone_ids.size());
}
int ka_num_nodes(void* handle) {
  return static_cast<int>(static_cast<State*>(handle)->nodes.size());
}
int ka_num_pods(void* handle) {
  return static_cast<int>(static_cast<State*>(handle)->pods.size());
}
int ka_num_groups(void* handle) {
  return static_cast<int>(static_cast<State*>(handle)->groups.size());
}

// Export node tensors into caller buffers (padded to n_pad rows, zeroed by
// caller). alloc and used_ports are derived from resident pods here — the
// aggregation loop the Python encoder runs per SetClusterState.
int ka_export_nodes(void* handle, int n_pad, int32_t* cap, int32_t* alloc,
                    int32_t* label_hash, int32_t* taint_exact,
                    int32_t* taint_key, int32_t* used_ports, int32_t* zone_id,
                    int32_t* group_id, uint8_t* ready, uint8_t* schedulable,
                    uint8_t* valid) {
  State* st = static_cast<State*>(handle);
  const Dims& d = st->dims;
  int n = static_cast<int>(st->nodes.size());
  if (n > n_pad) return -1;
  std::vector<int> port_fill(n, 0);
  for (int i = 0; i < n; i++) {
    const NodeRow& row = st->nodes[i];
    if (!row.valid) continue;
    std::memcpy(cap + i * R, row.cap, sizeof(row.cap));
    std::memcpy(label_hash + i * d.max_labels, row.label_hash.data(),
                d.max_labels * 4);
    std::memcpy(taint_exact + i * d.max_taints, row.taint_exact.data(),
                d.max_taints * 4);
    std::memcpy(taint_key + i * d.max_taints, row.taint_key.data(),
                d.max_taints * 4);
    zone_id[i] = row.zone_id;
    group_id[i] = row.group_id;
    ready[i] = row.ready;
    schedulable[i] = row.schedulable;
    valid[i] = 1;
  }
  for (const PodRow& pod : st->pods) {
    if (!pod.valid || pod.node_idx < 0) continue;
    for (int rix = 0; rix < R; rix++)
      alloc[pod.node_idx * R + rix] += pod.req[rix];
    for (int32_t ph : pod.port_hash) {
      if (ph == 0) continue;
      if (port_fill[pod.node_idx] >= d.max_node_ports) return -2;  // fail fast
      used_ports[pod.node_idx * d.max_node_ports + port_fill[pod.node_idx]++] =
          ph;
    }
  }
  return n;
}

int ka_export_groups(void* handle, int g_pad, int32_t* req, int32_t* count,
                     int32_t* sel_req, int32_t* sel_neg, int32_t* tol_exact,
                     int32_t* tol_key, uint8_t* tolerate_all, int32_t* port_hash,
                     uint8_t* anti_self, uint8_t* valid, uint8_t* lossy) {
  State* st = static_cast<State*>(handle);
  const Dims& d = st->dims;
  int g = static_cast<int>(st->groups.size());
  if (g > g_pad) return -1;
  for (int i = 0; i < g; i++) {
    const GroupRow& row = st->groups[i];
    std::memcpy(req + i * R, row.req, sizeof(row.req));
    std::memcpy(sel_req + i * d.max_sel_terms * d.max_sel_alts,
                row.sel_req.data(), d.max_sel_terms * d.max_sel_alts * 4);
    std::memcpy(sel_neg + i * d.max_neg_terms, row.sel_neg.data(),
                d.max_neg_terms * 4);
    std::memcpy(tol_exact + i * d.max_tolerations, row.tol_exact.data(),
                d.max_tolerations * 4);
    std::memcpy(tol_key + i * d.max_tolerations, row.tol_key.data(),
                d.max_tolerations * 4);
    tolerate_all[i] = row.tolerate_all;
    std::memcpy(port_hash + i * d.max_pod_ports, row.port_hash.data(),
                d.max_pod_ports * 4);
    anti_self[i] = row.anti_self;
    valid[i] = 1;
    lossy[i] = row.lossy;
  }
  // pending counts
  for (const PodRow& pod : st->pods) {
    if (pod.valid && pod.node_idx < 0) count[pod.group_ref]++;
  }
  return g;
}

int ka_export_pods(void* handle, int p_pad, int32_t* req, int32_t* node_idx,
                   int32_t* group_ref, uint8_t* movable, uint8_t* blocks,
                   uint8_t* valid) {
  State* st = static_cast<State*>(handle);
  int scheduled = 0;
  for (const PodRow& pod : st->pods) {
    if (!pod.valid || pod.node_idx < 0) continue;
    if (scheduled >= p_pad) return -1;
    std::memcpy(req + scheduled * R, pod.req, sizeof(pod.req));
    node_idx[scheduled] = pod.node_idx;
    group_ref[scheduled] = pod.group_ref;
    movable[scheduled] = pod.movable;
    blocks[scheduled] = pod.blocks;
    valid[scheduled] = 1;
    scheduled++;
  }
  return scheduled;
}

// Batch hashing for the Python encoder's hot path: n strings packed in `data`
// with offsets[n+1]; writes fold32 hashes to out.
void ka_fold32_batch(const char* data, const int64_t* offsets, int n,
                     int32_t* out) {
  for (int i = 0; i < n; i++) {
    uint64_t h = fnv1a64(data + offsets[i],
                         static_cast<size_t>(offsets[i + 1] - offsets[i]));
    uint32_t h32 = static_cast<uint32_t>(h ^ (h >> 32));
    if (h32 == 0) h32 = 1;
    out[i] = static_cast<int32_t>(h32);
  }
}

void ka_fnv64_batch(const char* data, const int64_t* offsets, int n,
                    int64_t* out) {
  for (int i = 0; i < n; i++) {
    out[i] = static_cast<int64_t>(fnv1a64(
        data + offsets[i], static_cast<size_t>(offsets[i + 1] - offsets[i])));
  }
}

}  // extern "C"
