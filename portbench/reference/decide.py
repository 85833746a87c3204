"""The benchmark's plain reference: one fused autoscaling decision worked out
again from the plain world description.

It is written from the semantics of the decision as the JAX package states
them, read as a specification and never imported: the resource vector and
the equivalence groups (models/encode.py, models/resources.py), the node
selector, taints and node gates (ops/predicates.py), the first-fit
decreasing filter onto the existing nodes (ops/schedule.py, ops/pack.py),
each node group's option packed into empty template bins (ops/binpack.py),
the expander's inputs (ops/scoring.py), utilization (ops/utilization.py)
and the drain sweep over every node (simulator/drainability/rules.py,
ops/drain.py). Its input is the configuration, the traffic and a variant's
plain numbers (world.variants), the same that the program's objects are
built from; it takes nothing that the program made and imports neither the
program nor JAX.

NumPy on the host. Counts and capacities are int64; the float leaves
(utilization, waste, price, the helped requests) and the first-fit
decreasing size score are worked out in `float_dtype`: float64 for the
reference, then rounded to the float32 that a decision carries; the control
passes bfloat16 (through torch, which has it).

Its drain sweep is formulated per candidate and per node: a group's fit on
every node is worked out once, and each first fit walks the nodes with
room in order, working out again only those that the candidate's earlier
groups took from.

It covers the worlds in portbench/configs whose pending pods carry no
topology constraint (spread, pod affinity, pod anti-affinity); `decide`
raises NotImplementedError on one that does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench import bounds

R = 8                                  # cpu, memory, ephemeral, pods, 4 extended
CPU, MEM, EPH, PODS, GPU = 0, 1, 2, 3, 4
SLOTS = 16                             # shapes a drained node may hold
HOST_KEY, ZONE_KEY = "kubernetes.io/hostname", "topology.kubernetes.io/zone"
TAINT = ("dedicated", "infra", "NoSchedule")
TOLERATION = ("dedicated", "Equal", "infra", "NoSchedule")
FILTERING_EFFECTS = ("NoSchedule", "NoExecute")
REPLICATED_KINDS = ("ReplicaSet", "ReplicationController", "Job", "StatefulSet")
SYSTEM_NAMESPACE = "kube-system"
NODE_BUCKET_TEMPLATES = 8
BIG = 1 << 40


def _pad(n: int, bucket: int) -> int:
    return bucket if n <= 0 else -(-n // bucket) * bucket


@dataclass
class Group:
    """One equivalence group: the pods of one owner with one spec."""

    owner: str
    req: np.ndarray                 # int64[R]
    count: int                      # pending pods
    selector: dict
    tolerations: tuple


@dataclass
class World:
    """One variant, as the decision sees it (rows padded as the encoder
    pads them: nodes to the configuration's bucket, groups to its bucket,
    node groups to 8, resident pods to 256)."""

    n_nodes: int
    cap: np.ndarray                 # int64[N, R]
    alloc: np.ndarray               # int64[N, R] the residents' requests
    node_ok: np.ndarray             # bool[N] valid, ready and schedulable
    labels: dict                    # key -> str[n_nodes]
    tainted: np.ndarray             # bool[n_nodes] carries TAINT
    groups: list                    # [Group] in row order
    g_pad: int
    res_node: np.ndarray            # int64[P] node of each resident pod
    res_group: np.ndarray           # int64[P] its group's row
    movable: np.ndarray             # bool[P]
    blocks: np.ndarray              # bool[P]
    p_pad: int
    t_cap: np.ndarray               # int64[NG, R]
    t_labels: list                  # [dict] a template's labels
    t_valid: np.ndarray             # bool[NG]
    t_open: np.ndarray              # int64[NG] bins open (max_new, capped)
    t_price: np.ndarray             # float64[NG]


def _selector_ok(labels: dict, selector: dict, n: int) -> np.ndarray:
    ok = np.ones(n, dtype=bool)
    for k, v in selector.items():
        ok &= labels[k] == v if k in labels else False
    return ok


def _tolerates(tolerations: tuple, taint: tuple) -> bool:
    key, value, effect = taint
    for tk, op, tv, te in tolerations:
        if te and te != effect:
            continue
        if op == "Exists" and (not tk or tk == key):
            return True
        if op == "Equal" and tk == key and tv == value:
            return True
    return False


def _moved(owner_kind: str, namespace: str, local_storage: int = 0) -> bool:
    """The drainability rules for a running pod with a controlling owner,
    no annotation and no deletion: moved when its controller is a
    replicated kind, it is outside the system namespace and it keeps no
    local storage; otherwise it blocks its node's removal."""
    return (owner_kind in REPLICATED_KINDS and namespace != SYSTEM_NAMESPACE
            and local_storage == 0)


def world_of(cfg: dict, traffic: dict, variant) -> World:
    """The variant's world from the configuration's rules and the variant's
    numbers: which pending pods each owner group holds, the burst, which
    residents run."""
    n = cfg["nodes"]
    idx = np.arange(n)
    zones = np.asarray(cfg["zones"])
    labels = {
        HOST_KEY: np.char.add("node-", idx.astype(str)),
        ZONE_KEY: zones[idx % len(zones)],
        "pool": np.where(idx % 2 == 1, "a", "b"),
        "disk": np.where(idx % 3 != 0, "ssd", "hdd"),
    }
    n_pad = _pad(n, cfg["node_bucket"])
    cap = np.zeros((n_pad, R), dtype=np.int64)
    cap[:n, CPU] = cfg["node_cpu_milli"]
    cap[:n, MEM] = cfg["node_mem_mib"]
    cap[:n, PODS] = cfg["node_pods"]
    cap[:n, GPU] = np.where(idx % cfg["gpu_node_every"] == 0,
                            cfg["gpus_per_node"], 0)
    node_ok = np.zeros(n_pad, dtype=bool)
    node_ok[:n] = True

    # residents: resident k runs on node k // residents_per_node and
    # belongs to owner k % resident_owners (a ReplicaSet of plain pods)
    present = np.flatnonzero(variant.residents)
    res_node = present // cfg["residents_per_node"]
    res_owner = present % cfg["resident_owners"]
    res_req = np.zeros(R, dtype=np.int64)
    res_req[[CPU, MEM, PODS]] = (cfg["resident_cpu_milli"],
                                 cfg["resident_mem_mib"], 1)
    alloc = np.zeros((n_pad, R), dtype=np.int64)
    alloc += np.bincount(res_node, minlength=n_pad)[:, None] * res_req

    # groups: the residents' owners by first appearance, then the pending
    # owner groups in order, then the burst (the encoder's row order)
    groups = []
    first = np.unique(res_owner, return_index=True)[1]
    owner_rows = {}
    for o in res_owner[np.sort(first)].tolist():
        owner_rows[o] = len(groups)
        groups.append(Group(f"rs{o}", res_req.copy(), 0, {}, ()))
    rules = cfg["constraints"]
    for g, count in enumerate(variant.counts):
        if count <= 0:
            continue
        if rules.get(str(g % cfg["constraint_every"])) is not None:
            raise NotImplementedError(
                f"pending group {g} carries a topology constraint")
        cpu, mem = cfg["group_sizes"][g]
        req = np.zeros(R, dtype=np.int64)
        req[[CPU, MEM, PODS]] = (cpu, mem, 1)
        req[GPU] = 1 if g % cfg["gpu_group_every"] == 0 else 0
        groups.append(Group(
            f"rs-{g}", req, int(count),
            {"disk": "ssd"} if g % cfg["ssd_every"] == 0 else {},
            (TOLERATION,) if g % cfg["tolerate_every"] == 0 else ()))
    if variant.burst:
        b = traffic["burst"]
        req = np.zeros(R, dtype=np.int64)
        req[[CPU, MEM, PODS]] = (b["cpu_milli"], b["mem_mib"], 1)
        groups.append(Group("burst-rs", req, int(variant.burst), {}, ()))

    movable = np.full(present.size, _moved(owner_kind="ReplicaSet",
                                           namespace="default"))
    blocks = ~movable

    ng = cfg["node_groups"]
    ng_pad = _pad(ng, NODE_BUCKET_TEMPLATES)
    k = len(cfg["template_cpu_milli"])
    t_cap = np.zeros((ng_pad, R), dtype=np.int64)
    t_labels = []
    for t in range(ng):
        t_cap[t, [CPU, MEM, PODS]] = (cfg["template_cpu_milli"][t % k],
                                      cfg["template_mem_mib"][t % k],
                                      cfg["node_pods"])
        t_cap[t, GPU] = (cfg["gpus_per_node"]
                         if t % cfg["template_gpu_every"] == 0 else 0)
        t_labels.append({HOST_KEY: f"template-{t}",
                         ZONE_KEY: str(zones[t % len(zones)]),
                         "pool": "a" if t % 2 else "b",
                         "disk": "ssd" if t % 3 else "hdd"})
    t_valid = np.arange(ng_pad) < ng
    t_open = np.where(t_valid, min(cfg["template_max_new"],
                                   cfg["max_new_nodes"]), 0)
    t_price = np.where(t_valid, 1.0 + np.arange(ng_pad), 0.0)
    return World(
        n_nodes=n, cap=cap, alloc=alloc, node_ok=node_ok, labels=labels,
        tainted=idx % cfg["taint_every"] == 0, groups=groups,
        g_pad=_pad(len(groups), cfg["group_bucket"]),
        res_node=res_node, res_group=np.array(
            [owner_rows[o] for o in res_owner.tolist()], dtype=np.int64),
        movable=movable, blocks=blocks, p_pad=_pad(present.size, 256),
        t_cap=t_cap, t_labels=t_labels, t_valid=t_valid, t_open=t_open,
        t_price=t_price)


def feasibility(w: World) -> tuple[np.ndarray, np.ndarray]:
    """(bool[G, N] on the nodes, bool[G, NG] on the templates): node
    selector, every filtering taint tolerated, node and group valid. No
    group here is anti-affine to itself, so no resident takes a node away;
    resources are the packs' to check."""
    n_pad, ng_pad = w.cap.shape[0], w.t_cap.shape[0]
    feas = np.zeros((w.g_pad, n_pad), dtype=bool)
    t_feas = np.zeros((w.g_pad, ng_pad), dtype=bool)
    for r, g in enumerate(w.groups):
        ok = _selector_ok(w.labels, g.selector, w.n_nodes)
        if TAINT[2] in FILTERING_EFFECTS and not _tolerates(g.tolerations,
                                                            TAINT):
            ok &= ~w.tainted
        feas[r, :w.n_nodes] = ok & w.node_ok[:w.n_nodes]
        for t, lab in enumerate(w.t_labels):
            t_feas[r, t] = all(lab.get(k2) == v for k2, v in g.selector.items())
    return feas, t_feas


def fits(free: np.ndarray, req: np.ndarray) -> np.ndarray:
    """int64[...]: pods of request `req` that fit in each `free` row
    (negative free holds none; a resource not asked for bounds nothing)."""
    asked = req > 0
    if not asked.any():
        return np.full(free.shape[:-1], BIG, dtype=np.int64)
    return (np.maximum(free[..., asked], 0) // req[asked]).min(axis=-1)


def first_fit(fit: np.ndarray, want: int) -> np.ndarray:
    """Pods placed on each node (last axis) by a first fit of `want` pods
    in node order, `fit` of them fitting each node."""
    fit = np.minimum(fit, want)
    before = np.cumsum(fit, axis=-1) - fit
    return np.clip(want - before, 0, fit)


def ffd_order(w: World, counts: np.ndarray, dt) -> list[int]:
    """The groups with pods, largest first by cpu + memory / 1024 (in `dt`),
    equal sizes in row order."""
    req = np.stack([g.req for g in w.groups])
    cpu = torch.tensor(req[:, CPU], dtype=torch.float64).to(dt)
    mem = torch.tensor(req[:, MEM], dtype=torch.float64).to(dt)
    score = (cpu + mem / 1024).to(torch.float64).numpy()
    live = [r for r in range(len(w.groups)) if counts[r] > 0]
    return sorted(live, key=lambda r: (-score[r], r))


def _f(x, dt) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dt)


def _out(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.float32).numpy()


def drain_sweep(w: World, free: np.ndarray, feas: np.ndarray,
                mpn: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(drainable bool[N], has_blocker bool[N], node fits the first fits
    needed) for removing each node alone. A node's pods, the first `mpn` of
    them in pod order, go by group (rows in order, at most SLOTS) to the
    other nodes in node order, each group seeing what the earlier ones
    took; a node drains when no pod blocks it and all its moved pods find
    room. Destinations are valid, ready, schedulable nodes; no group here
    is limited to one pod a node.

    A group's fit on each node is worked out once; a first fit walks only
    the nodes where it is not 0, in order, and works it out again where the
    candidate's earlier groups took room (taking room never adds any). The
    nodes a first fit needs are those up to the one where its pods are all
    placed, or every node where they are not."""
    n_pad = free.shape[0]
    order = np.argsort(w.res_node, kind="stable")
    by_node = np.split(order, np.searchsorted(w.res_node[order],
                                              np.arange(1, n_pad)))
    fit0, open_nodes = {}, {}
    drainable = np.ones(n_pad, dtype=bool)
    blocker = np.zeros(n_pad, dtype=bool)
    needed = 0
    for c in range(n_pad):
        pods = by_node[c][:mpn]
        if pods.size == 0:
            continue
        blocker[c] = bool(w.blocks[pods].any())
        moving = w.res_group[pods[w.movable[pods]]]
        rows, counts = np.unique(moving, return_counts=True)
        taken: dict[int, np.ndarray] = {}
        placed = 0
        for r, want in list(zip(rows.tolist(), counts.tolist()))[:SLOTS]:
            req = w.groups[r].req
            if r not in fit0:
                fit0[r] = np.where(feas[r] & w.node_ok, fits(free, req), 0)
                open_nodes[r] = np.flatnonzero(fit0[r]).tolist()
            got, need = 0, n_pad
            for node in open_nodes[r]:
                if node == c:
                    continue
                fit = (fits(free[node] - taken[node], req) if node in taken
                       else fit0[r][node])
                take = int(min(fit, want - got))
                if take > 0:
                    taken[node] = taken.get(node, 0) + take * req
                    got += take
                if got >= want:
                    need = node + 1
                    break
            needed += need
            placed += got
        drainable[c] = not blocker[c] and placed == moving.size
    return drainable, blocker, needed


def decide(cfg: dict, traffic: dict, variant, float_dtype=torch.float64,
           record: bool = False):
    """The decision of one variant as {path: numpy array}, keyed as
    judge.flatten keys the program's, and with `record` the work of each
    kernel call that the program's decision makes ([(kernel, bytes,
    operations)], portbench/bounds.py) for the rooflines."""
    dt = float_dtype
    w = world_of(cfg, traffic, variant)
    feas, t_feas = feasibility(w)
    g_real, g_pad = len(w.groups), w.g_pad
    n_pad, ng_pad = w.cap.shape[0], w.t_cap.shape[0]
    req = np.zeros((g_pad, R), dtype=np.int64)
    count = np.zeros(g_pad, dtype=np.int64)
    for r, g in enumerate(w.groups):
        req[r], count[r] = g.req, g.count

    # filter: the pending groups onto the existing nodes
    free = w.cap - w.alloc
    verdict = np.zeros(g_pad, dtype=np.int64)
    for r in ffd_order(w, count, dt):
        place = first_fit(np.where(feas[r], fits(free, req[r]), 0), count[r])
        free = free - place[:, None] * req[r]
        verdict[r] = place.sum()
    alloc_after = w.cap - free
    pending = np.maximum(count - verdict, 0)

    # scale-up: each node group's option, its open bins filled first-fit
    m = cfg["max_new_nodes"]
    bins = np.broadcast_to(w.t_cap[:, None, :], (ng_pad, m, R)).copy()
    is_open = np.arange(m)[None, :] < w.t_open[:, None]
    scheduled = np.zeros((ng_pad, g_pad), dtype=np.int64)
    pods_in_bin = np.zeros((ng_pad, m), dtype=np.int64)
    for r in ffd_order(w, pending, dt):
        ok = t_feas[r][:, None] & is_open
        place = first_fit(np.where(ok, fits(bins, req[r]), 0), pending[r])
        bins -= place[:, :, None] * req[r]
        scheduled[:, r] = place.sum(axis=1)
        pods_in_bin += place
    used = pods_in_bin > 0
    node_count = np.where(w.t_valid, used.sum(axis=1), 0)
    scheduled *= w.t_valid[:, None]

    # the expander's inputs
    pods = scheduled.sum(axis=1)
    used_f = _f(used, dt)
    total_cpu = used_f.sum(-1) * _f(w.t_cap[:, CPU], dt)
    total_mem = used_f.sum(-1) * _f(w.t_cap[:, MEM], dt)
    free_cpu = (_f(bins[:, :, CPU], dt) * used_f).sum(-1)
    free_mem = (_f(bins[:, :, MEM], dt) * used_f).sum(-1)
    one = torch.ones((), dtype=dt)
    waste = (torch.where(total_cpu > 0, free_cpu / total_cpu.clamp(min=1), one)
             + torch.where(total_mem > 0, free_mem / total_mem.clamp(min=1), one))
    price = _f(node_count, dt) * _f(w.t_price, dt)
    helped = _f(scheduled, dt) @ _f(req, dt)

    # scale-down
    ratio = _f(alloc_after[:, [CPU, MEM]], dt) / _f(
        np.maximum(w.cap[:, [CPU, MEM]], 1), dt)
    util = torch.where(torch.from_numpy(w.node_ok), ratio.amax(dim=1),
                       torch.zeros((), dtype=dt))
    mpn = cfg["max_pods_per_node"]
    drainable, blocker, needed = drain_sweep(w, free, feas, mpn)

    out = {
        ".verdict": verdict, ".pending_after": pending,
        ".est_node_count": node_count, ".est_scheduled": scheduled,
        ".scores.valid": w.t_valid & (node_count > 0) & (pods > 0),
        ".scores.pods": pods, ".scores.nodes": node_count,
        ".scores.waste": _out(waste), ".scores.price": _out(price),
        ".scores.helped_req": _out(helped),
        ".util": _out(util), ".drainable": drainable,
        ".has_blocker": blocker, ".alloc_after": alloc_after,
    }
    if not record:
        return out, []
    constrained = bool(cfg["with_constraints"])
    probes = sum(len(g.selector) for g in w.groups)
    plane = dict(probes=probes, taint_slots=int(w.tainted.sum()),
                 intolerant=g_pad)
    nodes_plane = bounds.row_p(g_pad, n_pad, bounds.STATIC,
                               residents=w.p_pad, **plane)
    calls = [("row_p", *nodes_plane),
             ("row_p", *bounds.row_p(g_pad, ng_pad, bounds.STATIC,
                                     probes=probes, taint_slots=0,
                                     intolerant=g_pad)),
             ("row_p", *nodes_plane)]
    if constrained:
        calls += [("row_p", *bounds.row_p(g_pad, n_, bounds.SELECTOR,
                                          probes=probes))
                  for n_ in (n_pad, n_pad, ng_pad, n_pad)]
    else:
        calls += [("k1", *bounds.k1(1, g_pad, n_pad, R, int(feas.sum()))),
                  ("k1", *bounds.k1(ng_pad, g_pad, m, R, int(
                      (t_feas * w.t_open[None, :]).sum())))]
    calls.append(("row_d", *bounds.row_d(
        n_pad, n_pad, R, g_pad, w.p_pad, mpn, needed,
        zones=bounds.ZONES if constrained else None)))
    return out, calls

