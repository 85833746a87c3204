"""The general world and traffic generator.

A configuration file (configs/<name>.json) gives a cluster's sizes and
rules; a traffic file (traffic/<name>.json) says how its V world variants
differ. `variants(cfg, traffic, seed)` draws the variants from the seed as
plain numbers (`Variant`): how many pending pods each owner group holds,
whether the burst is there, and which residents are running. Every seed
gets the same groups, sizes (the configuration's) and amount of churn; only
which pods come and go differ, so that a seed changes the order of the work
and not its size.

`objects(cfg, traffic, variant, api)` turns a variant into
Kubernetes-shaped objects through `api`, the program's object model
(program.py). The reference (reference/decide.py) works from the same plain
numbers and the configuration's rules, and builds no objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np


@dataclass(frozen=True)
class Variant:
    index: int
    counts: tuple[int, ...]          # pending pods of each owner group
    burst: int                       # pods of the burst group (0: none)
    residents: np.ndarray            # bool[nodes * residents_per_node] running


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed` (any non-negative integer, however large)
    and a sub-stream."""
    return np.random.default_rng([int(seed), *stream])


def variants(cfg: dict, traffic: dict, seed: int) -> list[Variant]:
    """The traffic's V variants of the configuration's world, from `seed`."""
    n_groups = cfg["pending_groups"]
    n_res = cfg["nodes"] * cfg["residents_per_node"]
    v_count = traffic["variants"]
    if traffic["pending"]:
        counts = np.full(n_groups, cfg["pending_pods"] // n_groups,
                         dtype=np.int64)
    else:
        counts = np.zeros(n_groups, dtype=np.int64)
    leave = rng_for(seed, 1).permutation(n_res)
    burst = traffic.get("burst") or {}
    churn = traffic["churn"]
    out = []
    for v in range(v_count):
        if v and churn:
            crng = rng_for(seed, 2, v)
            counts = counts - crng.multivariate_hypergeometric(counts, churn)
            counts = counts + crng.multinomial(churn, [1.0 / n_groups] * n_groups)
        present = np.ones(n_res, dtype=bool)
        present[leave[:traffic["residents_leave_per_variant"] * v]] = False
        out.append(Variant(
            index=v, counts=tuple(int(c) for c in counts),
            burst=burst.get("pods", 0) if burst.get("variant") == v else 0,
            residents=present))
    return out


def _named(proto, name: str, **fields):
    """A pod equal to `proto` but for its name, uid and `fields`: the pods
    of one owner group share their (read-only) labels, requests and rules,
    as build_test_pod would have made them equal, at a fraction of its
    cost."""
    pod = object.__new__(type(proto))
    pod.__dict__.update(proto.__dict__)
    pod.__dict__.update(name=name, uid=f"uid-{proto.namespace}/{name}", **fields)
    return pod


def objects(cfg: dict, traffic: dict, variant: Variant, api: SimpleNamespace):
    """(nodes, pods, templates) of one variant, built with `api`'s
    build_test_node, build_test_pod, Taint, Toleration,
    TopologySpreadConstraint and AffinityTerm: the pending pods of each
    owner group, then the burst's, then the running residents. Templates
    are (node, max new nodes, price per node)."""
    zones = cfg["zones"]
    zone_key, host_key = ("topology.kubernetes.io/zone",
                          "kubernetes.io/hostname")
    nodes = []
    for i in range(cfg["nodes"]):
        taints = ([api.Taint("dedicated", "infra", "NoSchedule")]
                  if i % cfg["taint_every"] == 0 else [])
        nodes.append(api.build_test_node(
            f"node-{i}", cpu_milli=cfg["node_cpu_milli"],
            mem_mib=cfg["node_mem_mib"], pods=cfg["node_pods"],
            labels={"pool": "a" if i % 2 else "b",
                    "disk": "ssd" if i % 3 else "hdd"},
            taints=taints, zone=zones[i % len(zones)],
            gpus=cfg["gpus_per_node"] if i % cfg["gpu_node_every"] == 0 else 0))

    tol = [api.Toleration(key="dedicated", operator="Equal", value="infra",
                          effect="NoSchedule")]
    rules = cfg["constraints"]
    every = cfg["constraint_every"]

    def constraint(g):
        rule = rules.get(str(g % every))
        if rule is None:
            return None, None
        if rule["kind"] == "topology_spread":
            return "topology_spread", api.TopologySpreadConstraint(
                max_skew=rule["max_skew"], topology_key=rule["topology_key"],
                match_labels={"grp": f"g{g}"})
        return rule["kind"], api.AffinityTerm(
            match_labels=dict(rule["match_labels"]),
            topology_key=rule["topology_key"])

    pods = []
    for g, count in enumerate(variant.counts):
        cpu, mem = cfg["group_sizes"][g]
        field, rule = constraint(g)
        proto = api.build_test_pod(
            f"pod-{g}-0", cpu_milli=cpu, mem_mib=mem, owner_name=f"rs-{g}",
            node_selector={"disk": "ssd"} if g % cfg["ssd_every"] == 0 else {},
            tolerations=tol if g % cfg["tolerate_every"] == 0 else [],
            gpus=1 if g % cfg["gpu_group_every"] == 0 else 0,
            labels={"grp": f"g{g}"} if rules else None)
        if field:
            setattr(proto, field, [rule])
        pods += [_named(proto, f"pod-{g}-{i}") for i in range(count)]
    if variant.burst:
        b = traffic["burst"]
        proto = api.build_test_pod("burst-0", cpu_milli=b["cpu_milli"],
                                   mem_mib=b["mem_mib"], owner_name="burst-rs")
        pods += [_named(proto, f"burst-{i}") for i in range(variant.burst)]
    rpn = cfg["residents_per_node"]
    owners = cfg["resident_owners"]
    protos = [api.build_test_pod(
        "res-0", cpu_milli=cfg["resident_cpu_milli"],
        mem_mib=cfg["resident_mem_mib"], owner_name=f"rs{o}",
        node_name="node-0",
        labels={"app": f"a{o % 5}"} if cfg["resident_app_labels"] else None)
        for o in range(owners)]
    pods += [_named(protos[k % owners], f"res-{k}", node_name=f"node-{k // rpn}")
             for k in np.flatnonzero(variant.residents).tolist()]
    templates = []
    k = len(cfg["template_cpu_milli"])
    for t in range(cfg["node_groups"]):
        tmpl = api.build_test_node(
            f"template-{t}", cpu_milli=cfg["template_cpu_milli"][t % k],
            mem_mib=cfg["template_mem_mib"][t % k], pods=cfg["node_pods"],
            labels={"pool": "a" if t % 2 else "b",
                    "disk": "ssd" if t % 3 else "hdd"},
            zone=zones[t % len(zones)],
            gpus=(cfg["gpus_per_node"] if t % cfg["template_gpu_every"] == 0
                  else 0))
        templates.append((tmpl, cfg["template_max_new"], float(1 + t)))
    return nodes, pods, templates
