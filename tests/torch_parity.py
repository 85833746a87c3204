"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same seeded world is built with each package's own object model and
encoder, and the outputs are compared leaf by leaf: dtype, shape and bytes,
or a stated float tolerance.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

REF = "kubernetes_autoscaler_tpu"
PORT = "kubernetes_autoscaler_tpu_torch"


def leaves(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a reference (flax) or port (dataclass) tree into
    {path: numpy array}; None fields are skipped."""
    out: dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
        return out
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(leaves(getattr(tree, f.name), f"{prefix}.{f.name}"))
        return out
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}[{i}]"))
        return out
    out[prefix] = np.asarray(tree)
    return out


def assert_trees_equal(ref, got, float_rtol: float | None = None,
                       float_atol: float = 0.0) -> list[str]:
    """Every leaf of `ref` has a leaf of `got` with the same dtype and shape.
    Integer and bool leaves are byte-identical; float leaves are too, unless
    `float_rtol` is given. Returns the compared paths."""
    a, b = leaves(ref), leaves(got)
    assert sorted(a) == sorted(b), (sorted(set(a) ^ set(b)))
    for path in sorted(a):
        x, y = a[path], b[path]
        assert x.dtype == y.dtype, f"{path}: dtype {x.dtype} vs {y.dtype}"
        assert x.shape == y.shape, f"{path}: shape {x.shape} vs {y.shape}"
        if x.dtype.kind == "f" and float_rtol is not None:
            np.testing.assert_allclose(y, x, rtol=float_rtol, atol=float_atol,
                                       err_msg=path)
        else:
            assert x.tobytes() == y.tobytes(), f"{path}: bytes differ"
    return sorted(a)


def build_world(package: str, n_nodes: int = 24, n_pending_groups: int = 6,
                pods_per_group: int = 5, residents_per_node: int = 2,
                seed: int = 0, fits: bool = False, pools: int = 0):
    """(nodes, pods, templates) built with `package`'s own object model.

    Nodes carry labels, zones, a dedicated taint on every fifth node and
    GPUs on every seventh; pending groups carry selectors, tolerations,
    GPUs, hostPorts, node affinity and self-anti-affinity; every node gets
    `residents_per_node` resident pods, some of them not evictable. With
    `fits`, pending demand is small and unconstrained so every pod fits the
    existing nodes.

    With `pools` = k > 0 the cluster is carved into k node pools: node i
    and template t are labelled pool p{i % k} / p{t % k}, every pending
    group g and every resident is pinned to one pool by its selector (and
    node affinity), and each self-anti-affinity group also has one running
    sibling on its pool's first node — so masks overlap only within a pool
    (a worthwhile wavefront plan) and the runtime mask is a strict subset of
    the plan mask."""
    api = importlib.import_module(f"{package}.models.api")
    t = importlib.import_module(f"{package}.utils.testing")
    rng = np.random.RandomState(seed)
    zones = ["za", "zb", "zc"]

    def pool_of(i: int) -> str:
        return f"p{i % pools}" if pools else ("a" if i % 2 else "b")

    nodes = []
    for i in range(n_nodes):
        taints = ([api.Taint("dedicated", "infra", "NoSchedule")]
                  if i % 5 == 0 else [])
        nodes.append(t.build_test_node(
            f"n{i}", cpu_milli=int(rng.choice([2000, 4000, 8000])),
            mem_mib=int(rng.choice([4096, 8192])), pods=16,
            labels={"pool": pool_of(i),
                    "disk": "ssd" if i % 3 else "hdd"},
            taints=taints, zone=zones[i % 3], gpus=2 if i % 7 == 0 else 0))
    pods = []
    for i, nd in enumerate(nodes):
        for j in range(residents_per_node):
            p = t.build_test_pod(
                f"r{i}-{j}", cpu_milli=int(rng.choice([200, 400, 800])),
                mem_mib=256, owner_name=f"rs{(i + j) % 5}", node_name=nd.name,
                node_selector={"pool": pool_of(i)} if pools else {})
            if (i + j) % 9 == 0:
                p.annotations[api.SAFE_TO_EVICT_KEY] = "false"
            pods.append(p)
    siblings = []
    for g in range(n_pending_groups):
        if fits:
            cpu, mem, sel, tol, gpus, port = 100, 64, {}, [], 0, 0
        else:
            cpu = int(rng.choice([250, 500, 1000, 3000]))
            mem = int(rng.choice([256, 1024, 4096]))
            sel = {"disk": "ssd"} if g % 3 == 0 else {}
            tol = ([api.Toleration(key="dedicated", operator="Equal",
                                   value="infra", effect="NoSchedule")]
                   if g % 2 == 0 else [])
            gpus = 1 if g % 4 == 1 else 0
            port = 8080 if g % 5 == 4 else 0
        if pools:
            sel = {**sel, "pool": pool_of(g)}

        def group_pod(name, node_name="", g=g, cpu=cpu, mem=mem, sel=sel,
                      tol=tol, gpus=gpus, port=port):
            p = t.build_test_pod(
                name, cpu_milli=cpu, mem_mib=mem, owner_name=f"prs{g}",
                node_selector=sel, tolerations=tol, gpus=gpus, host_port=port,
                labels={"app": f"a{g}"}, node_name=node_name)
            if not fits and g % 3 == 2:
                p.required_node_affinity = [api.NodeSelectorRequirement(
                    "pool", "In", (pool_of(g) if pools else "a",))]
            if not fits and g % 4 == 3:
                p.anti_affinity = [api.AffinityTerm(
                    match_labels={"app": f"a{g}"},
                    topology_key="kubernetes.io/hostname")]
            return p

        for i in range(pods_per_group):
            pods.append(group_pod(f"p{g}-{i}"))
        if pools and not fits and g % 4 == 3:
            siblings.append(group_pod(f"s{g}", node_name=f"n{g % pools}"))
    pods.extend(siblings)
    templates = []
    for k in range(4):
        tmpl = t.build_test_node(
            f"tmpl{k}", cpu_milli=[2000, 4000, 8000, 16000][k],
            mem_mib=[4096, 8192, 16384, 32768][k], pods=16,
            labels={"pool": pool_of(k),
                    "disk": "ssd" if k % 3 else "hdd"},
            zone=zones[k % 3], gpus=2 if k == 3 else 0)
        templates.append((tmpl, 6 + 3 * k, float(1 + k)))
    return nodes, pods, templates


def encode_world(package: str, world, device=None, node_bucket: int = 16,
                 group_bucket: int = 16):
    """Encode a world with `package`'s encoder, then drainability; returns
    (EncodedCluster, NodeGroupTensors). `device` goes to the port only."""
    enc_mod = importlib.import_module(f"{package}.models.encode")
    rules = importlib.import_module(f"{package}.simulator.drainability.rules")
    nodes, pods, templates = world
    kw = {} if package == REF else {"device": device}
    enc = enc_mod.encode_cluster(nodes, pods, node_bucket=node_bucket,
                                 group_bucket=group_bucket, **kw)
    rules.apply_drainability(enc, now=0.0)
    groups = enc_mod.encode_node_groups(templates, enc.registry,
                                        enc.zone_table, **kw)
    return enc, groups
