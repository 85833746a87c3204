"""Synthetic branch worlds — a seeded FakeCluster run through one live
fused loop, so the CLI, the bench, and the determinism tests all branch
from the same kind of branch point a production tenant would give them
(never from hand-built tensors that could drift from the encoder).

Counterpart of the reference package's `whatif/synthetic.py`, on the port's
fake cluster, test builders and control loop; `device` (None = CUDA,
raising without a card) is where the loop runs."""

from __future__ import annotations

import numpy as np


def synthetic_autoscaler(n_nodes: int = 8, n_pending: int = 6, seed: int = 0,
                         n_groups: int = 2, pending_milli: int = 300,
                         device=None, **opts_kw):
    """A FakeCluster world (resident load + pending pods + a drain band)
    under a fused-loop StaticAutoscaler. Returns (fake, autoscaler) —
    run_once has NOT been called yet."""
    from kubernetes_autoscaler_tpu_torch.config.options import (
        AutoscalingOptions,
        NodeGroupDefaults,
    )
    from kubernetes_autoscaler_tpu_torch.core.static_autoscaler import (
        StaticAutoscaler,
    )
    from kubernetes_autoscaler_tpu_torch.metrics.metrics import Registry
    from kubernetes_autoscaler_tpu_torch.utils.fakecluster import FakeCluster
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    rng = np.random.RandomState(seed)
    fake = FakeCluster()
    for g in range(max(n_groups, 1)):
        tmpl = build_test_node(f"tmpl{g}", cpu_milli=4000 * (g + 1),
                               mem_mib=8192 * (g + 1))
        fake.add_node_group(f"ng{g}", tmpl, min_size=0, max_size=20)
    for i in range(n_nodes):
        nd = build_test_node(f"n{i}", cpu_milli=4000, mem_mib=8192)
        fake.add_existing_node("ng0", nd)
        # every node carries at least one resident pod: the compressed
        # rollout actuation only retires EMPTY nodes, so a fully-resident
        # steady world stays bitwise fixed (the null-lane identity shape)
        fake.add_pod(build_test_pod(
            f"r{i}", cpu_milli=int(rng.choice([400, 800, 1600])),
            mem_mib=512, owner_name=f"rs{i % 3}", node_name=nd.name))
    for i in range(n_pending):
        fake.add_pod(build_test_pod(f"p{i}", cpu_milli=pending_milli,
                                    mem_mib=256, owner_name="prs"))

    base = dict(
        scale_down_delay_after_add_s=0.0,
        scale_down_delay_after_failure_s=0.0,
        node_shape_bucket=16, group_shape_bucket=16,
        max_new_nodes_static=32, max_pods_per_node=32, drain_chunk=8,
        max_bulk_soft_taint_count=0,
        fused_loop=True,
        node_group_defaults=NodeGroupDefaults(
            scale_down_unneeded_time_s=3600.0,
            scale_down_unready_time_s=3600.0),
    )
    base.update(opts_kw)
    a = StaticAutoscaler(fake.provider, fake, options=AutoscalingOptions(
        **base), eviction_sink=fake, registry=Registry(), device=device)
    return fake, a


def synthetic_branch(n_nodes: int = 8, n_pending: int = 6, seed: int = 0,
                     n_groups: int = 2, loops: int = 1, now: float = 1000.0,
                     pending_milli: int = 300, device=None, **opts_kw):
    """Run `loops` live fused loops on a synthetic world and branch the
    last one. Returns (branch, autoscaler) — the autoscaler is live, so a
    caller can keep running loops to compare trajectories."""
    from kubernetes_autoscaler_tpu_torch.whatif.variants import branch_from_live

    _fake, a = synthetic_autoscaler(n_nodes, n_pending, seed, n_groups,
                                    pending_milli=pending_milli,
                                    device=device, **opts_kw)
    st = None
    for k in range(max(loops, 1)):
        st = a.run_once(now=now + 10.0 * k)
    if st is None or st.fused_mode != "fused":
        raise RuntimeError(
            f"synthetic world did not take the fused path "
            f"(mode={getattr(st, 'fused_mode', None)!r})")
    br = branch_from_live(a)
    br.meta = {"source": "synthetic", "seed": seed, "nodes": n_nodes,
               "pending": n_pending, "groups": n_groups, "loops": loops}
    return br, a
