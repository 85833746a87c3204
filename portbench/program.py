"""The system under test: the port's fused autoscaling decision.

Everything here goes through `kubernetes_autoscaler_tpu_torch`: its object
model and encoder at set-up, then per request

    decision, _ = run_once_fused(nodes, specs, scheduled, groups, limit_cap,
                                 dims, max_new_nodes=..., max_pods_per_node=...
                                 [, planes=..., with_constraints=True])
    host = fetch_pytree(decision)

as the control loop asks for it. The port is imported inside the functions
here, so that the harness loads nothing of it before it has looked for the
card.
"""

from __future__ import annotations

from types import SimpleNamespace

from portbench import world


def api() -> SimpleNamespace:
    """The port's object constructors, for world.objects."""
    from kubernetes_autoscaler_tpu_torch.models.api import (
        AffinityTerm,
        Taint,
        Toleration,
        TopologySpreadConstraint,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    return SimpleNamespace(
        build_test_node=build_test_node, build_test_pod=build_test_pod,
        Taint=Taint, Toleration=Toleration,
        TopologySpreadConstraint=TopologySpreadConstraint,
        AffinityTerm=AffinityTerm)


class Program:
    """The V encoded world variants of one cell on `device`, and the
    decision call on each."""

    def __init__(self, cfg: dict, traffic: dict, variants, device: str):
        import torch

        from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
        from kubernetes_autoscaler_tpu_torch.models.encode import (
            encode_cluster,
            encode_node_groups,
        )
        from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, hostfetch
        from kubernetes_autoscaler_tpu_torch.simulator.drainability.rules import (
            apply_drainability,
        )

        self._step = autoscale_step.run_once_fused
        self._fetch = hostfetch.fetch_pytree
        self.phases = autoscale_step.PHASES
        build = api()
        dims = Dims()
        self.calls = []
        for v in variants:
            nodes, pods, templates = world.objects(cfg, traffic, v, build)
            enc = encode_cluster(nodes, pods, node_bucket=cfg["node_bucket"],
                                 group_bucket=cfg["group_bucket"],
                                 device=device)
            apply_drainability(enc, now=0.0)
            groups = encode_node_groups(templates, enc.registry,
                                        enc.zone_table, device=device)
            limit_cap = torch.full((groups.ng,), cfg["max_new_nodes"],
                                   dtype=torch.int32, device=device)
            kw = dict(max_new_nodes=cfg["max_new_nodes"],
                      max_pods_per_node=cfg["max_pods_per_node"])
            if cfg["with_constraints"]:
                kw.update(planes=enc.planes, with_constraints=True)
            self.calls.append(((enc.nodes, enc.specs, enc.scheduled, groups,
                                limit_cap, dims), kw))

    def decide(self, v: int, on_phase=None):
        """Request v's decision on the device (queued, not waited for)."""
        args, kw = self.calls[v]
        decision, _ = self._step(*args, **kw, on_phase=on_phase)
        return decision

    def fetch(self, decision):
        """The decision on the host: the port's one packed fetch."""
        return self._fetch(decision)
