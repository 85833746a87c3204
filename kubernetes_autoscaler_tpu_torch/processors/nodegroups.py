"""Node-group list processing and auto-provisioning lifecycle.

Reference counterparts (SURVEY.md §2.6): `NodeGroupListProcessor` (identity
default, autoprovisioning variant under processors/nodegroups/) which extends
the candidate node-group list before expansion options are computed, and
`NodeGroupManager` which owns create/delete of autoprovisioned groups
(creation of the expander's winner before IncreaseSize; deletion of empty
autoprovisioned groups each loop).
"""

from __future__ import annotations

from typing import Protocol

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import (
    CloudProvider,
    NodeGroup,
    NodeGroupError,
)
from kubernetes_autoscaler_tpu_torch.models.api import Pod


class NodeGroupListProcessor(Protocol):
    def process(self, provider: CloudProvider, groups: list[NodeGroup],
                pending: list[Pod]) -> list[NodeGroup]: ...


class IdentityNodeGroupListProcessor:
    """Default: candidates are exactly the provider's existing groups."""

    def process(self, provider, groups, pending):
        return groups


class AutoprovisioningNodeGroupListProcessor:
    """Extend candidates with not-yet-existing groups built from the cloud's
    machine catalog (reference: processors/nodegroups autoprovisioning — one
    candidate per available machine type, capped by
    --max-autoprovisioned-node-group-count)."""

    def __init__(self, max_autoprovisioned_groups: int = 15):
        self.max_autoprovisioned_groups = max_autoprovisioned_groups

    def process(self, provider, groups, pending):
        get_types = getattr(provider, "get_available_machine_types", None)
        new_group = getattr(provider, "new_node_group", None)
        if get_types is None or new_group is None or not pending:
            return groups
        # dedup/count against the provider's FULL registry, not the filtered
        # candidate list — a registered group excluded by validity filters
        # (max size, backoff) must not get a duplicate candidate that would
        # bypass those gates
        registered = list(provider.node_groups())
        existing_ids = {g.id() for g in registered} | {g.id() for g in groups}
        autoprovisioned_count = sum(1 for g in registered if g.autoprovisioned())
        out = list(groups)
        for mt in get_types():
            if autoprovisioned_count >= self.max_autoprovisioned_groups:
                break
            try:
                cand = new_group(mt)
            except NodeGroupError:
                continue
            if cand.id() in existing_ids:
                continue
            out.append(cand)
            autoprovisioned_count += 1
        return out


class NodeGroupManager:
    """Auto-provisioned group lifecycle (reference: the default
    NodeGroupManager processors row, §2.6)."""

    def create_node_group(self, group: NodeGroup) -> NodeGroup:
        if group.exist():
            return group
        created = group.create()
        from kubernetes_autoscaler_tpu_torch.metrics.metrics import default_registry

        default_registry.counter("created_node_groups_total").inc()
        return created

    def remove_unneeded_node_groups(self, provider: CloudProvider) -> list[str]:
        """Delete empty autoprovisioned groups (no nodes, target 0)."""
        removed = []
        for g in list(provider.node_groups()):
            if not g.autoprovisioned() or not g.exist():
                continue
            if g.target_size() == 0 and not any(
                i.state != "Deleting" for i in g.nodes()
            ):
                try:
                    g.delete()
                    removed.append(g.id())
                    from kubernetes_autoscaler_tpu_torch.metrics.metrics import (
                        default_registry,
                    )

                    default_registry.counter("deleted_node_groups_total").inc()
                except NodeGroupError:
                    pass
        return removed
