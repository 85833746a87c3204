"""Dynamic Resource Allocation (DRA): device claims on the tensor plane.

Reference counterpart: simulator/dynamicresources/ (2679 LoC — SURVEY.md
§2.3): a fork/commit/revert patchset store of ResourceClaims / ResourceSlices
/ DeviceClasses, with claim allocation and reservation performed during
simulated scheduling, plus eager joining of slices into NodeInfos
(predicate_snapshot.go:72-120).

TPU re-design: the pointer-graph store disappears. Devices are counted per
(node, device-class) and LOWERED INTO THE RESOURCE AXIS before encoding:
each device class maps to an extended-resource slot ("dra/<class>"), node
device counts become capacity, per-pod claims become requests. Feasibility,
allocation charging, and fork/commit/revert then ride the existing
int32 resource tensors for free — one comparison per class on the VPU
instead of per-device object matching.

Exactness tiering (the framework-wide pattern): what the dense encoding
cannot express — CEL-style device attribute selectors, shared multi-pod
claims (ReservedFor), partitionable devices — sets `needs_host_check`, and
the winner-verification tier re-checks with `claim_fits_exact` before
actuation (same contract as oracle.check_pod_on_node for affinity).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.models.api import (
    HOST_CHECK_ANNOTATION,
    Node,
    Pod,
)

DRA_RESOURCE_PREFIX = "dra/"
# markers recording what apply_dra wrote onto the persistent objects, so the
# next pass can CLEAR residue when claims/slices disappear (the loop
# re-lists the same Node/Pod objects every tick)
DRA_PIN_ANNOTATION = "autoscaler.x-k8s.io/dra-pinned-host"
# the USER's own hostname selector value the pin overwrote (restored on clear)
DRA_PIN_PREV_ANNOTATION = "autoscaler.x-k8s.io/dra-pinned-host-prev"
from kubernetes_autoscaler_tpu_torch.models.api import (  # noqa: E402
    CSI_LOSSY_ANNOTATION,
    DRA_LOSSY_ANNOTATION,
)


@dataclass
class DeviceClass:
    """reference: resource.k8s.io DeviceClass (simulator/dynamicresources
    snapshot stores these verbatim)."""

    name: str
    # class-level required attributes (every device of the class has them)
    attributes: dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceSlice:
    """A pool of identical devices one node publishes (reference:
    ResourceSlice; LocalResourceSlices joined into NodeInfo at
    framework/infos.go:57)."""

    node_name: str
    device_class: str
    count: int
    # per-device attributes for selector matching (uniform within a slice)
    attributes: dict[str, str] = field(default_factory=dict)


@dataclass
class ClaimRequest:
    """One request inside a claim: N devices of a class, optionally
    attribute-constrained (the simulable subset of CEL selectors:
    attribute equality)."""

    device_class: str
    count: int = 1
    selector: dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceClaim:
    """reference: ResourceClaim/ResourceClaimTemplate. `owner_pod` empty means
    a shared claim (multiple pods reserve it) — host-check tier."""

    name: str
    namespace: str = "default"
    requests: list[ClaimRequest] = field(default_factory=list)
    owner_pod: str = ""               # pod name for per-pod (template) claims
    allocated_node: str = ""          # "" = unallocated
    reserved_for: list[str] = field(default_factory=list)


# ReservedFor list cap (reference: resourceapi.ResourceClaimReservedForMaxSize)
RESERVED_FOR_MAX = 32


@dataclass
class DraSnapshot:
    """The queryable DRA world handed to the lowering pass (reference:
    DraProvider.Snapshot() at static_autoscaler.go:313).

    Fork/commit/revert mirror the reference's patchset store
    (simulator/dynamicresources/snapshot + simulator/common/patchset.go):
    the mutable claim state (allocation + reservations) is checkpointed as an
    overlay stack; slices and classes are immutable within a loop."""

    classes: dict[str, DeviceClass] = field(default_factory=dict)
    slices: list[ResourceSlice] = field(default_factory=list)
    claims: list[ResourceClaim] = field(default_factory=list)
    _stack: list[dict[str, tuple[str, tuple[str, ...]]]] = field(
        default_factory=list, repr=False)

    # ---- fork/commit/revert (reference: patchset Fork/Commit/Revert) ----

    def fork(self) -> None:
        self._stack.append({
            c.name: (c.allocated_node, tuple(c.reserved_for))
            for c in self.claims
        })

    def revert(self) -> None:
        if not self._stack:
            raise RuntimeError("revert without fork")
        saved = self._stack.pop()
        for c in self.claims:
            if c.name in saved:
                node, reserved = saved[c.name]
                c.allocated_node = node
                c.reserved_for = list(reserved)

    def commit(self) -> None:
        if not self._stack:
            raise RuntimeError("commit without fork")
        self._stack.pop()  # keep the current (child) state

    # ---- queries ----

    def claim_by_name(self, name: str, namespace: str = "default"
                      ) -> ResourceClaim | None:
        for c in self.claims:
            if c.name == name and c.namespace == namespace:
                return c
        return None

    def claims_for_pod(self, pod: Pod) -> list[ResourceClaim]:
        """Owned (template) claims plus referenced shared claims."""
        out = [c for c in self.claims
               if c.owner_pod == pod.name and c.namespace == pod.namespace]
        for name in pod.resource_claims:
            c = self.claim_by_name(name, pod.namespace)
            if c is not None and c not in out:
                out.append(c)
        return out

    def sharers_of(self, claim: ResourceClaim, pods: list[Pod]) -> list[Pod]:
        return [p for p in pods
                if p.namespace == claim.namespace
                and (claim.name in p.resource_claims
                     or claim.owner_pod == p.name)]

    def device_capacity(self) -> dict[str, dict[str, int]]:
        """node -> class -> device count. Global slices (node_name == "")
        are pool devices not tied to any node and impose no node constraint."""
        out: dict[str, dict[str, int]] = {}
        for s in self.slices:
            if not s.node_name:
                continue
            per = out.setdefault(s.node_name, {})
            per[s.device_class] = per.get(s.device_class, 0) + s.count
        return out

    # ---- reservation (reference: claim reservation in RunReserve) ----

    def reserve(self, claim: ResourceClaim, pod: Pod, node_name: str) -> bool:
        """Allocate (if needed) and add the pod to ReservedFor. False when
        the claim is bound elsewhere or the ReservedFor list is full."""
        if claim.allocated_node and claim.allocated_node != node_name:
            if self._is_node_local(claim):
                return False
        if len(claim.reserved_for) >= RESERVED_FOR_MAX:
            return False
        if not claim.allocated_node and self._is_node_local(claim):
            claim.allocated_node = node_name
        ref = f"{pod.namespace}/{pod.name}"
        if ref not in claim.reserved_for:
            claim.reserved_for.append(ref)
        return True

    def release(self, pod: Pod) -> None:
        """Drop the pod's reservations; deallocate claims nobody holds
        (reference: unreserve + deallocation on drain/unschedule)."""
        ref = f"{pod.namespace}/{pod.name}"
        for c in self.claims_for_pod(pod):
            if ref in c.reserved_for:
                c.reserved_for.remove(ref)
            if not c.reserved_for:
                c.allocated_node = ""

    def _is_node_local(self, claim: ResourceClaim) -> bool:
        """A claim binds to one node unless EVERY request's class is served
        by a global pool (node_name == "" slices). Classes with no slices at
        all — e.g. scale-from-zero, where only templates advertise devices —
        are node-local (the conservative and correct default)."""
        for req in claim.requests:
            has_global = any(not s.node_name
                             and s.device_class == req.device_class
                             for s in self.slices)
            if not has_global:
                return True
        return False


def slice_matches(s: ResourceSlice, req: ClaimRequest,
                  classes: dict[str, DeviceClass]) -> bool:
    if s.device_class != req.device_class:
        return False
    attrs = dict(classes.get(req.device_class, DeviceClass(req.device_class)).attributes)
    attrs.update(s.attributes)
    return all(attrs.get(k) == v for k, v in req.selector.items())


def claim_fits_exact(claim: ResourceClaim, node: Node, dra: DraSnapshot,
                     allocated: dict[tuple[str, str], int] | None = None) -> bool:
    """Host-side exact check: every request satisfiable from the node's
    matching slices minus what's already allocated (the winner-verification
    tier for selectored/shared claims)."""
    allocated = allocated or {}
    for req in claim.requests:
        avail = 0
        for s in dra.slices:
            if s.node_name != node.name:
                continue
            if slice_matches(s, req, dra.classes):
                avail += s.count
        avail -= allocated.get((node.name, req.device_class), 0)
        if avail < req.count:
            return False
    return True


DRA_SHARED_LABEL_PREFIX = "dra.claim/"


def apply_dra(nodes: list[Node], pods: list[Pod], dra: DraSnapshot):
    """The lowering pass: fold device counts into node capacity and claim
    counts into pod requests as 'dra/<class>' extended resources, BEFORE
    encode_cluster.

    Shared claims (multiple sharers, reference: ReservedFor) lower to:
      * allocated node-local claim  → every PENDING sharer gets a hostname
        nodeSelector to the allocated node (dense); devices are charged to
        that node once by subtracting from its published capacity.
      * unallocated node-local claim → one REPRESENTATIVE sharer carries the
        device request; all sharers get a synthetic self pod-affinity on
        hostname (the gang shape the wave placer handles exactly, including
        the first-pod exception) so they co-locate where the devices are.
      * global-pool claims (only global slices provide the class) impose no
        node constraint and charge nothing node-local.
    Pods with selectored claims or other inexpressible shapes get the
    host-check annotation (claim_fits_exact is the exact tier).

    Totals are recomputed and OVERWRITTEN each pass — the loop re-lists the
    same Pod objects every tick, so += would compound across loops. Every
    DRA-owned mutation is CLEARED up front so deleted claims/slices leave no
    residue (requests/capacity keys, hostname pins, gang labels/affinity,
    the host-check mark) — without this, a removed claim left its pod
    demanding phantom devices forever."""
    clear_dra_lowering(nodes, pods)
    cap = dra.device_capacity()
    # devices held by allocated claims of NON-resident owners (shared claims
    # or claims of departed pods) reduce the node's free devices; resident
    # owners are charged through their own pod requests at encode time
    pods_by_ref = {f"{p.namespace}/{p.name}": p for p in pods}
    held: dict[str, dict[str, int]] = {}
    for claim in dra.claims:
        if not claim.allocated_node:
            continue
        resident_owner = any(
            pods_by_ref.get(ref) is not None
            and pods_by_ref[ref].node_name == claim.allocated_node
            and pods_by_ref[ref].name == claim.owner_pod
            for ref in claim.reserved_for
        )
        if claim.owner_pod and resident_owner:
            continue  # charged via the owner pod's lowered requests
        per = held.setdefault(claim.allocated_node, {})
        for req in claim.requests:
            per[req.device_class] = per.get(req.device_class, 0) + req.count
    for nd in nodes:
        for cls, count in cap.get(nd.name, {}).items():
            key = DRA_RESOURCE_PREFIX + cls
            free = count - held.get(nd.name, {}).get(cls, 0)
            nd.capacity[key] = max(free, 0)
            if nd.allocatable:
                nd.allocatable[key] = max(free, 0)

    shared_rep: dict[str, str] = {}   # claim key -> representative pod name
    for claim in dra.claims:
        sharers = dra.sharers_of(claim, pods)
        if len(sharers) <= 1 or not dra._is_node_local(claim):
            continue
        ckey = f"{claim.namespace}/{claim.name}"
        pending = [p for p in sharers if not p.node_name]
        if claim.allocated_node:
            # bound claim: pending sharers can only go where the devices are
            for p in pending:
                _pin_host(p, claim.allocated_node)
        elif pending:
            shared_rep[ckey] = pending[0].name
            from kubernetes_autoscaler_tpu_torch.models.api import AffinityTerm

            gang_label = DRA_SHARED_LABEL_PREFIX + claim.name
            for p in pending:
                p.labels[gang_label] = "y"
                if not any(t.match_labels == {gang_label: "y"}
                           for t in p.pod_affinity):
                    p.pod_affinity.append(AffinityTerm(
                        match_labels={gang_label: "y"}))

    for pod in pods:
        totals: dict[str, int] = {}
        lossy = False
        for claim in dra.claims_for_pod(pod):
            sharers = dra.sharers_of(claim, pods)
            shared = len(sharers) > 1 or not claim.owner_pod
            if (claim.allocated_node and not pod.node_name
                    and claim.owner_pod == pod.name):
                # owned claim already bound: the pod must follow its devices,
                # which `held` charged to the node (no double charge)
                _pin_host(pod, claim.allocated_node)
                continue
            for req in claim.requests:
                if req.selector:
                    lossy = True
                if not dra._is_node_local(claim):
                    continue  # global pool: no node-local charge
                key = DRA_RESOURCE_PREFIX + req.device_class
                if shared:
                    ckey = f"{claim.namespace}/{claim.name}"
                    if shared_rep.get(ckey) == pod.name:
                        totals[key] = totals.get(key, 0) + req.count
                        lossy = True  # exact tier re-checks the gang charge
                else:
                    totals[key] = totals.get(key, 0) + req.count
        for key, total in totals.items():
            pod.requests[key] = total
        if lossy:
            pod.annotations[HOST_CHECK_ANNOTATION] = "true"
            pod.annotations[DRA_LOSSY_ANNOTATION] = "true"
    return lowering_fingerprint(nodes, pods, DRA_RESOURCE_PREFIX,
                                (DRA_PIN_ANNOTATION, DRA_LOSSY_ANNOTATION))


def lowering_fingerprint(nodes, pods, prefix: str,
                         annotations: tuple[str, ...]) -> int:
    """Hash of everything a lowering pass WROTE onto the live objects.

    The control plane compares this per loop to decide whether the
    incremental encoder must rebuild: the lowered OUTPUT depends on the pod
    set (claim residency, PVC sharing), not just the DRA/CSI snapshots, so
    fingerprinting the inputs is not enough. Only prefixed keys and the
    pass's own annotations contribute — O(touched objects), not O(world)."""
    acc = hash(prefix)
    for nd in nodes:
        for k, v in nd.capacity.items():
            if k.startswith(prefix):
                acc = hash((acc, nd.name, k, v))
    for p in pods:
        for k, v in p.requests.items():
            if k.startswith(prefix):
                acc = hash((acc, p.namespace, p.name, k, v))
        for k in p.labels:
            if k.startswith(DRA_SHARED_LABEL_PREFIX):
                acc = hash((acc, p.namespace, p.name, k))
        for a in annotations:
            v = p.annotations.get(a)
            if v is not None:
                acc = hash((acc, p.namespace, p.name, a, v))
    return acc


def _pin_host(p: Pod, node_name: str) -> None:
    """Overwrite the hostname selector with the claim's node, stashing any
    USER-authored value so clear_dra_lowering can restore (not delete) it —
    the clear runs first each pass, so the current selector here IS the
    user's state. A SECOND pin in the same pass must not re-stash (it would
    capture the first pin as if it were user state)."""
    prev = p.node_selector.get("kubernetes.io/hostname")
    if DRA_PIN_ANNOTATION not in p.annotations and prev is not None:
        p.annotations[DRA_PIN_PREV_ANNOTATION] = prev
    p.annotations[DRA_PIN_ANNOTATION] = node_name
    p.node_selector["kubernetes.io/hostname"] = node_name


def clear_prefixed_resources(nodes: list[Node], pods: list[Pod],
                             prefix: str) -> None:
    """Purge a lowering pass's resource-key namespace from the live objects
    (shared by the DRA and CSI clears)."""
    for nd in nodes:
        for store in (nd.capacity, nd.allocatable):
            if not store:
                continue
            for k in [k for k in store if k.startswith(prefix)]:
                del store[k]
    for p in pods:
        for k in [k for k in p.requests if k.startswith(prefix)]:
            del p.requests[k]


def clear_dra_lowering(nodes: list[Node], pods: list[Pod]) -> None:
    """Remove everything a previous apply_dra pass wrote (see its docstring)."""
    clear_prefixed_resources(nodes, pods, DRA_RESOURCE_PREFIX)
    for p in pods:
        gang = [k for k in p.labels if k.startswith(DRA_SHARED_LABEL_PREFIX)]
        for k in gang:
            del p.labels[k]
        if p.pod_affinity:
            p.pod_affinity = [
                t for t in p.pod_affinity
                if not (len(t.match_labels) == 1 and next(
                    iter(t.match_labels)).startswith(DRA_SHARED_LABEL_PREFIX))]
        pin = p.annotations.pop(DRA_PIN_ANNOTATION, None)
        prev = p.annotations.pop(DRA_PIN_PREV_ANNOTATION, None)
        if pin is not None \
                and p.node_selector.get("kubernetes.io/hostname") == pin:
            if prev is not None:
                p.node_selector["kubernetes.io/hostname"] = prev
            else:
                del p.node_selector["kubernetes.io/hostname"]
        if p.annotations.pop(DRA_LOSSY_ANNOTATION, None) is not None \
                and CSI_LOSSY_ANNOTATION not in p.annotations:
            p.annotations.pop(HOST_CHECK_ANNOTATION, None)


def allocate_claim(claim: ResourceClaim, node: Node, pod: Pod) -> None:
    """Actuation-time bookkeeping (reference: RunReserve during SchedulePod,
    predicate_snapshot.go SchedulePod → DRA claim reservation)."""
    claim.allocated_node = node.name
    ref = f"{pod.namespace}/{pod.name}"
    if ref not in claim.reserved_for:
        claim.reserved_for.append(ref)


def deallocate_claim(claim: ResourceClaim, pod: Pod) -> None:
    ref = f"{pod.namespace}/{pod.name}"
    if ref in claim.reserved_for:
        claim.reserved_for.remove(ref)
    if not claim.reserved_for:
        claim.allocated_node = ""
