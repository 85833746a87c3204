"""Buffer → fake-pod translation.

Reference counterpart: capacitybuffer/translators/ — one translator per spec
shape (pod-template-based, scalable-object-based), each resolving to
(podTemplate, replicas) written into the buffer status; fakepods.Registry then
materializes pending pods from the status. Both steps are merged here:
`translate_buffer` resolves and `fake_pods_for` materializes.
"""

from __future__ import annotations

import copy
import math

from kubernetes_autoscaler_tpu_torch.capacitybuffer.api import (
    PROVISIONING,
    READY_FOR_PROVISIONING,
    CapacityBuffer,
)
from kubernetes_autoscaler_tpu_torch.models.api import OwnerRef, Pod

# Annotation marking injected headroom pods (reference: fake pod names carry
# the capacity-buffer prefix; filters key on it).
FAKE_POD_ANNOTATION = "autoscaler.x-k8s.io/capacity-buffer-pod"


def translate_buffer(buf: CapacityBuffer) -> None:
    """Resolve the buffer spec into status (template + replicas + conditions).

    Mirrors the reference translator chain: an unresolvable spec sets
    ReadyForProvisioning=False with a reason instead of raising."""
    st = buf.status
    if buf.pod_template is not None:
        st.pod_template = buf.pod_template
        st.replicas = int(buf.replicas or 0)
    elif buf.scalable_ref is not None:
        w = buf.scalable_ref
        if w.template is None:
            st.conditions[READY_FOR_PROVISIONING] = "False"
            st.conditions["reason"] = "ScalableRefHasNoTemplate"
            return
        st.pod_template = w.template
        if buf.percentage is not None:
            st.replicas = max(
                math.ceil(w.replicas * buf.percentage / 100.0),
                buf.limits_min_replicas,
            )
        else:
            st.replicas = int(buf.replicas or w.replicas)
    else:
        st.conditions[READY_FOR_PROVISIONING] = "False"
        st.conditions["reason"] = "NoTemplateOrScalableRef"
        return
    if st.replicas <= 0:
        st.conditions[READY_FOR_PROVISIONING] = "False"
        st.conditions["reason"] = "ZeroReplicas"
        return
    st.conditions[READY_FOR_PROVISIONING] = "True"
    st.conditions[PROVISIONING] = "True"


def fake_pods_for(buf: CapacityBuffer, replicas: int | None = None) -> list[Pod]:
    """Materialize pending pods from a resolved buffer status (reference:
    capacitybuffer fakepods registry + simulator/fake/pod.go). `replicas`
    overrides the status count (the controller's per-loop quota clamp).

    The pod OBJECTS are cached per (generation, template, count) on the
    buffer: the loop injects them every tick, and stable object identity is
    what lets the incremental encoder (models/incremental.py) skip
    re-lowering unchanged headroom each loop."""
    st = buf.status
    if not st.ready() or st.pod_template is None:
        return []
    n = st.replicas if replicas is None else replicas
    # cache the LARGEST materialization per (generation, template): the
    # quota clamp moves loop-to-loop in busy clusters, and a prefix slice
    # keeps pods 0..n-1 identity-stable as it shrinks and grows (object
    # identity is what lets the incremental encoder skip re-lowering)
    cache_key = (buf.generation, st.pod_template)
    cached = getattr(buf, "_fake_pods_cache", None)
    if (cached is not None and cached[0][0] == cache_key[0]
            and cached[0][1] is cache_key[1] and len(cached[1]) >= n):
        return list(cached[1][:n])
    out = list(cached[1]) if (
        cached is not None and cached[0][0] == cache_key[0]
        and cached[0][1] is cache_key[1]) else []
    for i in range(len(out), n):
        p = copy.deepcopy(st.pod_template)
        p.name = f"capacity-buffer-{buf.name}-{i}"
        p.namespace = buf.namespace
        p.node_name = ""
        p.phase = "Pending"
        p.annotations[FAKE_POD_ANNOTATION] = buf.name
        # owned by the buffer so drain classification treats them as
        # replicated (they are re-creatable headroom, never blockers)
        p.owner = OwnerRef(kind="CapacityBuffer", name=buf.name,
                           uid=f"buffer-{buf.namespace}-{buf.name}")
        out.append(p)
    buf._fake_pods_cache = (cache_key, out)
    return list(out[:n])


def is_buffer_pod(pod: Pod) -> bool:
    return FAKE_POD_ANNOTATION in pod.annotations
