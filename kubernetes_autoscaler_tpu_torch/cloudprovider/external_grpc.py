"""Out-of-process cloud provider over gRPC.

Reference counterpart: cloudprovider/externalgrpc — a full CloudProvider
whose every call crosses a gRPC boundary to an external provider service
(protos/externalgrpc.proto:28-98: NodeGroups, NodeGroupForNode, Refresh,
NodeGroupTargetSize/IncreaseSize/DeleteNodes/DecreaseTargetSize,
NodeGroupNodes, NodeGroupTemplateNodeInfo, NodeGroupGetOptions, GPULabel,
Pricing*, Cleanup). This is the reference's precedent for out-of-process
extension points and the shape the TPU sidecar boundary follows.

Two halves:
  * `serve_cloud_provider(provider)` — host ANY CloudProvider implementation
    as the gRPC service (the role of the user's external provider binary).
  * `ExternalGrpcProvider` — the in-process CloudProvider proxy the
    autoscaler is configured with; caches node-group listings and template
    node infos between Refresh calls exactly like the reference client
    (externalgrpc caches in cloud_provider.go / node_group.go).

Transport: JSON bodies over generic bytes RPCs (the repo-wide convention of
sidecar/server.py — no generated stubs, the wire names mirror the proto).
"""

from __future__ import annotations

import json
from dataclasses import asdict

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import (
    CloudProvider,
    InstanceStatus,
    NodeGroup,
    NodeGroupError,
    NodeGroupOptions,
    ResourceLimiter,
)
from kubernetes_autoscaler_tpu_torch.models.api import Node, Taint

_SERVICE = "clusterautoscaler.cloudprovider.v1.externalgrpc.CloudProvider"


# ---- Node (de)serialization -------------------------------------------------

def node_to_dict(node: Node) -> dict:
    return {
        "name": node.name,
        "labels": dict(node.labels),
        "annotations": dict(node.annotations),
        "capacity": dict(node.capacity),
        "allocatable": dict(node.allocatable),
        "taints": [asdict(t) for t in node.taints],
        "ready": node.ready,
        "unschedulable": node.unschedulable,
    }


def node_from_dict(d: dict) -> Node:
    return Node(
        name=d["name"],
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        capacity=dict(d.get("capacity", {})),
        allocatable=dict(d.get("allocatable", {})),
        taints=[Taint(**t) for t in d.get("taints", [])],
        ready=d.get("ready", True),
        unschedulable=d.get("unschedulable", False),
    )


def _options_to_dict(o: NodeGroupOptions | None) -> dict | None:
    return None if o is None else asdict(o)


# ---- server half ------------------------------------------------------------

class _ProviderService:
    """Adapts a CloudProvider to the wire methods."""

    def __init__(self, provider: CloudProvider):
        self.provider = provider

    def _group(self, gid: str) -> NodeGroup:
        for g in self.provider.node_groups():
            if g.id() == gid:
                return g
        raise NodeGroupError(f"unknown node group {gid!r}")

    # one method per proto rpc; each takes/returns a JSON-able dict
    def NodeGroups(self, req: dict) -> dict:
        return {"nodeGroups": [
            {"id": g.id(), "minSize": g.min_size(), "maxSize": g.max_size()}
            for g in self.provider.node_groups()
        ]}

    def NodeGroupForNode(self, req: dict) -> dict:
        g = self.provider.node_group_for_node(node_from_dict(req["node"]))
        if g is None:
            return {"nodeGroup": None}
        return {"nodeGroup": {"id": g.id(), "minSize": g.min_size(),
                              "maxSize": g.max_size()}}

    def Refresh(self, req: dict) -> dict:
        self.provider.refresh()
        return {}

    def Cleanup(self, req: dict) -> dict:
        self.provider.cleanup()
        return {}

    def GPULabel(self, req: dict) -> dict:
        return {"label": self.provider.gpu_label()}

    def PricingNodePrice(self, req: dict) -> dict:
        pricing = self.provider.pricing()
        if pricing is None:
            return {"error": "pricing not implemented"}
        return {"price": pricing.node_price(
            node_from_dict(req["node"]), req.get("startTime", 0.0),
            req.get("endTime", 0.0))}

    def NodeGroupTargetSize(self, req: dict) -> dict:
        return {"targetSize": self._group(req["id"]).target_size()}

    def NodeGroupIncreaseSize(self, req: dict) -> dict:
        self._group(req["id"]).increase_size(int(req["delta"]))
        return {}

    def NodeGroupDecreaseTargetSize(self, req: dict) -> dict:
        self._group(req["id"]).decrease_target_size(int(req["delta"]))
        return {}

    def NodeGroupDeleteNodes(self, req: dict) -> dict:
        nodes = [node_from_dict(n) for n in req["nodes"]]
        self._group(req["id"]).delete_nodes(nodes)
        return {}

    def NodeGroupNodes(self, req: dict) -> dict:
        return {"instances": [
            {"name": i.name, "state": i.state, "errorClass": i.error_class}
            for i in self._group(req["id"]).nodes()
        ]}

    def NodeGroupTemplateNodeInfo(self, req: dict) -> dict:
        return {"nodeInfo": node_to_dict(self._group(req["id"]).template_node_info())}

    def NodeGroupGetOptions(self, req: dict) -> dict:
        defaults = NodeGroupOptions(**req.get("defaults", {}))
        return {"options": _options_to_dict(self._group(req["id"]).get_options(defaults))}


_METHODS = [
    "NodeGroups", "NodeGroupForNode", "Refresh", "Cleanup", "GPULabel",
    "PricingNodePrice", "NodeGroupTargetSize", "NodeGroupIncreaseSize",
    "NodeGroupDecreaseTargetSize", "NodeGroupDeleteNodes", "NodeGroupNodes",
    "NodeGroupTemplateNodeInfo", "NodeGroupGetOptions",
]


def serve_cloud_provider(provider: CloudProvider, port: int = 0):
    """Host a CloudProvider as the external gRPC service.

    Returns (server, bound_port); caller starts/stops the server."""
    import grpc
    from concurrent.futures import ThreadPoolExecutor

    service = _ProviderService(provider)

    def make_handler(name):
        fn = getattr(service, name)

        def handler(request: bytes, context):
            try:
                return json.dumps(fn(json.loads(request.decode() or "{}"))).encode()
            except Exception as e:  # error goes on the wire, not the process
                return json.dumps({"error": str(e)}).encode()

        return grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)

    server = grpc.server(ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        _SERVICE, {m: make_handler(m) for m in _METHODS}),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    return server, bound


# ---- client half ------------------------------------------------------------

class _Client:
    def __init__(self, port: int):
        import grpc

        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")

    def call(self, method: str, body: dict) -> dict:
        rpc = self.channel.unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        out = json.loads(rpc(json.dumps(body).encode()))
        if isinstance(out, dict) and out.get("error"):
            raise NodeGroupError(out["error"])
        return out


class ExternalNodeGroup(NodeGroup):
    """Client-side proxy for one remote node group.

    Target size and template node info are cached until the provider's next
    Refresh (reference: externalgrpc/node_group.go caches TemplateNodeInfo)."""

    def __init__(self, client: _Client, gid: str, min_size: int, max_size: int):
        self._client = client
        self._id = gid
        self._min = min_size
        self._max = max_size
        self._cached_target: int | None = None
        self._cached_template: Node | None = None

    def invalidate(self) -> None:
        self._cached_target = None
        self._cached_template = None

    def id(self) -> str:
        return self._id

    def min_size(self) -> int:
        return self._min

    def max_size(self) -> int:
        return self._max

    def target_size(self) -> int:
        if self._cached_target is None:
            self._cached_target = int(
                self._client.call("NodeGroupTargetSize", {"id": self._id})["targetSize"])
        return self._cached_target

    def increase_size(self, delta: int) -> None:
        self._client.call("NodeGroupIncreaseSize", {"id": self._id, "delta": delta})
        self._cached_target = None

    def decrease_target_size(self, delta: int) -> None:
        self._client.call("NodeGroupDecreaseTargetSize", {"id": self._id, "delta": delta})
        self._cached_target = None

    def delete_nodes(self, nodes: list[Node]) -> None:
        self._client.call("NodeGroupDeleteNodes", {
            "id": self._id, "nodes": [node_to_dict(n) for n in nodes]})
        self._cached_target = None

    def nodes(self) -> list[InstanceStatus]:
        return [
            InstanceStatus(name=i["name"], state=i.get("state", ""),
                           error_class=i.get("errorClass", ""))
            for i in self._client.call("NodeGroupNodes", {"id": self._id})["instances"]
        ]

    def template_node_info(self) -> Node:
        if self._cached_template is None:
            self._cached_template = node_from_dict(
                self._client.call("NodeGroupTemplateNodeInfo", {"id": self._id})["nodeInfo"])
        return self._cached_template

    def get_options(self, defaults: NodeGroupOptions) -> NodeGroupOptions:
        out = self._client.call("NodeGroupGetOptions", {
            "id": self._id, "defaults": asdict(defaults)})["options"]
        return defaults if out is None else NodeGroupOptions(**out)


class ExternalGrpcProvider(CloudProvider):
    """CloudProvider whose implementation lives in another process.

    Node-group listing is cached between refresh() calls (the reference
    client does the same; the autoscaler calls Refresh once per loop)."""

    def __init__(self, port: int):
        self._client = _Client(port)
        self._by_id: dict[str, ExternalNodeGroup] = {}
        self._groups: list[ExternalNodeGroup] | None = None

    def name(self) -> str:
        return "externalgrpc"

    def node_groups(self) -> list[NodeGroup]:
        if self._groups is None:
            out = []
            for g in self._client.call("NodeGroups", {})["nodeGroups"]:
                # reuse group objects across refreshes so callers holding a
                # reference observe invalidated (fresh) caches, not stale ones
                existing = self._by_id.get(g["id"])
                if existing is not None:
                    existing._min = g["minSize"]
                    existing._max = g["maxSize"]
                    out.append(existing)
                else:
                    ng = ExternalNodeGroup(self._client, g["id"],
                                           g["minSize"], g["maxSize"])
                    self._by_id[g["id"]] = ng
                    out.append(ng)
            self._groups = out
        return list(self._groups)

    def node_group_for_node(self, node: Node) -> NodeGroup | None:
        out = self._client.call("NodeGroupForNode", {"node": node_to_dict(node)})
        g = out.get("nodeGroup")
        if not g:
            return None
        for existing in self.node_groups():
            if existing.id() == g["id"]:
                return existing
        # group absent from the listing (e.g. autoprovisioned): keep ONE
        # proxy object per id so refresh() invalidation reaches every holder
        ng = self._by_id.get(g["id"])
        if ng is None:
            ng = ExternalNodeGroup(self._client, g["id"], g["minSize"], g["maxSize"])
            self._by_id[g["id"]] = ng
        else:
            ng._min = g["minSize"]   # sizes come fresh from the server
            ng._max = g["maxSize"]
        return ng

    def gpu_label(self) -> str:
        return self._client.call("GPULabel", {})["label"]

    def get_resource_limiter(self) -> ResourceLimiter:
        return ResourceLimiter()

    def refresh(self) -> None:
        self._client.call("Refresh", {})
        for g in self._by_id.values():
            g.invalidate()
        self._groups = None

    def cleanup(self) -> None:
        self._client.call("Cleanup", {})
