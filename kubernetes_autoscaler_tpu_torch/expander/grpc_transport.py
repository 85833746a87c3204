"""gRPC transport for the out-of-process expander.

Reference counterpart: expander/grpcplugin — `service Expander { rpc
BestOptions }` (protos/expander.proto:25-28), dialed with TLS cert + URL
flags. Here: the same wire contract over the repo's generic-bytes JSON gRPC
convention (sidecar/server.py). `serve_expander` hosts a user policy
function; `grpc_expander_call` returns the injectable callable GrpcFilter
expects (expander/strategies.py), so
`build_expander("grpc,least-waste", grpc_call=grpc_expander_call(port))`
reproduces the reference's chain-with-grpc-head composition.
"""

from __future__ import annotations

import json
from dataclasses import asdict

from kubernetes_autoscaler_tpu_torch.expander.strategies import Option

_SERVICE = "grpcplugin.Expander"


def _options_to_wire(options: list[Option]) -> list[dict]:
    return [asdict(o) for o in options]


def _options_from_wire(raw: list[dict]) -> list[Option]:
    return [Option(**o) for o in raw]


def serve_expander(best_options_fn, port: int = 0):
    """Host a policy `fn(list[Option]) -> list[Option]` as the gRPC service.

    Returns (server, bound_port)."""
    import grpc
    from concurrent.futures import ThreadPoolExecutor

    def handler(request: bytes, context):
        try:
            options = _options_from_wire(json.loads(request.decode() or "[]"))
            return json.dumps(_options_to_wire(best_options_fn(options))).encode()
        except Exception as e:
            return json.dumps({"error": str(e)}).encode()

    ident = lambda b: b
    server = grpc.server(ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        _SERVICE,
        {"BestOptions": grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=ident, response_serializer=ident)},
    ),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    return server, bound


def grpc_expander_call(port: int | None = None, url: str = "",
                       cert_file: str = ""):
    """The injectable callable for GrpcFilter: dials BestOptions.

    `url` + optional `cert_file` mirror the reference's --grpc-expander-url /
    --grpc-expander-cert (expander/grpcplugin); `port` is the local-test
    shorthand."""
    import grpc

    target = url or f"127.0.0.1:{port}"
    if cert_file:
        with open(cert_file, "rb") as f:
            creds = grpc.ssl_channel_credentials(f.read())
        channel = grpc.secure_channel(target, creds)
    else:
        channel = grpc.insecure_channel(target)
    rpc = channel.unary_unary(
        f"/{_SERVICE}/BestOptions",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )

    def call(options: list[Option]) -> list[Option]:
        out = json.loads(rpc(json.dumps(_options_to_wire(options)).encode()))
        if isinstance(out, dict) and out.get("error"):
            raise RuntimeError(out["error"])
        return _options_from_wire(out)

    return call
