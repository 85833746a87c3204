"""The port's gRPC expander, external gRPC cloud provider and async
node-group creation, on the port's control loop (`device="cpu"`).

Mirrors tests/test_expanders.py (the expander round trip and fail-open),
tests/test_cloudproviders.py (the external provider's surface and a whole
RunOnce over it) and tests/test_async_nodegroups.py (a slow creation that
does not block the loop and counts as upcoming; the synchronous path with
the flag off). The RunOnce over the external provider is also run by the
JAX package's loop on the same world: the decision digests must be equal.

The gRPC tests need grpcio; machines without it skip them. Every async
creator is drained with `wait_idle()` and every gate is released with a
timeout, so no worker outlives its test.
"""

from __future__ import annotations

import importlib
import threading
import time

import pytest

from torch_parity import PORT, REF

PKG = {"jax": REF, "torch": PORT}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def _options(pkg: str, **kw):
    o = _mod(pkg, "config.options")
    base = dict(
        scan_interval_s=1.0,
        scale_down_delay_after_add_s=0.0,
        scale_down_delay_after_failure_s=0.0,
        node_shape_bucket=16, group_shape_bucket=16,
        max_new_nodes_static=32, max_pods_per_node=32, drain_chunk=8,
        node_group_defaults=o.NodeGroupDefaults(
            scale_down_unneeded_time_s=0.0, scale_down_unready_time_s=0.0),
    )
    base.update(kw)
    return o.AutoscalingOptions(**base)


def _autoscaler(pkg: str, provider, fake, **kw):
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return _mod(pkg, "core.static_autoscaler").StaticAutoscaler(
        provider, fake, options=_options(pkg, **kw), eviction_sink=fake,
        registry=_mod(pkg, "metrics.metrics").Registry(), **extra)


# ---- the gRPC expander -------------------------------------------------


def _expander_options():
    Option = _mod("torch", "expander.strategies").Option
    return [
        Option(group_index=0, group_id="small-pool", node_count=4,
               pod_count=10, waste=0.10, price=4.0),
        Option(group_index=1, group_id="big-pool", node_count=2,
               pod_count=10, waste=0.30, price=6.0),
        Option(group_index=2, group_id="gpu-pool", node_count=3,
               pod_count=12, waste=0.20, price=30.0),
    ]


def test_grpc_expander_round_trip():
    pytest.importorskip("grpc")
    gt = _mod("torch", "expander.grpc_transport")
    build_expander = _mod("torch", "expander.strategies").build_expander

    def policy(options):
        best = min(o.price for o in options)
        return [o for o in options if o.price == best]

    server, port = gt.serve_expander(policy)
    server.start()
    try:
        e = build_expander("grpc", grpc_call=gt.grpc_expander_call(port))
        assert e.best_option(_expander_options()).group_id == "small-pool"
    finally:
        server.stop(None)


def test_grpc_expander_fail_open():
    pytest.importorskip("grpc")
    gt = _mod("torch", "expander.grpc_transport")
    build_expander = _mod("torch", "expander.strategies").build_expander
    # a dead endpoint: the filter passes every option through
    e = build_expander("grpc,least-nodes", grpc_call=gt.grpc_expander_call(1))
    assert e.best_option(_expander_options()).group_id == "big-pool"


def test_loop_consults_the_grpc_expander():
    """`--grpc-expander-url` with a `grpc` expander: the loop dials the
    policy service and scales the group it picks."""
    pytest.importorskip("grpc")
    gt = _mod("torch", "expander.grpc_transport")
    t = _mod("torch", "utils.testing")
    fake = _mod("torch", "utils.fakecluster").FakeCluster()
    fake.add_node_group("cheap", t.build_test_node(
        "t-cheap", cpu_milli=4000, mem_mib=8192), min_size=0, max_size=10)
    fake.add_node_group("dear", t.build_test_node(
        "t-dear", cpu_milli=4000, mem_mib=8192), min_size=0, max_size=10)
    for i in range(4):
        fake.add_pod(t.build_test_pod(f"p{i}", cpu_milli=1500, mem_mib=512,
                                      owner_name="rs"))
    asked = []

    def policy(options):
        asked.append(sorted(o.group_id for o in options))
        return [o for o in options if o.group_id == "dear"]

    server, port = gt.serve_expander(policy)
    server.start()
    try:
        a = _autoscaler("torch", fake.provider, fake, expander="grpc",
                        grpc_expander_url=f"127.0.0.1:{port}")
        st = a.run_once(now=1000.0)
    finally:
        server.stop(None)
    assert asked and asked[0] == ["cheap", "dear"]
    assert st.scale_up is not None and st.scale_up.increases == {"dear": 2}


# ---- the external gRPC provider ----------------------------------------


def _grpc_world(pkg: str):
    t = _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node(
        "tmpl", cpu_milli=4000, mem_mib=8192), min_size=0, max_size=10)
    ext = _mod(pkg, "cloudprovider.external_grpc")
    server, port = ext.serve_cloud_provider(fake.provider)
    server.start()
    return fake, ext.ExternalGrpcProvider(port), server


def test_external_grpc_surface():
    pytest.importorskip("grpc")
    fake, ext, server = _grpc_world("torch")
    try:
        groups = ext.node_groups()
        assert [g.id() for g in groups] == ["ng1"]
        g = groups[0]
        assert (g.min_size(), g.max_size(), g.target_size()) == (0, 10, 0)
        assert g.template_node_info().capacity["cpu"] == 4.0
        g.increase_size(2)
        assert g.target_size() == 2      # the cache is dropped on a mutation
        assert len(fake.nodes) == 2      # materialized behind the service
        nd = list(fake.nodes.values())[0]
        back = ext.node_group_for_node(nd)
        assert back is not None and back.id() == "ng1"
        g.delete_nodes([nd])
        assert g.target_size() == 1
    finally:
        server.stop(None)


def test_external_grpc_full_runonce_matches_jax_loop():
    """Two RunOnces with every cloud call over the gRPC boundary, on the
    port's loop and on the JAX package's: the same scale-up, and the
    decision digests equal loop for loop."""
    pytest.importorskip("grpc")
    runs = {}
    for pkg in ("jax", "torch"):
        fake, ext, server = _grpc_world(pkg)
        t = _mod(pkg, "utils.testing")
        rj = _mod(pkg, "replay.journal")
        try:
            for i in range(4):
                fake.add_pod(t.build_test_pod(f"p{i}", cpu_milli=1500,
                                              mem_mib=512, owner_name="rs"))
            a = _autoscaler(pkg, ext, fake)
            a.capture_verdicts = True
            rows = []
            for loop in range(2):
                st = a.run_once(now=1000.0 + 10.0 * loop)
                rows.append((rj.surface_digests(rj.collect_outputs(a, st)),
                             st.fused_mode,
                             dict(st.scale_up.increases)
                             if st.scale_up is not None else None))
            insts = ext.node_groups()[0].nodes()
            assert len(insts) == 2 and all(i.name for i in insts)
            runs[pkg] = (rows, len(fake.nodes))
        finally:
            server.stop(None)
    assert runs["torch"][0][0][2] == {"ng1": 2}
    assert runs["torch"] == runs["jax"]


# ---- async node-group creation -----------------------------------------


class _Gate:
    """The release of the slow create, shared by the groups of one world."""

    def __init__(self):
        self.event = threading.Event()
        self.calls = 0


def _async_world(gate: _Gate):
    """tests/test_async_nodegroups._world on the port: an autoprovisioned
    machine type whose create() blocks until `gate` is released, a seed
    group the pending pods do not fit."""
    tp = _mod("torch", "cloudprovider.test_provider")
    t = _mod("torch", "utils.testing")

    class SlowCreateGroup(tp.TestNodeGroup):
        def create(self):
            gate.calls += 1
            assert gate.event.wait(timeout=30), "the gate was never released"
            return super().create()

    fake = _mod("torch", "utils.fakecluster").FakeCluster()
    fake.provider.add_machine_type("m-slow", t.build_test_node(
        "tmpl", cpu_milli=4000, mem_mib=8192))
    orig = fake.provider.new_node_group

    def slow_new_node_group(machine_type, max_size=1000):
        g = orig(machine_type, max_size)
        slow = SlowCreateGroup(g._id, 0, max_size, 0, g._template,
                               fake.provider, None, g.price_per_node)
        slow._exists = False
        slow._autoprovisioned = True
        return slow

    fake.provider.new_node_group = slow_new_node_group
    seed = t.build_test_node("seed-tmpl", cpu_milli=100, mem_mib=256)
    fake.add_node_group("ng-seed", seed, min_size=1, max_size=1)
    fake.add_existing_node(
        "ng-seed", t.build_test_node("seed-0", cpu_milli=100, mem_mib=256))
    for i in range(4):
        fake.add_pod(t.build_test_pod(f"p{i}", cpu_milli=1500, mem_mib=512,
                                      owner_name="rs"))
    return fake


def test_slow_creation_does_not_block_loop_and_counts_upcoming():
    gate = _Gate()
    fake = _async_world(gate)
    a = _autoscaler("torch", fake.provider, fake,
                    node_autoprovisioning_enabled=True,
                    async_node_group_creation=True)
    try:
        t0 = time.monotonic()
        status = a.run_once(now=1000.0)
        loop_s = time.monotonic() - t0
        assert status.scale_up is not None and status.scale_up.scaled_up
        assert loop_s < 15, f"the loop blocked on the creation ({loop_s} s)"
        assert gate.calls == 1
        gid = next(iter(status.scale_up.increases))
        assert a.async_creator.is_upcoming(gid)

        # a second loop while the creation is still in flight: the promised
        # capacity is injected as upcoming, so the same pods trigger no
        # second scale-up and no second create
        status2 = a.run_once(now=1010.0)
        assert status2.pending_pods == 0
        assert status2.scale_up is None
        assert gate.calls == 1
    finally:
        gate.event.set()
        a.async_creator.wait_idle()
    assert not a.async_creator.is_upcoming(gid)
    assert not a.async_creator.errors
    g = next(x for x in fake.provider.node_groups() if x.id() == gid)
    assert g.exist()
    assert g.target_size() == status.scale_up.increases[gid]
    assert len(fake.provider.nodes_of(gid)) == g.target_size()


def test_sync_creation_still_works_when_flag_off():
    gate = _Gate()
    gate.event.set()            # the synchronous path must not block
    fake = _async_world(gate)
    a = _autoscaler("torch", fake.provider, fake,
                    node_autoprovisioning_enabled=True)
    status = a.run_once(now=1000.0)
    assert status.scale_up is not None and status.scale_up.scaled_up
    assert a.async_creator is None
    assert gate.calls == 1
    assert len(fake.nodes) > 0


def test_both_former_refusals_construct_together():
    """A gRPC expander URL with a `grpc` expander and async node-group
    creation, at once: the loop builds both and runs (the endpoint is dead,
    so the expander fails open)."""
    pytest.importorskip("grpc")
    gate = _Gate()
    fake = _async_world(gate)
    a = _autoscaler("torch", fake.provider, fake,
                    node_autoprovisioning_enabled=True,
                    async_node_group_creation=True,
                    expander="grpc,least-waste",
                    grpc_expander_url="127.0.0.1:1")
    try:
        assert a.async_creator is not None
        assert a.scale_up_orchestrator.async_creator is a.async_creator
        status = a.run_once(now=1000.0)
        assert status.scale_up is not None and status.scale_up.scaled_up
    finally:
        gate.event.set()
        a.async_creator.wait_idle()
