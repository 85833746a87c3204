"""The last host-only modules of the port (held copies): the balancer, the
addon-resizer nanny, the kwok/kubemark provider, pod injection and the typed
errors, on the cases of the reference's tests (tests/test_balancer_nanny.py,
the kwok cases of tests/test_cloudproviders.py, the pod-injection cases of
tests/test_capacitybuffer.py, the errors case of
tests/test_status_observability.py), run on the port's objects; the loops
run on the CPU.
"""

from kubernetes_autoscaler_tpu_torch.balancer.balancer import (
    BalancerSpec,
    TargetSpec,
    distribute,
)
from kubernetes_autoscaler_tpu_torch.cloudprovider.kwok import KwokCluster
from kubernetes_autoscaler_tpu_torch.config.options import (
    AutoscalingOptions,
    NodeGroupDefaults,
)
from kubernetes_autoscaler_tpu_torch.core.static_autoscaler import (
    StaticAutoscaler,
)
from kubernetes_autoscaler_tpu_torch.models.api import Workload
from kubernetes_autoscaler_tpu_torch.nanny.nanny import (
    Nanny,
    ResourceEstimatorSpec,
    estimate,
    needs_update,
)
from kubernetes_autoscaler_tpu_torch.processors.podinjection import (
    PodInjectionProcessor,
    injected_pods_for,
)
from kubernetes_autoscaler_tpu_torch.processors.processors import (
    AutoscalingProcessors,
)
from kubernetes_autoscaler_tpu_torch.utils.fakecluster import FakeCluster
from kubernetes_autoscaler_tpu_torch.utils.testing import (
    build_test_node,
    build_test_pod,
)


def test_proportional_split():
    spec = BalancerSpec(name="b", replicas=10, targets=[
        TargetSpec("a", proportion=3), TargetSpec("b", proportion=1)])
    out = distribute(spec)
    assert out == {"a": 8, "b": 2}  # 7.5 rounds via largest remainder


def test_proportional_respects_max():
    spec = BalancerSpec(name="b", replicas=10, targets=[
        TargetSpec("a", proportion=3, max_replicas=4),
        TargetSpec("b", proportion=1)])
    out = distribute(spec)
    assert out["a"] == 4 and out["b"] == 6


def test_priority_fills_in_order():
    spec = BalancerSpec(name="b", replicas=7, policy="priority", targets=[
        TargetSpec("cheap", priority=10, max_replicas=5),
        TargetSpec("fallback", priority=1)])
    out = distribute(spec)
    assert out == {"cheap": 5, "fallback": 2}


def test_min_replicas_honored():
    spec = BalancerSpec(name="b", replicas=6, targets=[
        TargetSpec("a", min_replicas=2, proportion=1),
        TargetSpec("b", min_replicas=1, proportion=1)])
    out = distribute(spec)
    assert out["a"] >= 2 and out["b"] >= 1 and sum(out.values()) == 6


def test_fallback_avoids_problem_domain():
    spec = BalancerSpec(name="b", replicas=4, targets=[
        TargetSpec("bad", proportion=1), TargetSpec("good", proportion=1)])
    out = distribute(spec, problem_domains={"bad"})
    assert out == {"bad": 0, "good": 4}  # unhealthy domain scaled to zero


def test_nanny_formula_and_threshold():
    spec = ResourceEstimatorSpec(
        base={"cpu": 0.1, "memory": 200e6},
        extra_per_node={"cpu": 0.001, "memory": 2e6},
    )
    want = estimate(spec, 1000)
    assert abs(want["cpu"] - 1.1) < 1e-9
    assert abs(want["memory"] - 2.2e9) < 1e-3
    # within 10%: no update
    assert not needs_update(spec, {"cpu": 1.05, "memory": 2.1e9}, 1000)
    assert needs_update(spec, {"cpu": 0.5, "memory": 2.1e9}, 1000)


def test_nanny_patches_when_drifted():
    patched = []
    n = Nanny(ResourceEstimatorSpec(base={"cpu": 0.1},
                                    extra_per_node={"cpu": 0.001}),
              patch_resources=patched.append)
    assert n.poll_once(2000, {"cpu": 0.5})
    assert abs(patched[0]["cpu"] - 2.1) < 1e-9
    assert not n.poll_once(2000, patched[0])


def make_options(**kw):
    base = dict(
        node_shape_bucket=16, group_shape_bucket=16, max_new_nodes_static=32,
        max_pods_per_node=32, drain_chunk=8,
        node_group_defaults=NodeGroupDefaults(
            scale_down_unneeded_time_s=0.0, scale_down_unready_time_s=0.0),
    )
    base.update(kw)
    return AutoscalingOptions(**base)


def test_kwok_boot_delay_counts_upcoming():
    """Instances in flight register late; the registry must report them as
    upcoming so the next loop doesn't double-scale."""
    kwok = KwokCluster(boot_delay_s=30.0)
    tmpl = build_test_node("tmpl", cpu_milli=4000, mem_mib=8192)
    kwok.add_node_group("ng1", tmpl, min_size=0, max_size=10)
    for i in range(4):
        kwok.add_pod(build_test_pod(f"p{i}", cpu_milli=1500, mem_mib=512,
                                    owner_name="rs"))
    a = StaticAutoscaler(kwok.provider, kwok, options=make_options(),
                         eviction_sink=kwok, device="cpu")
    kwok.advance_to(1000.0)
    st1 = a.run_once(now=1000.0)
    assert st1.scale_up.increases == {"ng1": 2}
    assert len(kwok.nodes) == 0                       # still booting
    assert a.cluster_state.upcoming_nodes() == {"ng1": 2}
    # second loop before boot completes: no double scale-up
    kwok.advance_to(1010.0)
    st2 = a.run_once(now=1010.0)
    assert st2.scale_up is None or not st2.scale_up.scaled_up
    # boot completes; pods land
    kwok.advance_to(1035.0)
    assert len(kwok.nodes) == 2
    st3 = a.run_once(now=1035.0)
    assert st3.pending_pods == 0


def test_kwok_failed_boot_reaped_and_backed_off():
    kwok = KwokCluster(boot_delay_s=5.0)
    tmpl = build_test_node("tmpl", cpu_milli=4000, mem_mib=8192)
    kwok.add_node_group("ng1", tmpl, min_size=0, max_size=10)
    kwok.fail_next("ng1", 2)
    for i in range(4):
        kwok.add_pod(build_test_pod(f"p{i}", cpu_milli=1500, mem_mib=512,
                                    owner_name="rs"))
    a = StaticAutoscaler(kwok.provider, kwok, options=make_options(),
                         eviction_sink=kwok, device="cpu")
    kwok.advance_to(1000.0)
    st1 = a.run_once(now=1000.0)
    assert st1.scale_up.increases == {"ng1": 2}
    g = kwok.provider.node_groups()[0]
    assert g.target_size() == 2
    # next loop: errored instances reaped (target back to 0), group backed off
    kwok.advance_to(1010.0)
    a.run_once(now=1010.0)
    assert g.target_size() == 0
    assert not any(i.error_class for i in g.nodes())
    assert a.cluster_state.backoff.is_backed_off("ng1", 1011.0)
    # once backoff expires, scale-up is attempted again
    later = 1010.0 + a.options.initial_node_group_backoff_s + 1.0
    kwok.advance_to(later)
    st3 = a.run_once(now=later)
    assert st3.scale_up is not None and st3.scale_up.scaled_up


def test_kubemark_scale_claim():
    """The GA scale claim (FAQ.md:148): 1000 nodes x 30 pods/node RunOnce,
    on the port's loop (CPU)."""
    n_nodes = 1000
    kwok = KwokCluster()
    tmpl = build_test_node("tmpl", cpu_milli=8000, mem_mib=65536, pods=110)
    g = kwok.add_node_group("ng1", tmpl, min_size=0, max_size=2 * n_nodes)
    g.increase_size(n_nodes)
    kwok.advance_to(0.0)
    assert len(kwok.nodes) == n_nodes
    kwok.saturate(pods_per_node=30, cpu_milli=250)   # 7500m of 8000m used
    assert len(kwok.pods) == 30 * n_nodes
    # add pending load requiring ~5% more nodes
    extra = max(n_nodes // 20, 1) * 8
    for i in range(extra):
        kwok.add_pod(build_test_pod(f"pend{i}", cpu_milli=900, mem_mib=512,
                                    owner_name="pend-rs"))
    a = StaticAutoscaler(
        kwok.provider, kwok,
        options=make_options(node_shape_bucket=256,
                             max_new_nodes_static=max(n_nodes // 8, 32),
                             max_pods_per_node=64),
        eviction_sink=kwok, device="cpu")
    status = a.run_once(now=100.0)
    assert status.scale_up is not None and status.scale_up.scaled_up
    added = sum(status.scale_up.increases.values())
    # 8 pending pods of 900m fit a fresh 8-CPU node -> extra/8 new nodes
    assert added == extra // 8
    kwok.advance_to(100.0)   # zero boot delay: instances register on tick
    assert len(kwok.nodes) == n_nodes + added


def test_injected_pods_fill_replica_gap():
    w = Workload("Job", "batch", uid="u1", replicas=5,
                 template=build_test_pod("tmpl", cpu_milli=100))
    existing = [
        build_test_pod("p0", owner_name="batch", owner_kind="Job"),
        build_test_pod("p1", owner_name="batch", owner_kind="Job"),
    ]
    fakes = injected_pods_for(w, existing)
    assert len(fakes) == 3
    assert fakes[0].owner.uid == "u1"
    # terminal pods don't count toward the existing total
    existing[0].phase = "Succeeded"
    assert len(injected_pods_for(w, existing)) == 4
    # no gap -> no injection
    w.replicas = 2
    existing[0].phase = "Running"
    assert injected_pods_for(w, existing) == []


def _opts(**kw):
    base = dict(
        scale_down_delay_after_add_s=0.0,
        node_shape_bucket=16, group_shape_bucket=16,
        max_new_nodes_static=32, max_pods_per_node=32, drain_chunk=8,
        node_group_defaults=NodeGroupDefaults(
            scale_down_unneeded_time_s=0.0, scale_down_unready_time_s=0.0),
    )
    base.update(kw)
    return AutoscalingOptions(**base)


def test_runonce_pod_injection_prescales():
    """A Job with replicas=6 but only 1 created pod injects 5 fakes."""
    fake = FakeCluster()
    tmpl = build_test_node("tmpl", cpu_milli=4000, mem_mib=8192)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=10)
    fake.add_existing_node("ng1", build_test_node("n1", cpu_milli=4000, mem_mib=8192))
    fake.add_pod(build_test_pod("real-0", cpu_milli=1800, mem_mib=256,
                                owner_name="batch", owner_kind="Job"))
    fake.add_workload(Workload(
        "Job", "batch", uid="u1", replicas=6,
        template=build_test_pod("tmpl-pod", cpu_milli=1800, mem_mib=256,
                                owner_name="batch", owner_kind="Job"),
    ))
    procs = AutoscalingProcessors.default()
    procs.pod_list_processors.append(PodInjectionProcessor())
    a = StaticAutoscaler(fake.provider, fake, options=_opts(),
                         processors=procs, eviction_sink=fake, device="cpu")
    status = a.run_once(now=1000.0)
    assert status.scale_up is not None and status.scale_up.scaled_up
    # 6 pods x 1800m, 2 per 4-CPU node -> 3 nodes total, 1 exists -> +2
    assert status.scale_up.increases == {"ng1": 2}


def test_typed_errors():
    from kubernetes_autoscaler_tpu_torch.utils.errors import (
        AutoscalerError,
        ErrorType,
        to_autoscaler_error,
    )

    e = AutoscalerError(ErrorType.TRANSIENT, "cloud timeout")
    assert e.retriable
    wrapped = e.prefixed("scale-up ng1: ")
    assert wrapped.error_type is ErrorType.TRANSIENT
    assert "scale-up ng1: cloud timeout" in str(wrapped)
    same = to_autoscaler_error(ErrorType.INTERNAL, e)
    assert same is e
    conv = to_autoscaler_error(ErrorType.INTERNAL, ValueError("boom"))
    assert conv.error_type is ErrorType.INTERNAL and not conv.retriable
