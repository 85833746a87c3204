"""CLI flags → AutoscalingOptions.

Reference counterpart: config/flags/flags.go (~125 pflag definitions feeding
config.AutoscalingOptions; auto-documented into FAQ.md:1000+). Flag names keep
the reference's kebab-case spelling so operator muscle memory transfers;
durations accept Go-style strings ("10s", "5m", "1h30m") and plain seconds.

Flags without behavioral force in this framework (cloud-SDK endpoints,
kubeconfig plumbing) are accepted-and-ignored via `--ignore-unknown` parity
mode rather than erroring, mirroring how operators carry flag soups between
autoscaler versions.
"""

from __future__ import annotations

import argparse
import re

from kubernetes_autoscaler_tpu_torch.config.options import (
    AutoscalingOptions,
    NodeGroupDefaults,
)

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")
_UNIT_S = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}


def parse_duration_s(text: str) -> float:
    """Go duration ("1h30m", "10s") or bare seconds ("90")."""
    text = text.strip()
    try:
        return float(text)
    except ValueError:
        pass
    total, pos = 0.0, 0
    for m in _DURATION_RE.finditer(text):
        if m.start() != pos:
            raise ValueError(f"bad duration {text!r}")
        total += float(m.group(1)) * _UNIT_S[m.group(2)]
        pos = m.end()
    if pos != len(text) or pos == 0:
        raise ValueError(f"bad duration {text!r}")
    return total


def _bool(text: str) -> bool:
    return text.lower() in ("1", "true", "t", "yes", "y")


def build_parser() -> argparse.ArgumentParser:
    from kubernetes_autoscaler_tpu_torch.version import version_string

    p = argparse.ArgumentParser(
        prog="kubernetes-autoscaler-tpu",
        description="TPU-native cluster autoscaling framework",
    )
    p.add_argument("--version", action="version", version=version_string())
    dur = parse_duration_s

    # loop (reference flags.go: --scan-interval)
    p.add_argument("--scan-interval", type=dur, default=10.0)

    # scale-up
    p.add_argument("--estimator", default="binpacking")
    p.add_argument("--expander", default="least-waste")
    p.add_argument("--max-nodes-per-scaleup", type=int, default=1000)
    p.add_argument("--max-nodes-total", type=int, default=0)
    p.add_argument("--cores-total", default="0:320000",
                   help="min:max cluster cores (reference --cores-total)")
    p.add_argument("--memory-total", default="0:6400000",
                   help="min:max cluster memory in GiB")
    p.add_argument("--gpu-total", default="0:0",
                   help="min:max cluster GPUs (0:0 = unlimited)")
    p.add_argument("--balance-similar-node-groups", type=_bool, default=False)
    p.add_argument("--balancing-label", action="append", default=[])
    p.add_argument("--balancing-ignore-label", action="append", default=[])
    p.add_argument("--max-allocatable-difference-ratio", type=float, default=0.05)
    p.add_argument("--max-free-difference-ratio", type=float, default=0.05)
    p.add_argument("--memory-difference-ratio", type=float, default=0.015)
    p.add_argument("--new-pod-scale-up-delay", type=dur, default=0.0)
    p.add_argument("--expendable-pods-priority-cutoff", type=int, default=-10)
    p.add_argument("--max-binpacking-time", type=dur, default=300.0)
    p.add_argument("--enforce-node-group-min-size", type=_bool, default=False)
    p.add_argument("--parallel-scale-up", type=_bool, default=True)
    p.add_argument("--scale-up-from-zero", type=_bool, default=True)
    p.add_argument("--scale-from-unschedulable", type=_bool, default=False)
    p.add_argument("--async-node-groups", type=_bool, default=False)
    p.add_argument("--salvo-scale-up", type=_bool, default=False)
    p.add_argument("--salvo-scale-up-budget", type=dur, default=2.0)
    p.add_argument("--node-autoprovisioning-enabled", type=_bool, default=False)
    p.add_argument("--max-autoprovisioned-node-group-count", type=int, default=15)
    p.add_argument("--pod-injection-limit", type=int, default=5000)

    # scale-down
    p.add_argument("--scale-down-enabled", type=_bool, default=True)
    p.add_argument("--scale-down-delay-after-add", type=dur, default=600.0)
    p.add_argument("--scale-down-delay-after-delete", type=dur, default=0.0)
    p.add_argument("--scale-down-delay-after-failure", type=dur, default=180.0)
    p.add_argument("--scale-down-unneeded-time", type=dur, default=600.0)
    p.add_argument("--scale-down-unready-time", type=dur, default=1200.0)
    p.add_argument("--scale-down-utilization-threshold", type=float, default=0.5)
    p.add_argument("--scale-down-gpu-utilization-threshold", type=float, default=0.5)
    p.add_argument("--scale-down-candidates-pool-ratio", type=float, default=1.0)
    p.add_argument("--scale-down-candidates-pool-min-count", type=int, default=50)
    p.add_argument("--scale-down-simulation-timeout", type=dur, default=30.0)
    p.add_argument("--max-scale-down-parallelism", type=int, default=10)
    p.add_argument("--max-drain-parallelism", type=int, default=1)
    p.add_argument("--max-empty-bulk-delete", type=int, default=10)
    p.add_argument("--max-graceful-termination-sec", type=int, default=600)
    p.add_argument("--max-pod-eviction-time", type=float, default=120.0,
                   help="seconds CA keeps retrying a failed pod eviction")
    p.add_argument("--force-delete-unregistered-nodes", type=_bool,
                   default=False)
    p.add_argument("--async-node-deletion", type=_bool, default=False,
                   help="run evict+delete on a background executor (the "
                        "reference always detaches; default off because "
                        "in-process sinks complete instantly)")
    p.add_argument("--skip-nodes-with-system-pods", type=_bool, default=True)
    p.add_argument("--skip-nodes-with-local-storage", type=_bool, default=True)
    p.add_argument("--skip-nodes-with-custom-controller-pods", type=_bool,
                   default=False)
    p.add_argument("--min-replica-count", type=int, default=0)
    p.add_argument("--scale-down-unready-enabled", type=_bool, default=True)
    p.add_argument("--scale-down-non-empty-candidates-count", type=int, default=0,
                   help="0 = unlimited (device sweep is exhaustive; the "
                        "reference's 30 guards a serial simulator)")
    p.add_argument("--max-bulk-soft-taint-count", type=int, default=10)
    p.add_argument("--max-bulk-soft-taint-time", type=dur, default=3.0)
    p.add_argument("--node-deletion-candidate-ttl", type=dur, default=1800.0)
    p.add_argument("--unremovable-node-recheck-timeout", type=dur, default=300.0)
    p.add_argument("--cordon-node-before-terminating", type=_bool, default=False)
    p.add_argument("--daemonset-eviction-for-empty-nodes", type=_bool, default=False)
    p.add_argument("--daemonset-eviction-for-occupied-nodes", type=_bool, default=True)
    p.add_argument("--ignore-mirror-pods-utilization", type=_bool, default=False)

    # cluster health
    p.add_argument("--max-total-unready-percentage", type=float, default=45.0)
    p.add_argument("--ok-total-unready-count", type=int, default=3)
    p.add_argument("--max-node-startup-time", type=dur, default=900.0)
    p.add_argument("--max-node-provision-time", type=dur, default=900.0)
    p.add_argument("--unregistered-node-removal-time", type=dur, default=900.0)

    # backoff
    p.add_argument("--initial-node-group-backoff-duration", type=dur, default=300.0)
    p.add_argument("--max-node-group-backoff-duration", type=dur, default=1800.0)
    p.add_argument("--node-group-backoff-reset-timeout", type=dur, default=10800.0)

    # process / observability (reference: main.go flags)
    p.add_argument("--address", default=":8085",
                   help="metrics/healthz listen address")
    p.add_argument("--leader-elect", type=_bool, default=True)
    p.add_argument("--leader-elect-lease-file", default="/tmp/ka-tpu-leader.lock")
    p.add_argument("--profiling", type=_bool, default=False)
    p.add_argument("--ignore-daemonsets-utilization", type=_bool, default=False)
    p.add_argument("--emit-per-nodegroup-metrics", type=_bool, default=False)
    p.add_argument("--debugging-snapshot-enabled", type=_bool, default=False)
    p.add_argument("--write-status-configmap", type=_bool, default=True)
    p.add_argument("--status-config-map-name", default="cluster-autoscaler-status")
    p.add_argument("--max-inactivity", type=dur, default=600.0)
    p.add_argument("--max-failing-time", type=dur, default=900.0)
    p.add_argument("--max-startup-time", type=dur, default=1200.0)
    p.add_argument("--grpc-expander-url", default="")
    p.add_argument("--grpc-expander-cert", default="")

    # subsystem gates
    p.add_argument("--enable-provisioning-requests", type=_bool, default=True)
    p.add_argument("--capacity-buffer-controller-enabled", type=_bool, default=True)
    p.add_argument("--capacity-buffer-pod-injection-enabled", type=_bool, default=True)
    p.add_argument("--capacity-quotas-enabled", type=_bool, default=True)
    p.add_argument("--enable-dynamic-resource-allocation", type=_bool, default=True)
    p.add_argument("--enable-csi-node-aware-scheduling", type=_bool, default=True)
    p.add_argument("--node-removal-latency-tracking-enabled", type=_bool, default=True)

    # flight recorder / trace layer (no reference analog)
    p.add_argument("--flight-recorder-capacity", type=int, default=8,
                   help="ring-buffer size of retained per-loop traces "
                        "(0 disables the tracer entirely)")
    p.add_argument("--flight-recorder-dir", default="",
                   help="directory for auto-persisted Perfetto dumps on a "
                        "loop-budget breach / raise / armed /snapshotz "
                        "(empty = keep the ring in memory only)")
    p.add_argument("--loop-wallclock-budget", type=dur, default=0.0,
                   help="per-RunOnce wall-clock SLO; a breach dumps the "
                        "flight recorder (0 = no budget)")
    p.add_argument("--journal-dir", default="",
                   help="record every RunOnce into a deterministic flight "
                        "journal under this directory (snapshot+delta "
                        "records; replay with `python -m "
                        "kubernetes_autoscaler_tpu_torch.replay`); empty = off")
    p.add_argument("--journal-max-mb", type=float, default=64.0,
                   help="size bound for the retained journal; older files "
                        "rotate out with drop accounting")
    p.add_argument("--lineage-ring", type=_bool, default=True,
                   help="live decision-lineage ring: the bounded "
                        "per-object provenance view served on /whyz, "
                        "/snapshotz and the sidecar Explain RPC "
                        "(lineage/index.py; pure observer)")
    p.add_argument("--lineage-ring-objects", type=int, default=512,
                   help="objects the lineage ring retains (LRU)")
    p.add_argument("--lineage-ring-loops", type=int, default=128,
                   help="loop rows the lineage ring retains")

    # backend supervisor / degraded-mode control loop (core/supervisor.py;
    # no reference analog — the Go autoscaler has no accelerator to lose)
    p.add_argument("--backend-phase-deadline", type=dur, default=0.0,
                   help="wall-clock budget per guarded device phase "
                        "(encode/dispatch/fetch); a hung op aborts the "
                        "loop and marks the backend suspect (0 = inline "
                        "guards, no watchdog)")
    p.add_argument("--backend-probe-deadline", type=dur, default=5.0,
                   help="deadline for the recovery probe's device round "
                        "trip")
    p.add_argument("--backend-suspect-threshold", type=int, default=2,
                   help="consecutive guarded-phase failures before the "
                        "suspect state escalates to degraded")
    p.add_argument("--backend-recovery-probes", type=int, default=2,
                   help="consecutive probe successes required to leave "
                        "degraded")
    p.add_argument("--backend-recovery-hysteresis", type=int, default=2,
                   help="clean loops in recovering before scale-down "
                        "re-enables (flap damping)")
    p.add_argument("--device-ledger", type=_bool, default=True,
                   help="HBM residency ledger: owner/tenant-tagged census "
                        "of resident device arrays, reconciled against "
                        "device memory_stats each loop (metrics/device.py)")
    p.add_argument("--hbm-watchdog-loops", type=int, default=5,
                   help="consecutive loops of monotonic untagged device-"
                        "byte growth before the leak watchdog fires an "
                        "event + flight-recorder dump")
    p.add_argument("--device-profile-dir", default="",
                   help="breach-armed device profiler: a loop-SLO breach "
                        "arms a bounded torch.profiler capture of the "
                        "next RunOnce into this directory, stamped with "
                        "trace id + journal cursor (empty = off)")
    p.add_argument("--shadow-audit", type=_bool, default=False,
                   help="online shadow audit: each loop, re-verify a "
                        "deterministic journal-cursor-seeded sample of "
                        "device verdicts against the host oracle; a "
                        "divergence emits an evidence bundle and drives "
                        "the backend supervisor ladder (audit/shadow.py)")
    p.add_argument("--shadow-audit-samples", type=int, default=4,
                   help="verdict samples per audited surface per loop")
    p.add_argument("--shadow-audit-budget-ms", type=float, default=0.0,
                   help="per-loop audit budget refill in ms; 0 = adaptive "
                        "~0.5%% of the loop walltime (skipped samples are "
                        "counted — the audit never becomes the hot path)")
    p.add_argument("--shadow-audit-dir", default="",
                   help="directory for divergence evidence bundles "
                        "(default: --flight-recorder-dir)")
    p.add_argument("--restart-state-path", default="",
                   help="persist unneeded-since clocks + in-flight "
                        "scale-ups here each loop and rehydrate on start "
                        "(crash-consistent restart; empty = off)")
    p.add_argument("--restart-state-max-age", type=dur, default=1800.0,
                   help="discard a restart record older than this "
                        "wholesale (stale countdowns must not cause "
                        "premature deletions)")

    # TPU data plane (no reference analog — Go has no tracing/compile cache)
    p.add_argument("--node-shape-bucket", type=int, default=256)
    p.add_argument("--group-shape-bucket", type=int, default=64)
    p.add_argument("--max-new-nodes-static", type=int, default=1024)
    p.add_argument("--drain-chunk", type=int, default=32)
    p.add_argument("--max-pods-per-node", type=int, default=128)
    p.add_argument("--fused-loop", type=_bool, default=True,
                   help="run filter/scale-up/scale-down as ONE fused device "
                        "program with a single batched decision fetch "
                        "(docs/FUSED_LOOP.md); false = phased dispatches")
    p.add_argument("--incremental-encode", type=_bool, default=True,
                   help="maintain the tensor snapshot across loops and apply "
                        "only deltas (reference rationale: DeltaSnapshotStore)")
    p.add_argument("--incremental-resync-loops", type=int, default=240,
                   help="compacting full re-encode every N loops (0 = never)")
    p.add_argument("--incremental-verify-loops", type=int, default=0,
                   help="semantically verify the incremental tensors against "
                        "a fresh encode every N loops; mismatch forces a "
                        "resync and raises an error metric (0 = off)")

    # runner (standalone mode)
    p.add_argument("--scenario", default="",
                   help="JSON scenario file for the in-memory provider")
    p.add_argument("--max-iterations", type=int, default=0,
                   help="0 = run forever")
    return p


def _min_max(text: str) -> tuple[int, int]:
    lo, _, hi = text.partition(":")
    return int(lo or 0), int(hi or 0)


def options_from_args(args: argparse.Namespace) -> AutoscalingOptions:
    _, max_cores = _min_max(args.cores_total)
    _, max_mem_gib = _min_max(args.memory_total)
    _, max_gpus = _min_max(args.gpu_total)
    return AutoscalingOptions(
        enforce_node_group_min_size=args.enforce_node_group_min_size,
        parallel_scale_up=args.parallel_scale_up,
        scale_up_from_zero=args.scale_up_from_zero,
        scale_from_unschedulable=args.scale_from_unschedulable,
        async_node_group_creation=args.async_node_groups,
        scale_up_salvo_enabled=args.salvo_scale_up,
        salvo_time_budget_s=args.salvo_scale_up_budget,
        node_autoprovisioning_enabled=args.node_autoprovisioning_enabled,
        max_autoprovisioned_node_group_count=args.max_autoprovisioned_node_group_count,
        max_gpu_total=max_gpus,
        max_allocatable_difference_ratio=args.max_allocatable_difference_ratio,
        max_free_difference_ratio=args.max_free_difference_ratio,
        memory_difference_ratio=args.memory_difference_ratio,
        balancing_labels=list(args.balancing_label),
        balancing_ignore_labels=list(args.balancing_ignore_label),
        pod_injection_limit=args.pod_injection_limit,
        scale_down_unready_enabled=args.scale_down_unready_enabled,
        scale_down_non_empty_candidates_count=args.scale_down_non_empty_candidates_count,
        max_bulk_soft_taint_count=args.max_bulk_soft_taint_count,
        max_bulk_soft_taint_time_s=args.max_bulk_soft_taint_time,
        node_deletion_candidate_ttl_s=args.node_deletion_candidate_ttl,
        unremovable_node_recheck_timeout_s=args.unremovable_node_recheck_timeout,
        cordon_node_before_terminating=args.cordon_node_before_terminating,
        daemonset_eviction_for_empty_nodes=args.daemonset_eviction_for_empty_nodes,
        daemonset_eviction_for_occupied_nodes=args.daemonset_eviction_for_occupied_nodes,
        ignore_mirror_pods_utilization=args.ignore_mirror_pods_utilization,
        emit_per_nodegroup_metrics=args.emit_per_nodegroup_metrics,
        debugging_snapshot_enabled=args.debugging_snapshot_enabled,
        write_status_configmap=args.write_status_configmap,
        status_config_map_name=args.status_config_map_name,
        max_inactivity_s=args.max_inactivity,
        max_failing_time_s=args.max_failing_time,
        max_startup_time_s=args.max_startup_time,
        profiling=args.profiling,
        grpc_expander_url=args.grpc_expander_url,
        grpc_expander_cert=args.grpc_expander_cert,
        enable_provisioning_requests=args.enable_provisioning_requests,
        capacity_buffer_controller_enabled=args.capacity_buffer_controller_enabled,
        capacity_buffer_pod_injection_enabled=args.capacity_buffer_pod_injection_enabled,
        capacity_quotas_enabled=args.capacity_quotas_enabled,
        enable_dynamic_resource_allocation=args.enable_dynamic_resource_allocation,
        enable_csi_node_aware_scheduling=args.enable_csi_node_aware_scheduling,
        node_removal_latency_tracking_enabled=args.node_removal_latency_tracking_enabled,
        scan_interval_s=args.scan_interval,
        estimator=args.estimator,
        expander=args.expander,
        max_nodes_per_scaleup=args.max_nodes_per_scaleup,
        max_nodes_total=args.max_nodes_total,
        max_cores_total=max_cores,
        max_memory_total_mib=max_mem_gib * 1024,
        balance_similar_node_groups=args.balance_similar_node_groups,
        new_pod_scale_up_delay_s=args.new_pod_scale_up_delay,
        expendable_pods_priority_cutoff=args.expendable_pods_priority_cutoff,
        max_binpacking_time_s=args.max_binpacking_time,
        scale_down_enabled=args.scale_down_enabled,
        scale_down_delay_after_add_s=args.scale_down_delay_after_add,
        scale_down_delay_after_delete_s=args.scale_down_delay_after_delete,
        scale_down_delay_after_failure_s=args.scale_down_delay_after_failure,
        scale_down_candidates_pool_ratio=args.scale_down_candidates_pool_ratio,
        scale_down_candidates_pool_min_count=args.scale_down_candidates_pool_min_count,
        max_scale_down_parallelism=args.max_scale_down_parallelism,
        max_drain_parallelism=args.max_drain_parallelism,
        max_empty_bulk_delete=args.max_empty_bulk_delete,
        max_graceful_termination_s=float(args.max_graceful_termination_sec),
        skip_nodes_with_system_pods=args.skip_nodes_with_system_pods,
        skip_nodes_with_local_storage=args.skip_nodes_with_local_storage,
        skip_nodes_with_custom_controller_pods=args.skip_nodes_with_custom_controller_pods,
        min_replica_count=args.min_replica_count,
        max_total_unready_percentage=args.max_total_unready_percentage,
        ok_total_unready_count=args.ok_total_unready_count,
        max_node_startup_time_s=args.max_node_startup_time,
        unregistered_node_removal_time_s=args.unregistered_node_removal_time,
        initial_node_group_backoff_s=args.initial_node_group_backoff_duration,
        max_node_group_backoff_s=args.max_node_group_backoff_duration,
        node_group_backoff_reset_timeout_s=args.node_group_backoff_reset_timeout,
        node_group_defaults=NodeGroupDefaults(
            scale_down_utilization_threshold=args.scale_down_utilization_threshold,
            scale_down_gpu_utilization_threshold=args.scale_down_gpu_utilization_threshold,
            scale_down_unneeded_time_s=args.scale_down_unneeded_time,
            scale_down_unready_time_s=args.scale_down_unready_time,
            max_node_provision_time_s=args.max_node_provision_time,
            ignore_daemonsets_utilization=args.ignore_daemonsets_utilization,
        ),
        node_shape_bucket=args.node_shape_bucket,
        group_shape_bucket=args.group_shape_bucket,
        max_new_nodes_static=args.max_new_nodes_static,
        drain_chunk=args.drain_chunk,
        max_pods_per_node=args.max_pods_per_node,
        max_pod_eviction_time_s=args.max_pod_eviction_time,
        scale_down_simulation_timeout_s=args.scale_down_simulation_timeout,
        force_delete_unregistered_nodes=args.force_delete_unregistered_nodes,
        async_node_deletion=args.async_node_deletion,
        fused_loop=args.fused_loop,
        incremental_encode=args.incremental_encode,
        incremental_resync_loops=args.incremental_resync_loops,
        incremental_verify_loops=args.incremental_verify_loops,
        flight_recorder_capacity=args.flight_recorder_capacity,
        flight_recorder_dir=args.flight_recorder_dir,
        loop_wallclock_budget_s=args.loop_wallclock_budget,
        journal_dir=args.journal_dir,
        journal_max_mb=args.journal_max_mb,
        lineage_ring=args.lineage_ring,
        lineage_ring_objects=args.lineage_ring_objects,
        lineage_ring_loops=args.lineage_ring_loops,
        backend_phase_deadline_s=args.backend_phase_deadline,
        backend_probe_deadline_s=args.backend_probe_deadline,
        backend_suspect_threshold=args.backend_suspect_threshold,
        backend_recovery_probes=args.backend_recovery_probes,
        backend_recovery_hysteresis_loops=args.backend_recovery_hysteresis,
        device_ledger=args.device_ledger,
        hbm_watchdog_loops=args.hbm_watchdog_loops,
        device_profile_dir=args.device_profile_dir,
        shadow_audit=args.shadow_audit,
        shadow_audit_samples=args.shadow_audit_samples,
        shadow_audit_budget_ms=args.shadow_audit_budget_ms,
        shadow_audit_dir=args.shadow_audit_dir,
        restart_state_path=args.restart_state_path,
        restart_state_max_age_s=args.restart_state_max_age,
    )


def parse_options(argv: list[str] | None = None
                  ) -> tuple[AutoscalingOptions, argparse.Namespace]:
    from kubernetes_autoscaler_tpu_torch.config.flag_parity import REJECTED

    args, unknown = build_parser().parse_known_args(argv)
    # Unknown flags: if the reference defines them and this framework
    # deliberately rejects them (flag_parity.REJECTED), log the reason and
    # continue — operator flag soups keep working. Anything else is an error:
    # a typo'd or truly unknown flag must never become a silent no-op.
    for tok in unknown:
        if not tok.startswith("--"):
            continue
        name = tok[2:].split("=", 1)[0]
        if name in REJECTED:
            import sys

            print(f"[flags] --{name} accepted without effect: {REJECTED[name]}",
                  file=sys.stderr)
        else:
            raise SystemExit(f"unknown flag --{name} (not a reference flag "
                             "this framework implements or rejects)")
    return options_from_args(args), args
