"""AutoscalingOptions: the framework's single configuration bag.

Reference counterpart: config/autoscaling_options.go:107 (~120 fields fed by
~125 pflags, config/flags/flags.go). Field names keep the reference's meaning;
durations are seconds (floats) instead of time.Duration. config/flags.py maps
CLI flags onto this dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class NodeGroupDefaults:
    """Per-nodegroup defaults, overridable via NodeGroup.get_options
    (reference: config.NodeGroupAutoscalingOptions)."""

    scale_down_utilization_threshold: float = 0.5
    scale_down_gpu_utilization_threshold: float = 0.5
    scale_down_unneeded_time_s: float = 600.0
    scale_down_unready_time_s: float = 1200.0
    max_node_provision_time_s: float = 900.0
    ignore_daemonsets_utilization: bool = False


@dataclass
class AutoscalingOptions:
    # loop
    scan_interval_s: float = 10.0

    # scale-up
    estimator: str = "binpacking"                  # reference: estimator.go:53 (sole impl)
    expander: str = "least-waste"                  # comma-separated chain, reference flags.go
    max_nodes_per_scaleup: int = 1000              # FAQ.md:1086
    max_nodes_total: int = 0                       # 0 = unlimited
    max_cores_total: int = 320000                  # reference --cores-total max
    max_memory_total_mib: int = 6400000 * 1024     # reference --memory-total max (GiB→MiB)
    balance_similar_node_groups: bool = False
    new_pod_scale_up_delay_s: float = 0.0
    expendable_pods_priority_cutoff: int = -10
    max_binpacking_time_s: float = 5 * 60.0
    # salvo mode (reference: runScaleUpSalvo static_autoscaler.go:669 —
    # iterate scale-up within one loop, re-injecting scaled-up capacity)
    scale_up_salvo_enabled: bool = False
    salvo_max_rounds: int = 5
    salvo_time_budget_s: float = 2.0
    # node-group auto-provisioning (reference: --node-autoprovisioning-enabled,
    # --max-autoprovisioned-node-group-count)
    node_autoprovisioning_enabled: bool = False
    max_autoprovisioned_node_group_count: int = 15
    # async creation (reference: CreateNodeGroupAsync orchestrator.go:453 +
    # async_initializer.go — the loop never blocks on slow cloud creation)
    async_node_group_creation: bool = False

    # scale-up extras
    enforce_node_group_min_size: bool = False      # --enforce-node-group-min-size
    parallel_scale_up: bool = True                 # --parallel-scale-up (executor threads)
    scale_up_from_zero: bool = True                # --scale-up-from-zero
    scale_from_unschedulable: bool = False         # --scale-from-unschedulable
    max_gpu_total: int = 0                         # --gpu-total (0 = unlimited)
    # similar-nodegroup balancing knobs (reference:
    # processors/nodegroupset/compare_nodegroups.go + --balancing-*-label)
    max_allocatable_difference_ratio: float = 0.05
    max_free_difference_ratio: float = 0.05
    memory_difference_ratio: float = 0.015
    balancing_labels: list[str] = field(default_factory=list)
    balancing_ignore_labels: list[str] = field(default_factory=list)
    pod_injection_limit: int = 5000                # --pod-injection-limit

    # subsystem gates (reference feature flags)
    enable_provisioning_requests: bool = True
    capacity_buffer_controller_enabled: bool = True
    # injection can stop while the controller keeps reconciling statuses
    # (two independent reference flags)
    capacity_buffer_pod_injection_enabled: bool = True
    capacity_quotas_enabled: bool = True
    enable_dynamic_resource_allocation: bool = True
    enable_csi_node_aware_scheduling: bool = True
    node_removal_latency_tracking_enabled: bool = True
    max_startup_time_s: float = 20 * 60.0          # --max-startup-time (liveness)

    # scale-down
    scale_down_enabled: bool = True
    scale_down_delay_after_add_s: float = 600.0
    scale_down_delay_after_delete_s: float = 0.0
    scale_down_delay_after_failure_s: float = 180.0
    scale_down_candidates_pool_ratio: float = 1.0
    scale_down_candidates_pool_min_count: int = 50
    scale_down_unready_enabled: bool = True        # --scale-down-unready-enabled
    # --scale-down-non-empty-candidates-count: the reference defaults to 30
    # because its per-candidate drain simulation is serial and slow; the
    # device sweep evaluates every candidate in one dispatch, so the default
    # here is 0 (unlimited). Setting the flag still caps the pool.
    scale_down_non_empty_candidates_count: int = 0
    # wall-clock budget for the host-side CONFIRMATION pass (reference:
    # --scale-down-simulation-timeout bounds its serial simulation,
    # planner.go:297; our device sweep needs no bound, but the sequential
    # confirm loop over pathological shapes — thousands of accepted drains
    # with exact-oracle groups — does). Candidates not reached are simply
    # retried next loop.
    scale_down_simulation_timeout_s: float = 30.0
    max_scale_down_parallelism: int = 10
    max_drain_parallelism: int = 1
    max_empty_bulk_delete: int = 10
    max_graceful_termination_s: float = 600.0
    # per-pod eviction retry window (reference: --max-pod-eviction-time, 2m;
    # drain.go:185 retryUntil)
    max_pod_eviction_time_s: float = 120.0
    # run evict+delete on a background executor so eviction retries never
    # block the control loop (the reference ALWAYS detaches —
    # deleteNodesAsync goroutines, actuator.go:287; default off here because
    # synchronous in-process sinks complete instantly and tests read results
    # from the same loop)
    async_node_deletion: bool = False
    # long-unregistered instances: use NodeGroup.force_delete_nodes and
    # ignore group min size (reference: --force-delete-unregistered-nodes,
    # static_autoscaler.go:990,1018)
    force_delete_unregistered_nodes: bool = False
    skip_nodes_with_system_pods: bool = True
    skip_nodes_with_local_storage: bool = True
    skip_nodes_with_custom_controller_pods: bool = False
    min_replica_count: int = 0
    # soft-taint WAL budgets (reference: --max-bulk-soft-taint-count/-time)
    max_bulk_soft_taint_count: int = 10
    max_bulk_soft_taint_time_s: float = 3.0
    # DeletionCandidate taints older than this are stale on recovery
    # (reference: --node-deletion-candidate-ttl)
    node_deletion_candidate_ttl_s: float = 30 * 60.0
    unremovable_node_recheck_timeout_s: float = 5 * 60.0  # --unremovable-node-recheck-timeout
    cordon_node_before_terminating: bool = False   # --cordon-node-before-terminating
    daemonset_eviction_for_empty_nodes: bool = False
    daemonset_eviction_for_occupied_nodes: bool = True
    ignore_mirror_pods_utilization: bool = False

    # observability / process
    emit_per_nodegroup_metrics: bool = False       # --emit-per-nodegroup-metrics
    debugging_snapshot_enabled: bool = False       # --debugging-snapshot-enabled
    # flight recorder (metrics/trace.py): ring of the last N RunOnce traces,
    # auto-persisted on a loop-budget breach / raise / armed /snapshotz.
    # 0 disables per-loop tracing entirely (the zero-overhead path).
    flight_recorder_capacity: int = 8              # --flight-recorder-capacity
    flight_recorder_dir: str = ""                  # --flight-recorder-dir ("" = ring only)
    # per-loop wall-clock budget; a slower RunOnce counts as an SLO breach
    # and dumps the flight recorder (0 = no budget)
    loop_wallclock_budget_s: float = 0.0           # --loop-wallclock-budget
    # deterministic flight journal (replay/journal.py): record every RunOnce
    # as a self-contained snapshot/delta record replayable bit-for-bit by
    # `python -m kubernetes_autoscaler_tpu_torch.replay`; "" = off
    journal_dir: str = ""                          # --journal-dir
    # size bound for the RETAINED journal (rotation + drop accounting)
    journal_max_mb: float = 64.0                   # --journal-max-mb
    # live decision-lineage ring (lineage/index.py): the bounded per-object
    # provenance view served on /whyz, /snapshotz and the sidecar Explain
    # RPC. Pure observer — fed once per loop from dicts RunOnce already
    # computed, zero extra device dispatches; False removes even that.
    lineage_ring: bool = True                      # --lineage-ring
    lineage_ring_objects: int = 512                # --lineage-ring-objects
    lineage_ring_loops: int = 128                  # --lineage-ring-loops
    # backend supervisor (core/supervisor.py): the control loop's
    # healthy → suspect → degraded → recovering ladder. 0 keeps the phase
    # guards inline (no watchdog thread, zero overhead) while exceptions in
    # guarded phases still drive the ladder; a positive deadline runs
    # encode/dispatch/fetch on sacrificial workers so a hung device op
    # aborts the LOOP at its budget instead of wedging the driver forever
    backend_phase_deadline_s: float = 0.0          # --backend-phase-deadline
    backend_probe_deadline_s: float = 5.0          # --backend-probe-deadline
    # consecutive guarded-phase failures before suspect escalates
    backend_suspect_threshold: int = 2             # --backend-suspect-threshold
    # consecutive probe successes to leave degraded, then clean loops of
    # hysteresis before scale-down re-enables (a flapping tunnel must not
    # thrash full re-encodes)
    backend_recovery_probes: int = 2               # --backend-recovery-probes
    backend_recovery_hysteresis_loops: int = 2     # --backend-recovery-hysteresis
    # device-side observability (metrics/device.py): the HBM residency
    # ledger census published per loop + the leak watchdog (K loops of
    # monotonic untagged growth fires an event + flight-recorder dump)
    device_ledger: bool = True                     # --device-ledger
    hbm_watchdog_loops: int = 5                    # --hbm-watchdog-loops
    # breach-armed device profiler: a loop-SLO breach arms a bounded
    # jax.profiler.trace capture of the NEXT RunOnce into this directory,
    # stamped with trace id + journal cursor; "" = off
    device_profile_dir: str = ""                   # --device-profile-dir
    # online shadow audit (audit/shadow.py): continuous, budget-bounded,
    # journal-cursor-seeded sampled re-verification of device verdicts
    # against the host oracle — divergence drives the supervisor ladder
    shadow_audit: bool = False                     # --shadow-audit
    # samples per audited surface per loop (K)
    shadow_audit_samples: int = 4                  # --shadow-audit-samples
    # per-loop audit budget refill in ms; 0 = adaptive (~0.5% of the loop
    # walltime EWMA — half the 1% overhead target). Exhausted budget skips
    # samples (counted), never stalls the loop.
    shadow_audit_budget_ms: float = 0.0            # --shadow-audit-budget-ms
    # divergence evidence bundles land here; "" falls back to
    # --flight-recorder-dir (bundle next to the Perfetto dump)
    shadow_audit_dir: str = ""                     # --shadow-audit-dir
    # crash-consistent restart record (unneeded-since clocks + in-flight
    # scale-ups keyed to the journal cursor); "" = off
    restart_state_path: str = ""                   # --restart-state-path
    # records older than this are discarded wholesale on rehydration —
    # stale countdown clocks must never cause premature deletions
    restart_state_max_age_s: float = 1800.0        # --restart-state-max-age
    write_status_configmap: bool = True            # --write-status-configmap
    status_config_map_name: str = "cluster-autoscaler-status"
    max_inactivity_s: float = 10 * 60.0            # --max-inactivity (liveness)
    max_failing_time_s: float = 15 * 60.0          # --max-failing-time (liveness)
    profiling: bool = False                        # --profiling (pprof analog)
    grpc_expander_url: str = ""                    # --grpc-expander-url
    grpc_expander_cert: str = ""                   # --grpc-expander-cert

    # cluster health (reference: clusterstate config)
    max_total_unready_percentage: float = 45.0
    ok_total_unready_count: int = 3
    max_node_startup_time_s: float = 15 * 60.0
    unregistered_node_removal_time_s: float = 15 * 60.0

    # backoff (reference: utils/backoff defaults)
    initial_node_group_backoff_s: float = 5 * 60.0
    max_node_group_backoff_s: float = 30 * 60.0
    node_group_backoff_reset_timeout_s: float = 3 * 60 * 60.0

    node_group_defaults: NodeGroupDefaults = field(default_factory=NodeGroupDefaults)

    # TPU data plane
    max_new_nodes_static: int = 1024               # static bin-pool size per option kernel
    node_shape_bucket: int = 256                   # compile-cache shape buckets
    group_shape_bucket: int = 64
    drain_chunk: int = 32
    max_pods_per_node: int = 128
    # single-dispatch fused RunOnce (docs/FUSED_LOOP.md): the loop's three
    # device phases as one compiled program harvested in one batched fetch,
    # with speculative next-loop overlap; False = phased dispatches (the
    # comparison oracle — decisions are bit-identical either way)
    fused_loop: bool = True
    # incremental tensor-snapshot maintenance across loops (the reference's
    # DeltaSnapshotStore rationale, store/delta.go:33-54, moved to the
    # string→tensor boundary); False = full encode_cluster every loop
    incremental_encode: bool = True
    # force a compacting full re-encode every N loops (0 = never); bounds
    # ghost-row growth from long-running node/equivalence churn
    incremental_resync_loops: int = 240
    # every N loops, semantically diff the incrementally-maintained tensors
    # against a fresh encode; a mismatch (= a source violating the replace-
    # on-update contract, e.g. in-place dict mutation) forces a resync and
    # raises the incremental_verify_failures_total metric instead of
    # producing silently stale verdicts. 0 = off (production default)
    incremental_verify_loops: int = 0
