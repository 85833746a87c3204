"""Flag-parity registry vs the reference's config/flags/flags.go (~125 pflags).

Every reference flag appears in exactly one bucket:

  IMPLEMENTED — parsed by config/flags.py into an AutoscalingOptions field
                with a real behavioral consumer (tests/test_flag_parity.py
                asserts the parser knows each one).
  REJECTED    — accepted on the command line for operator muscle-memory but
                deliberately without effect HERE, each with the architectural
                reason. Passing one logs a warning naming the reason; a flag
                in neither bucket is an ERROR (no silent no-ops).

The registry is the single source of truth: parse_options consults it.
"""

from __future__ import annotations

# flag name → AutoscalingOptions field (documentation; parity test checks the
# parser accepts the flag)
IMPLEMENTED: dict[str, str] = {
    "address": "serving address (__main__ HTTP mux)",
    "async-node-groups": "async_node_group_creation",
    "balance-similar-node-groups": "balance_similar_node_groups",
    "balancing-ignore-label": "balancing_ignore_labels",
    "balancing-label": "balancing_labels",
    "capacity-buffer-controller-enabled": "capacity_buffer_controller_enabled",
    "capacity-buffer-pod-injection-enabled": "capacity_buffer_pod_injection_enabled",
    "capacity-quotas-enabled": "capacity_quotas_enabled",
    "cordon-node-before-terminating": "cordon_node_before_terminating",
    "cores-total": "max_cores_total (quota limiter merge)",
    "daemonset-eviction-for-empty-nodes": "daemonset_eviction_for_empty_nodes",
    "daemonset-eviction-for-occupied-nodes": "daemonset_eviction_for_occupied_nodes",
    "debugging-snapshot-enabled": "debugging_snapshot_enabled (__main__ wiring)",
    "emit-per-nodegroup-metrics": "emit_per_nodegroup_metrics",
    "enable-csi-node-aware-scheduling": "enable_csi_node_aware_scheduling",
    "enable-dynamic-resource-allocation": "enable_dynamic_resource_allocation",
    "enable-provisioning-requests": "enable_provisioning_requests",
    "enforce-node-group-min-size": "enforce_node_group_min_size",
    "estimator": "estimator",
    "expander": "expander",
    "expendable-pods-priority-cutoff": "expendable_pods_priority_cutoff",
    "gpu-total": "max_gpu_total (quota limiter merge)",
    "grpc-expander-cert": "grpc_expander_cert",
    "grpc-expander-url": "grpc_expander_url",
    "ignore-daemonsets-utilization": "node_group_defaults.ignore_daemonsets_utilization",
    "ignore-mirror-pods-utilization": "ignore_mirror_pods_utilization",
    "initial-node-group-backoff-duration": "initial_node_group_backoff_s",
    "max-allocatable-difference-ratio": "max_allocatable_difference_ratio",
    "force-delete-unregistered-nodes": "force_delete_unregistered_nodes (min-size-ignoring forceful reap)",
    "scale-down-simulation-timeout": "scale_down_simulation_timeout_s (confirmation-pass deadline)",
    "max-binpacking-time": "max_binpacking_time_s (verify/salvo deadline)",
    "max-bulk-soft-taint-count": "max_bulk_soft_taint_count",
    "max-bulk-soft-taint-time": "max_bulk_soft_taint_time_s",
    "max-drain-parallelism": "max_drain_parallelism",
    "max-failing-time": "max_failing_time_s (liveness)",
    "max-free-difference-ratio": "max_free_difference_ratio",
    "max-graceful-termination-sec": "max_graceful_termination_s (eviction grace cap + termination wait)",
    "max-pod-eviction-time": "max_pod_eviction_time_s (per-pod eviction retry window)",
    "max-inactivity": "max_inactivity_s (liveness)",
    "max-node-group-backoff-duration": "max_node_group_backoff_s",
    "max-node-provision-time": "node_group_defaults.max_node_provision_time_s",
    "max-node-startup-time": "max_node_startup_time_s",
    "max-nodes-per-scaleup": "max_nodes_per_scaleup",
    "max-nodes-total": "max_nodes_total",
    "max-scale-down-parallelism": "max_scale_down_parallelism",
    "max-startup-time": "max_startup_time_s (liveness)",
    "max-total-unready-percentage": "max_total_unready_percentage",
    "memory-difference-ratio": "memory_difference_ratio",
    "memory-total": "max_memory_total_mib (quota limiter merge)",
    "min-replica-count": "min_replica_count",
    "new-pod-scale-up-delay": "new_pod_scale_up_delay_s",
    "node-deletion-candidate-ttl": "node_deletion_candidate_ttl_s (WAL recovery)",
    "node-group-backoff-reset-timeout": "node_group_backoff_reset_timeout_s",
    "node-removal-latency-tracking-enabled": "node_removal_latency_tracking_enabled",
    "ok-total-unready-count": "ok_total_unready_count",
    "parallel-scale-up": "parallel_scale_up (executor workers)",
    "pod-injection-limit": "pod_injection_limit",
    "profiling": "profiling (__main__ /profilez)",
    "salvo-scale-up": "scale_up_salvo_enabled",
    "salvo-scale-up-budget": "salvo_time_budget_s",
    "scale-down-candidates-pool-min-count": "scale_down_candidates_pool_min_count",
    "scale-down-candidates-pool-ratio": "scale_down_candidates_pool_ratio",
    "scale-down-delay-after-add": "scale_down_delay_after_add_s",
    "scale-down-delay-after-delete": "scale_down_delay_after_delete_s",
    "scale-down-delay-after-failure": "scale_down_delay_after_failure_s",
    "scale-down-enabled": "scale_down_enabled",
    "scale-down-gpu-utilization-threshold": "node_group_defaults.scale_down_gpu_utilization_threshold",
    "scale-down-non-empty-candidates-count": "scale_down_non_empty_candidates_count",
    "scale-down-unneeded-time": "node_group_defaults.scale_down_unneeded_time_s",
    "scale-down-unready-enabled": "scale_down_unready_enabled",
    "scale-down-unready-time": "node_group_defaults.scale_down_unready_time_s",
    "scale-down-utilization-threshold": "node_group_defaults.scale_down_utilization_threshold",
    "scale-from-unschedulable": "scale_from_unschedulable",
    "scale-up-from-zero": "scale_up_from_zero",
    "scan-interval": "scan_interval_s",
    "skip-nodes-with-custom-controller-pods": "skip_nodes_with_custom_controller_pods",
    "skip-nodes-with-local-storage": "skip_nodes_with_local_storage",
    "skip-nodes-with-system-pods": "skip_nodes_with_system_pods",
    "status-config-map-name": "status_config_map_name",
    "unremovable-node-recheck-timeout": "unremovable_node_recheck_timeout_s",
    "write-status-configmap": "write_status_configmap",
}

# flag name → why it deliberately has no force in this framework
REJECTED: dict[str, str] = {
    "allowed-scheduler-names": "one simulated scheduler plane; no multi-scheduler routing",
    "aws-use-static-instance-list": "cloud-SDK specific; providers integrate via the SPI/externalgrpc",
    "blocking-system-pod-distruption-timeout": "drainability rules classify system pods per loop; no wait-loop to bound",
    "bulk-mig-instances-listing-enabled": "GCE-SDK specific",
    "bypassed-scheduler-names": "one simulated scheduler plane",
    "capacity-buffer-pod-dry-run-enabled": "buffer translation is always side-effect-free until injection",
    "check-capacity-batch-processing": "check-capacity ProvReqs are evaluated exhaustively each loop on device; no batching needed",
    "check-capacity-processor-instance": "single processor instance per process",
    "check-capacity-provisioning-request-batch-timebox": "no batching (see check-capacity-batch-processing)",
    "check-capacity-provisioning-request-max-batch-size": "no batching (see check-capacity-batch-processing)",
    "cloud-config": "no cloud SDKs in-process; providers attach via the SPI/externalgrpc",
    "cloud-provider": "provider is constructor-injected, not name-selected",
    "cluster-name": "no cloud tagging surface",
    "cluster-snapshot-parallelism": "snapshot is a device tensor; parallelism is the mesh, not host threads",
    "clusterapi-cloud-config-authoritative": "cloud-SDK specific",
    "drain-priority-config": "priority eviction order is built in (actuator.priority_eviction_order); tiered waits belong to the eviction sink",
    "dynamic-node-delete-delay-after-taint-enabled": "deletion issues through the provider synchronously; no apiserver round-trip to pace",
    "enable-proactive-scaleup": "capacity buffers + pod injection cover proactive headroom",
    "fastpath-binpacking-enabled": "no fastpath exists: the full pack is one fused device program",
    "force-delete-failed-nodes": "failed-boot instances are force-reaped unconditionally (no apiserver finalizers to bypass)",
    "frequent-loops-enabled": "the loop driver is always event-driven (core/loop.py LoopTrigger)",
    "gce-concurrent-refreshes": "GCE-SDK specific",
    "gce-mig-instances-min-refresh-wait-time": "GCE-SDK specific",
    "ignore-taint": "superseded upstream by startup-taint; taints are exact hash planes here",
    "kube-api-content-type": "no kube API client; the boundary is ClusterDataSource",
    "kube-client-burst": "no kube API client",
    "kube-client-qps": "no kube API client",
    "kubeconfig": "no kube API client",
    "max-nodegroup-binpacking-duration": "all groups estimate in ONE device dispatch; max-binpacking-time bounds the whole computation",
    "max-node-skip-eval-time-tracker-enabled": "no per-node eval-skip heuristic: the sweep is exhaustive on device",
    "namespace": "no kube API objects to namespace",
    "node-delete-delay-after-taint": "no apiserver propagation delay to wait out",
    "node-deletion-batcher-interval": "empty-node deletions batch per loop already (actuator delete_in_batch path)",
    "node-deletion-delay-timeout": "no delay-deletion annotations without a kube API",
    "node-group-auto-discovery": "groups come from the provider SPI; discovery specs are provider-side",
    "node-info-cache-expire-time": "templates are re-encoded every loop by design; there is no cache to expire",
    "nodes": "per-group min:max bounds come from the provider SPI",
    "predicate-parallelism": "the predicate plane is data-parallel on device by construction",
    "provisioning-request-initial-backoff-time": "failed ProvReqs re-evaluate next loop; exhaustive device evaluation makes backoff caching moot",
    "provisioning-request-max-backoff-cache-size": "no ProvReq backoff cache",
    "provisioning-request-max-backoff-time": "no ProvReq backoff cache",
    "record-duplicated-events": "no kube events API",
    "regional": "GCE-SDK specific",
    "scale-down-delay-type-local": "single-process autoscaler; delays are always local",
    "scaleup-simulation-for-skipped-node-groups-enabled": "no groups are skipped: every group's option is computed in the same kernel",
    "startup-taint": "node readiness comes from the data source; startup taints are a kubelet-lifecycle concern",
    "status-taint": "same as startup-taint",
    "user-agent": "no kube API client",
}


def check_no_overlap() -> None:
    both = set(IMPLEMENTED) & set(REJECTED)
    if both:
        raise AssertionError(f"flags in both buckets: {sorted(both)}")


check_no_overlap()
