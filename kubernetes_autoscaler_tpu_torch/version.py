"""Framework version (reference: cluster-autoscaler/version/version.go).

Tracks the reference release line this framework targets for behavior parity,
plus the framework's own version.
"""

# reference line whose flags/metrics/semantics this framework tracks
REFERENCE_VERSION = "cluster-autoscaler-1.33"
VERSION = "0.3.0"


def version_string() -> str:
    return f"kubernetes-autoscaler-tpu {VERSION} (parity: {REFERENCE_VERSION})"
