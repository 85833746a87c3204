"""launches_per_decision.steady: launches_per_decision, for the cells that
hold device_ms_per_decision end to end: the same reading
(metrics/launches_per_decision.py)."""

from portbench import spec

read = spec.reader("launches_per_decision")
