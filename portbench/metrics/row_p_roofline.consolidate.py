"""row_p_roofline.consolidate: row_p_roofline, for the cells that hold
decisions_per_s end to end: the same reading (metrics/row_p_roofline.py)."""

from portbench import spec

read = spec.reader("row_p_roofline")
