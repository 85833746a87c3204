"""row_d_roofline.consolidate: row_d_roofline, for the cells that hold
decisions_per_s end to end: the same reading (metrics/row_d_roofline.py)."""

from portbench import spec

read = spec.reader("row_d_roofline")
