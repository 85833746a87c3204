"""What decides `correct`: the program's decisions against the reference's.

Two numbers are compared, each with its limit (PERF.md gives the readings
each limit was set from):

- `exact_mismatches`: elements of the integer and bool leaves (verdicts,
  pending counts, allocations after placement, each option's node count
  and scheduled pods, the scores' counts and validity, drainable, blocked)
  that differ from the reference's, plus decisions whose chosen option
  (the least-waste expander's pick from the program's scores) is not one
  the reference would pick: an option that is not valid, or whose waste
  is above the reference's least by more than the float limit (two
  options of equal waste to rounding are equally right). The
  configurations state exact decisions, so the limit is 0.
- `float_gap`: the largest gap of a float leaf (utilization, waste, price,
  the helped requests), |program - reference| / max(|reference|, 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

LIMITS = {"exact_mismatches": 0, "float_gap": 1e-5}


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a decision tree (dataclasses of tensors or arrays);
    None leaves are left out."""
    if tree is None:
        return {}
    if not dataclasses.is_dataclass(tree):
        return {prefix: tree}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(flatten(getattr(tree, f.name), f"{prefix}.{f.name}"))
    return out


def compare(got: dict, want: dict) -> tuple[int, float]:
    """(exact mismatches, float gap) of one flattened decision against the
    reference's; a leaf missing on either side, or of another shape or
    kind, counts all its elements as mismatches."""
    mism, gap = 0, 0.0
    for path in sorted(set(got) | set(want)):
        if path not in got or path not in want:
            mism += int(np.size(want.get(path, got.get(path)))) or 1
            continue
        a, b = np.asarray(got[path]), np.asarray(want[path])
        fa, fb = np.issubdtype(a.dtype, np.floating), np.issubdtype(b.dtype, np.floating)
        if a.shape != b.shape or fa != fb:
            mism += max(a.size, b.size, 1)
            continue
        if fb:
            if a.size:
                d = np.abs(a.astype(np.float64) - b.astype(np.float64))
                d = d / np.maximum(np.abs(b.astype(np.float64)), 1.0)
                g = float(np.nanmax(d)) if np.isfinite(d).all() else float("inf")
                gap = max(gap, g)
        else:
            mism += int((a != b).sum())
    return mism, gap


def chosen_option(flat: dict) -> int:
    """The least-waste expander's pick from a flattened decision's scores:
    the valid option of least waste, the lowest index among equals; -1
    when no option is valid."""
    valid = np.asarray(flat[".scores.valid"], dtype=bool)
    if not valid.any():
        return -1
    waste = np.where(valid, np.asarray(flat[".scores.waste"], np.float64),
                     np.inf)
    return int(np.argmin(waste))


def wrong_choice(got: dict, want: dict) -> int:
    """1 when the program's pick (from its own scores) is not an option
    that the reference's scores allow as least waste, else 0."""
    picked, best = chosen_option(got), chosen_option(want)
    if picked == best:
        return 0
    if picked < 0 or best < 0 or not want[".scores.valid"][picked]:
        return 1
    w = np.asarray(want[".scores.waste"], dtype=np.float64)
    return int(w[picked] - w[best] > LIMITS["float_gap"] * max(abs(w[best]), 1.0))


def against(got: dict, want: dict) -> tuple[int, float]:
    """(exact mismatches, float gap) of one flattened decision against the
    reference's, its chosen option included."""
    mism, gap = compare(got, want)
    return mism + wrong_choice(got, want), gap


def verdict(numbers: dict, limits: dict = LIMITS) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: dict, limits: dict = LIMITS) -> dict:
    """{name: {"value": v, "limit": l}}, the result line's last key."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
