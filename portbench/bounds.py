"""The least device time a kernel call could take on one NVIDIA H100: the
benchmark's yardstick for the `*_roofline` metrics.

Peaks (NVIDIA H100 SXM data sheet, at its full 700 W power limit; every run
prints the card's own limit beside its numbers):

- HBM3 bandwidth 3.35 TB/s (`BYTES_PER_S`);
- 67 TFLOP/s of float32 outside the tensor cores (`OPS_PER_S`). The data
  sheet gives no rate for int32, and these kernels do integer work: the
  float32 rate is the assumed peak for it.

A call's bound is the larger of its bytes over the bandwidth and its
operations over the rate: each input read once, each output written once,
as the kernel takes them (the K1 mask bit-packed; the predicate plane's
label, taint, port and selector slots at the widths below), and the
operations that these inputs need. Where that count depends on the data
(the mask's set bits, the node fits a first fit needs before its pods are
placed) it is counted by the reference's own pass over the same world
(reference/decide.py), never read from a counter of the program. The
arithmetic follows chip_smoke.py's `pack_bound`, `drain_bound`, `pred_ops`
and `pred_bound`, on shapes and counts instead of tensors.

Each function returns (bytes, operations) of one call; `bound_ms` turns a
sum of calls into milliseconds and names which of the two bounds it.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# the slots of the predicate plane's inputs, as the kernel takes them: label
# hashes a node, taints a node, used ports a node, selector terms and
# alternatives, must-be-absent hashes, tolerations and ports a group; zone
# slots of the drain's topology inputs
LABELS, TAINTS_N, PORTS_N = 64, 6, 16
SEL_TERMS, SEL_ALTS, SEL_NEG, TOLERATIONS, PORTS_G = 6, 4, 4, 8, 4
ZONES = 16

# the predicate plane's checks
SELECTOR, TAINTS, PORTS, GATES = 1, 2, 4, 16
STATIC = SELECTOR | TAINTS | PORTS | GATES


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, 'bytes' | 'operations') of work that moves `nbytes` and does
    `ops` integer operations."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1(b: int, g: int, n: int, r: int, mask_bits_set: int):
    """K1 (csrc/pack.cu), B rows of G groups on N bins of R resources: free
    i32[B, N, R], the mask bit-packed to i32[B, ceil(G/32), N], req
    i32[G, R], count, order and limit_one i32[G] in; placed i32[B, G, N],
    free_after i32[B, N, R] and scheduled i32[B, G] out. 4R integer
    operations (clamp, divide, min, update) a resource on every (row,
    group, node) whose mask bit is set, and 8 for the mask test, the caps
    and the scan on every one."""
    in_bytes = (b * n * r * 4 + b * ((g + 31) // 32) * n * 4
                + g * r * 4 + 3 * g * 4)
    out_bytes = (b * g * n + b * n * r + b * g) * 4
    ops = mask_bits_set * 4 * r + b * g * n * 8
    return in_bytes + out_bytes, ops


def row_d(c: int, n: int, r: int, g: int, p: int, mpn: int,
          nodes_needed: int, zones: int | None = None):
    """Row D (csrc/drain.cu), one sweep of C candidates over N nodes, G
    groups and P resident pods (windows of MPN): its inputs (candidates,
    starts, the pods' order, node, group, valid, movable and blocking flags,
    free i32[N, R], the plane bool[G, N], the destinations, limit_one, req
    i32[G, R]; in the topology mode, `zones` set, the zone rows, the
    groups' constraint scalars, three count planes i32[G, N], an
    eligibility plane bool[G, N] and four zone totals i32[G, Z]) read once,
    and its verdicts, counts and destinations written once. The fit on
    every node the slots' first fits needed (`nodes_needed`), 4R a node
    (load, debit, divide, min a resource) plus 8 (the gates, the caps, the
    scan)."""
    in_bytes = (4 * c + 4 * n + 4 * (p + mpn) + 2 * 4 * p + 3 * p
                + 4 * n * r + g * n + n + g + 4 * g * r)
    if zones is not None:
        in_bytes += (4 * n + n + 3 * 4 * g + 4 * g + 3 * 4 * g * n + g * n
                     + 4 * 4 * g * zones)
    out_bytes = 2 * c + 2 * 4 * c + 2 * 4 * c * mpn
    ops = nodes_needed * (4 * r + 8)
    return in_bytes + out_bytes, ops


def row_p(g: int, n: int, checks: int, *, probes: int = 0,
          taint_slots: int = 0, intolerant: int = 0, port_probes: int = 0,
          residents: int | None = None):
    """Row P (csrc/predicates.cu), one bool plane of G groups on N nodes.
    Bytes: the planes that the checks read, once (selector: the nodes'
    label hashes and the groups' terms; taints: the nodes' taint hashes
    and the groups' tolerations; ports: the used and asked ports; gates:
    the nodes' and groups' flags), with `residents` (P pods) their valid,
    node and group rows and the groups' self-anti-affinity flags, and the
    plane written once. Operations: a selector probe (`probes`: non-zero
    terms and must-be-absent hashes over the groups) against the label
    slots of every node, a port probe against every node's used ports, a
    taint (`taint_slots`: non-zero over the nodes) against the 2
    toleration hashes of each `intolerant` group (one that does not
    tolerate all), 2 for the gates on every (g, n); with residents 4 a pod
    and one a pair."""
    in_bytes = 0
    if checks & SELECTOR:
        in_bytes += 4 * n * LABELS + 4 * g * SEL_TERMS * SEL_ALTS + 4 * g * SEL_NEG
    if checks & TAINTS:
        in_bytes += 2 * 4 * n * TAINTS_N + 2 * 4 * g * TOLERATIONS + g
    if checks & PORTS:
        in_bytes += 4 * n * PORTS_N + 4 * g * PORTS_G
    if checks & GATES:
        in_bytes += 3 * n + g
    need = 0
    if checks & SELECTOR:
        need += probes * n * LABELS
    if checks & TAINTS:
        need += intolerant * taint_slots * 2 * TOLERATIONS
    if checks & PORTS:
        need += port_probes * n * PORTS_N
    if checks & GATES:
        need += 2 * g * n
    if residents is not None:
        in_bytes += residents * (1 + 4 + 4) + g
        need += 4 * residents + g * n
    return in_bytes + g * n, need
