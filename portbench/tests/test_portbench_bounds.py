"""The bound arithmetic on hand-worked shapes."""

import pytest

from portbench import bounds


def test_k1_bytes_and_operations_by_hand():
    b, g, n, r = 2, 40, 100, 4
    nbytes, ops = bounds.k1(b, g, n, r, 1000)
    # in: free 3,200 + mask bits 2*2*100*4 = 1,600 + req 640 + 3 x 160;
    # out: placed 32,000 + free_after 3,200 + scheduled 320
    assert nbytes == 3200 + 1600 + 640 + 480 + 32000 + 3200 + 320
    assert ops == 1000 * 4 * r + b * g * n * 8
    ms, kind = bounds.bound_ms(nbytes, ops)
    # 41,440 bytes at 3.35 TB/s outlast 80,000 operations at 67 TFLOP/s
    assert kind == "bytes"
    assert ms == pytest.approx(41440 / 3.35e12 * 1e3)


def test_row_d_bytes_and_operations_by_hand():
    c = n = 10
    r, g, p, mpn = 8, 4, 20, 16
    nbytes, ops = bounds.row_d(c, n, r, g, p, mpn, nodes_needed=30)
    # in: candidates 40, starts 40, pad_order 144, node and group 160,
    # flags 60, free 320, plane 40, destinations 10, limit_one 4, req 128;
    # out: 2 flags 20, 2 counts 80, destinations and slots 1,280
    assert nbytes == 40 + 40 + 144 + 160 + 60 + 320 + 40 + 10 + 4 + 128 \
        + 20 + 80 + 1280
    assert ops == 30 * (4 * r + 8)
    topo, _ = bounds.row_d(c, n, r, g, p, mpn, 30, zones=3)
    # zone rows 50, 3 int and 4 bool scalars a group 64, 3 count planes
    # 480, the eligibility plane 40, 4 zone totals 192
    assert topo - nbytes == 50 + 64 + 480 + 40 + 192


def test_row_p_bytes_and_operations_by_hand():
    g, n = 2, 3
    nbytes, ops = bounds.row_p(g, n, bounds.SELECTOR, probes=1)
    assert nbytes == 4 * n * 64 + 4 * g * 24 + 4 * g * 4 + g * n
    assert ops == 1 * n * 64
    nbytes, ops = bounds.row_p(g, n, bounds.TAINTS | bounds.GATES,
                               taint_slots=2, intolerant=2, residents=5)
    assert nbytes == (2 * 4 * n * 6 + 2 * 4 * g * 8 + g) + (3 * n + g) \
        + (5 * 9 + g) + g * n
    assert ops == 2 * 2 * 2 * 8 + 2 * g * n + 4 * 5 + g * n


def test_bound_names_the_larger():
    assert bounds.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert bounds.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")
    assert bounds.bound_ms(3.35e9, 2 * 67e9)[1] == "operations"
