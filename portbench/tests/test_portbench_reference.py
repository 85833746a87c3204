"""The reference's pieces on hand-worked inputs, apart from the program."""

import numpy as np

from portbench import spec, world
from portbench.reference import decide as ref
from portbench.tests.conftest import SEED, SMALL, SMALL_TRAFFIC


def test_fits_and_first_fit_by_hand():
    free = np.array([[1000, 512, 0, 2, 0, 0, 0, 0],
                     [-5, 4096, 0, 9, 0, 0, 0, 0]])
    req = np.array([250, 256, 0, 1, 0, 0, 0, 0])
    # cpu 4, memory 2, pods 2 on the first; negative cpu holds none
    assert ref.fits(free, req).tolist() == [2, 0]
    assert ref.first_fit(np.array([2, 0, 3, 5]), 4).tolist() == [2, 0, 2, 0]
    assert ref.first_fit(np.array([1, 1]), 5).tolist() == [1, 1]


def test_world_rows_follow_the_encoders_order():
    cfg = {**spec.load("configs", "ca-5k"), **SMALL}
    traffic = {**spec.load("traffic", "steady"), **SMALL_TRAFFIC["steady"]}
    v = world.variants(cfg, traffic, SEED)[2]
    w = ref.world_of(cfg, traffic, v)
    owners = [g.owner for g in w.groups]
    # the residents' owners first, then the pending groups, then the burst
    assert owners[:17] == [f"rs{o}" for o in range(17)]
    assert owners[17:] == [f"rs-{g}" for g in range(25)] + ["burst-rs"]
    assert w.g_pad == 64 and w.cap.shape == (64, 8) and w.p_pad == 256
    assert (w.alloc[:60, ref.CPU] == 2 * 800).all() and not w.alloc[60:].any()
    feas, t_feas = ref.feasibility(w)
    g0 = owners.index("rs-0")            # disk: ssd, tolerates the taint
    g4 = owners.index("rs-4")            # disk: ssd, no toleration
    assert feas[g0, :60].tolist() == [i % 3 != 0 for i in range(60)]
    assert feas[g4, :60].tolist() == [i % 3 != 0 and i % 10 != 0
                                      for i in range(60)]
    assert not feas[:, 60:].any() and not feas[len(owners):].any()
    assert t_feas[g4, :20].tolist() == [t % 3 != 0 for t in range(20)]


def test_a_node_whose_pods_find_no_room_does_not_drain():
    cfg = {**spec.load("configs", "ca-5k"), **SMALL, "nodes": 3,
           "node_bucket": 4, "residents_per_node": 2}
    traffic = {**spec.load("traffic", "consolidate"),
               "residents_leave_per_variant": 0}
    v = world.variants(cfg, traffic, SEED)[0]
    w = ref.world_of(cfg, traffic, v)
    free = w.cap - w.alloc
    feas, _ = ref.feasibility(w)
    ok, blocked, _ = ref.drain_sweep(w, free, feas, mpn=128)
    assert ok.tolist() == [True] * 4 and not blocked.any()
    free[1:3, ref.CPU] = 1000            # no room left for an 800m pod twice
    ok, _, needed = ref.drain_sweep(w, free, feas, mpn=128)
    # node 0's two pods take one place each on nodes 1 and 2
    assert ok.tolist() == [True, False, False, True]
    assert needed > 0
