"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: `python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`.
Without a CUDA device every test skips. Tolerance: none (integer outputs,
the constrained wave placer's and the drain sweep's int32 wrap-around
included; the histogram scatter's f32 sums are added in the same order as
the plain version's; the predicate plane's bool and uint16 planes). `-k
drain` runs the drain sweep's alone, `-k topo` its topology mode's, `-k
predicate` the predicate plane's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_autoscaler_tpu_torch.ops import drain, pack, predicates
from kubernetes_autoscaler_tpu_torch.ops.kernels import (
    con_cases,
    constrained_kernel,
    drain_cases,
    drain_kernel,
    drain_topo_cases,
    hist_cases,
    histogram_kernel,
    pack_cases,
    pack_kernel,
    pred_cases,
    predicate_kernel,
    wave_cases,
    wavefront_kernel,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,n", [(1, 5, 40), (3, 33, 1031), (20, 64, 1024),
                                   (1, 64, 5120), (2, 40, 8192)])
def test_pack_kernel_matches_plain(cuda, b, g, n):
    args = pack_cases.pack_case(b * 1000 + n, b, g, n)
    want = pack_kernel.pack_groups_batched_plain(*args)
    before = pack_kernel.pack_groups_batched.launches
    got = pack_kernel.pack_groups_batched(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert pack_kernel.pack_groups_batched.launches == before + 1
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(pack_cases.CASES))
def test_pack_kernel_edge_cases(cuda, name):
    args = pack_cases.CASES[name]()
    want = pack_kernel.pack_groups_batched_plain(*args)
    got = pack_kernel.pack_groups_batched(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    for field in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


@pytest.mark.cuda
def test_pack_kernel_rejects_what_it_does_not_take(cuda):
    free, mask, req, count, order, limit_one = [
        a.to(cuda) for a in pack_cases.pack_case(0, 2, 4, 64)]
    with pytest.raises(TypeError):
        pack_kernel.pack_groups_batched(free.long(), mask, req, count, order,
                                        limit_one)
    with pytest.raises(ValueError):
        pack_kernel.pack_groups_batched(free.transpose(1, 2).contiguous()
                                        .transpose(1, 2), mask, req, count,
                                        order, limit_one)
    with pytest.raises(ValueError):
        pack_kernel.pack_groups_batched(free, mask.cpu(), req, count, order,
                                        limit_one)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,style", [(5, 40, "mixed"), (33, 1031, "mixed"),
                                       (24, 2000, "negative"),
                                       (64, 5120, "disjoint"), (64, 5120, "overlap"),
                                       (40, 8192, "mixed")])
def test_wavefront_kernel_matches_plain(cuda, g, n, style):
    args = wave_cases.wave_case(g * 1000 + n, g, n,
                                style="disjoint" if style == "negative" else style)
    if style == "negative":                        # the formula's result
        args[3][::3] = -args[3][::3] - 1
    want = wavefront_kernel.pack_groups_wavefront_plain(*args)
    before = wavefront_kernel.pack_groups_wavefront.launches
    got = wavefront_kernel.pack_groups_wavefront(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert wavefront_kernel.pack_groups_wavefront.launches == before + 1
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_wavefront_kernel_one_wave_with_more_slots_than_warps(cuda):
    free, mask, req, count, limit_one, _ = wave_cases.wave_case(7, 64, 4096)
    mask.zero_()
    for gi in range(64):                           # a perfect partition
        mask[gi, gi * 64:(gi + 1) * 64] = True
    waves = pack.build_wavefront_plan(mask.numpy(), np.arange(64),
                                      device="cpu").waves
    assert tuple(waves.shape) == (4, 64)
    args = (free, mask, req, count, limit_one, waves)
    want = wavefront_kernel.pack_groups_wavefront_plain(*args)
    got = wavefront_kernel.pack_groups_wavefront(*[a.to(cuda) for a in args])
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_wavefront_kernel_rejects_what_it_does_not_take(cuda):
    free, mask, req, count, limit_one, waves = [
        a.to(cuda) for a in wave_cases.wave_case(0, 6, 64)]
    bad = waves.clone()
    bad[0, 0] = 6                                  # G = 6: out of range
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(free, mask, req, count,
                                               limit_one, bad)
    with pytest.raises(ValueError, match="contiguous"):
        wavefront_kernel.pack_groups_wavefront(free, mask.T.contiguous().T, req,
                                               count, limit_one, waves)
    with pytest.raises(ValueError):
        wavefront_kernel.pack_groups_wavefront(free, mask, req, count,
                                               limit_one, waves.cpu())
    checked = waves.clone()
    wavefront_kernel.pack_groups_wavefront(free, mask, req, count, limit_one,
                                           checked)
    checked[0, 0] = 6                              # an in-place edit is read again
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(free, mask, req, count,
                                               limit_one, checked)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(wave_cases.CASES))
def test_wavefront_kernel_cases(cuda, name):
    args = wave_cases.CASES[name]()
    want = wavefront_kernel.pack_groups_wavefront_plain(*args)
    got = wavefront_kernel.pack_groups_wavefront(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    for field in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("placement", [1, 2])
@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 16])
def test_wavefront_kernel_at_every_cluster_size(cuda, cluster, placement):
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits

    for name in ("partitioned plan: wave 0 of 5 live and 39 dead slots, G=64 N=5120",
                 "W == 1: 20 disjoint slots", "negative counts",
                 "N=40: fewer lanes than CTAs have warps, CTAs with no lane"):
        args = wave_cases.CASES[name]()
        n, r = args[0].shape
        if placement == 2 and -(-n // cluster) * (8 * r + 16) > 200_000:
            continue                      # the plane would not fit shared memory
        want = wavefront_kernel.pack_groups_wavefront_plain(*args)
        free, mask, req, count, limit_one, waves = [a.to(cuda) for a in args]
        got = wavefront_kernel.launch(free, pack_group_bits(mask), req, count,
                                      limit_one.to(torch.int32), waves,
                                      cluster=cluster, placement=placement)
        torch.cuda.synchronize()
        for field in ("placed", "scheduled", "free_after"):
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), \
                (name, field)


@pytest.mark.cuda
def test_wavefront_kernel_refuses_what_it_cannot_schedule(cuda):
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits

    free, mask, req, count, limit_one, waves = [
        a.to(cuda) for a in wave_cases.wave_case(0, 6, 64)]
    bits = (free, pack_group_bits(mask), req, count, limit_one.to(torch.int32),
            waves)
    with pytest.raises(RuntimeError, match="CUDA error"):
        wavefront_kernel.launch(*bits, cluster=17)     # above the cluster limit
    # shared memory beyond the opt-in limit: a plan of a million waves
    many = torch.full((1 << 20, 1), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        wavefront_kernel.launch(*bits[:5], many)
    # a free plane in shared memory that no CTA can hold
    with pytest.raises(RuntimeError, match="CUDA error"):
        wavefront_kernel.config(6, 400_000, 8, 4, cluster=8, placement=2)
    cfg = wavefront_kernel.config(6, 64, 8, 4)
    assert cfg["cluster"] in (8, 16) and cfg["plane"] == "shared memory"
    # beyond shared memory the plane stays in device memory; the mask words
    # and chunk sums (G/4 bytes a lane of a CTA) bound N: at G=64 and C=16
    # about 210,000 lanes
    assert wavefront_kernel.config(64, 200_000, 8, 4, cluster=16)["plane"] == \
        "device memory"
    with pytest.raises(RuntimeError, match="CUDA error"):
        wavefront_kernel.config(64, 240_000, 8, 4, cluster=16)


@pytest.mark.cuda
def test_pack_kernel_on_sidecar_batched_inputs(cuda):
    """K1 on what a batched ScaleUpSim hands it: two tenants' worlds decoded
    by the codec, resident at their shape class (N=1,024), stacked as the
    sidecar stacks a window, and on each lane the filter arguments (B=1)
    and the option arguments (B=node groups, max_new_nodes bins)."""
    from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import _lane
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.schedule import (
        filter_pack_inputs,
        schedule_pending_on_existing,
    )
    from kubernetes_autoscaler_tpu_torch.sidecar import batch
    from kubernetes_autoscaler_tpu_torch.sidecar.server import (
        SimParams,
        SimulatorService,
    )
    from kubernetes_autoscaler_tpu_torch.sidecar.wire import DeltaWriter
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    mib = 1024 * 1024
    params = SimParams(max_new_nodes=64, node_groups=[
        {"id": f"ng{c}", "max_new": 32, "price": 1.0 + c,
         "template": {"name": f"t{c}", "capacity": {
             "cpu": 4.0 * c, "memory": 8192 * c * mib, "pods": 110}}}
        for c in (1, 2, 4)])
    svc = SimulatorService(device=cuda)
    lanes = []
    try:
        for t in range(2):
            w = DeltaWriter()
            for i in range(600 + 100 * t):
                w.upsert_node(build_test_node(
                    f"n{i}", cpu_milli=(4000, 8000, 16000)[i % 3],
                    mem_mib=16384))
                w.upsert_pod(build_test_pod(
                    f"r{i}", cpu_milli=1500, mem_mib=1024,
                    owner_name=f"rs{i % 7}", node_name=f"n{i}"), movable=True)
            for i in range(3000):
                w.upsert_pod(build_test_pod(
                    f"p{i}", cpu_milli=250 * (1 + i % 5), mem_mib=512,
                    owner_name=f"prs{(i + t) % 25}"))
            assert svc.apply_delta(w.payload(), tenant=f"t{t}")["error"] == ""
            ts = svc._tenant(f"t{t}")
            with ts.lock:
                nodes, groups, pods = svc._export_dev(ts)
            _ng, ids, _r, _d, ng_dev = svc._ng_np(ts, params)
            lanes.append(batch.UpLane(nodes=nodes, groups=groups, pods=pods,
                                      ng=ng_dev, ids=ids))
        nt, gt, pt, gr = batch.stack_up_lanes(lanes)
        assert nt.n == 2 and nt.cap.shape[1] == 1024
        for b in range(2):
            n1, g1, p1, r1 = (_lane(x, b) for x in (nt, gt, pt, gr))
            filt = [x[None].contiguous() if i < 2 else x for i, x in
                    enumerate(filter_pack_inputs(n1, g1, p1))]
            packed = schedule_pending_on_existing(n1, g1, p1)
            rest = g1.replace(count=torch.clamp(g1.count - packed.scheduled,
                                                min=0))
            opts, _ = option_pack_inputs(rest, r1, svc.dims, 64)
            for name, args in (("filter", filt), ("options", list(opts))):
                want = pack_kernel.pack_groups_batched_plain(*args)
                got = pack_kernel.pack_groups_batched(*args)
                for field in ("placed", "scheduled", "free_after"):
                    assert torch.equal(getattr(got, field),
                                       getattr(want, field)), (b, name, field)
    finally:
        svc.close()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(hist_cases.CASES))
def test_histogram_kernel_cases(cuda, name, monkeypatch):
    """Every bin and total byte-equal to the plain version's sum in sample
    order on the CPU: one call of the C entry, no read to the host, and no
    library sort on the way."""
    args = hist_cases.CASES[name]()
    dev_args = [a.to(cuda) for a in args]
    histogram_kernel.scatter_add_ordered_plain(*args)
    before = histogram_kernel.scatter_add_ordered.launches

    def no_sort(*a, **kw):
        raise AssertionError("a library sort on the scatter's card route")

    torch.cuda.synchronize()
    with monkeypatch.context() as m:
        m.setattr(torch, "sort", no_sort)
        m.setattr(torch, "argsort", no_sort)
        torch.cuda.set_sync_debug_mode("error")
        try:
            histogram_kernel.scatter_add_ordered(*dev_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert histogram_kernel.scatter_add_ordered.launches == before + 1
    for got, want in zip(dev_args[:2], args[:2]):
        assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
def test_histogram_workspace_matches_the_entry(cuda):
    """The wrapper sizes the workspace as the C entry does
    (`ka_hist_workspace`), over one to four sort passes and ragged tiles;
    a workspace one word short is refused."""
    import ctypes

    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    lib = load(histogram_kernel.SOURCE)
    lib.ka_hist_workspace.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.ka_hist_workspace.restype = ctypes.c_int64
    for n in (1, 2047, 2048, 2049, 100_000, 3_840_000):
        for a in (1, 255, 256, 33_790, 65_535, 65_536, 70_000, 2 ** 24 + 1):
            assert lib.ka_hist_workspace(n, a) == \
                histogram_kernel.workspace_words(n, a), (n, a)
    weights, total, agg, bucket, w = [
        x.to(cuda) for x in hist_cases.hist_case(0, 8, 50)]
    ws = torch.empty((histogram_kernel.workspace_words(50, 8) - 1,),
                     dtype=torch.int32, device=cuda)
    rc = histogram_kernel._entry()(
        agg.data_ptr(), bucket.data_ptr(), w.data_ptr(), weights.data_ptr(),
        total.data_ptr(), ws.data_ptr(), ws.numel(), 50, 8, weights.shape[1],
        0, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


@pytest.mark.cuda
@pytest.mark.parametrize("row,bucket", hist_cases.OUT_OF_BANK)
def test_histogram_kernel_reads_indices_outside_the_bank_as_plain(
        cuda, row, bucket):
    """A row or bucket outside the bank or counted from its end: the
    kernel equals the plain version byte for byte (which equals JAX's
    `_scatter_add` on the CPU, tests/test_torch_vpa.py), with one launch
    and no read to the host."""
    for n in (1, 100):
        args = hist_cases.out_of_bank_case(row, bucket, n)
        dev_args = [a.to(cuda) for a in args]
        histogram_kernel.scatter_add_ordered_plain(*args)
        before = histogram_kernel.scatter_add_ordered.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            histogram_kernel.scatter_add_ordered(*dev_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert histogram_kernel.scatter_add_ordered.launches == before + 1
        assert torch.equal(dev_args[0].cpu(), args[0]), n
        assert torch.equal(dev_args[1].cpu(), args[1]), n


@pytest.mark.cuda
def test_histogram_kernel_rejects_what_it_does_not_take(cuda):
    weights, total, agg, bucket, w = [
        a.to(cuda) for a in hist_cases.hist_case(0, 8, 50)]
    f = histogram_kernel.scatter_add_ordered
    with pytest.raises(TypeError):
        f(weights, total, agg.long(), bucket, w)
    with pytest.raises(ValueError):
        f(weights, total, agg.cpu(), bucket, w)
    with pytest.raises(ValueError):
        f(weights, total[:4], agg, bucket, w)


# --------------------------------------------- the constrained wave placer


def _con_outputs(case, device):
    """(kernel outputs on the card, plain outputs on the CPU) of a case: a
    "place" case through place_lanes, a "pack" case through pack_lanes,
    one launch and no read to the host."""
    want = case.run(constrained_kernel.place_lanes,
                    constrained_kernel.pack_lanes)
    case = case.to(device)
    before = constrained_kernel.launch.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = case.run(constrained_kernel.place_lanes,
                       constrained_kernel.pack_lanes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert constrained_kernel.launch.launches == before + 1
    return [g.cpu() for g in got], want


def _assert_con_equal(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), f"output {k} differs from the plain version"


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fit", "device"])
@pytest.mark.parametrize("name", list(con_cases.CASES))
def test_constrained_kernel_cases(cuda, name, plane, monkeypatch):
    """Every case, with the slices where they fit (shared memory at these
    widths) and forced into device memory."""
    if plane == "device":
        monkeypatch.setattr(constrained_kernel, "launch_choice",
                            lambda b, n, r, z: (0, 1))
    _assert_con_equal(*_con_outputs(con_cases.CASES[name](), cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(con_cases.CASES))
def test_constrained_kernel_pack_entry_on_place_cases(cuda, name):
    """A "place" case as one pack_lanes call of its lanes
    (con_cases.as_pack): the pack entry's branches on the same inputs."""
    case = con_cases.CASES[name]()
    _assert_con_equal(*_con_outputs(con_cases.as_pack(case), cuda))


@pytest.mark.cuda
def test_place_group_constrained_on_the_card(cuda):
    """`ops/constrained.place_group_constrained` at the constrained world's
    width (N = 5,120, R = 8, one zone-spread group, 128 waves): one launch
    of the place entry, no read to the host, byte-equal to the CPU."""
    from kubernetes_autoscaler_tpu_torch.ops import constrained

    args = con_cases.group_case()
    want = constrained.place_group_constrained(*args)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    dev[5] = constrained.GroupConstraints(
        **{k: v.to(cuda) for k, v in vars(args[5]).items()})
    counter = constrained_kernel.wave_counter(cuda)
    counter.zero_()
    before = constrained_kernel.launch.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = constrained.place_group_constrained(*dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert constrained_kernel.launch.launches == before + 1
    assert int(counter) == constrained.MAX_WAVES
    _assert_con_equal([g.cpu() for g in got], want)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [2, 16])
@pytest.mark.parametrize("name", list(con_cases.CASES))
def test_constrained_kernel_cluster_sizes(cuda, name, cluster, monkeypatch):
    """Every case on a cluster of 2 and of 16 CTAs a lane (at these widths
    a slice of a few nodes, some empty): the exchanges, the zone carry
    across CTAs and the slice edges."""
    monkeypatch.setattr(constrained_kernel, "launch_choice",
                        lambda b, n, r, z: (cluster, 0))
    _assert_con_equal(*_con_outputs(con_cases.CASES[name](), cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["filter", "options", "global"])
def test_constrained_kernel_main_path_shapes(cuda, shape):
    """B = 1 at the filter's N (a cluster of 16), B = 24 at the options' N
    (one CTA a lane), and N = 6,144 (past one CTA's shared memory; its
    slices fit)."""
    case = {
        "filter": lambda: con_cases.pack_case(1, 1, 64, 5120, r=8,
                                              count_max=2000),
        "options": lambda: con_cases.pack_case(2, 24, 64, 1024, r=8,
                                               lane_zone=True),
        "global": lambda: con_cases.pack_case(4, 2, 8, 6144, r=8,
                                              count_max=3000),
    }[shape]()
    b, n, r = case.args[0].shape
    cfg = constrained_kernel.config(b, n, r, con_cases.Z)
    assert cfg["smem_plane"]
    assert cfg["cluster"] == {"filter": 16, "options": 1, "global": 16}[shape]
    _assert_con_equal(*_con_outputs(case, cuda))


@pytest.mark.cuda
def test_constrained_kernel_counts_its_waves(cuda):
    """The device counter adds each lane's waves: the MAX_WAVES case runs
    exactly the cap; a call under sync debug mode "error" reads nothing."""
    counter = constrained_kernel.wave_counter(cuda)
    counter.zero_()
    case = con_cases.CASES["max_waves"]().to(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        case.run(constrained_kernel.place_lanes, constrained_kernel.pack_lanes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(counter) == constrained_kernel._con.MAX_WAVES


@pytest.mark.cuda
def test_constrained_kernel_rejects_what_it_does_not_take(cuda):
    case = con_cases.CASES["drain_lanes"]().to(cuda)
    free, feas, req, want, limit, cons, z = case.args
    f = constrained_kernel.place_lanes
    with pytest.raises(TypeError):
        f(free.long(), feas, req, want, limit, cons, z)
    with pytest.raises(ValueError):
        f(free, feas.cpu(), req, want, limit, cons, z)
    with pytest.raises(ValueError):
        f(free, feas[:, :-1], req, want, limit, cons, z)
    with pytest.raises(ValueError):
        f(free.transpose(1, 2).contiguous().transpose(1, 2), feas, req, want,
          limit, cons, z)
    # the kernel places one group a lane: equal to the plain version
    got = f(free, feas, req, want, limit, cons, z)
    want_plain = constrained_kernel.place_lanes_plain(
        *con_cases.CASES["drain_lanes"]().args)
    _assert_con_equal([g.cpu() for g in got], want_plain)
    pack = con_cases.CASES["mixed_pack"]().to(cuda)
    free, mask, req, count, order, limit, cons, z = pack.args
    g = constrained_kernel.pack_lanes
    with pytest.raises(TypeError):
        g(free, mask, req, count.long(), order, limit, cons, z)
    with pytest.raises(ValueError):
        g(free, mask, req, count, order.cpu(), limit, cons, z)
    with pytest.raises(ValueError):
        g(free, mask, req, count, order, limit, cons, z + 1)


def _drain_equal(inp, kk, plain_device=None):
    """The kernel on `inp` (CUDA tensors) against the plain version (on
    `plain_device`, the CPU by default), in both modes: one launch each."""
    dev = torch.device(plain_device or "cpu")
    for explain in (False, True):
        want = drain_kernel.sweep_plain(inp.to(dev), kk, explain)
        before = drain_kernel.launch.launches
        got = drain_kernel.sweep(inp, kk, explain)
        torch.cuda.synchronize()
        assert drain_kernel.launch.launches == before + 1
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, (explain, k)
            assert torch.equal(g.cpu(), w.cpu()), \
                f"output {k} (explain={explain}) differs from the plain version"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(drain_cases.CASES))
def test_drain_kernel_cases(cuda, name):
    case = drain_cases.CASES[name]().to(cuda)
    _drain_equal(case.inputs(), case.max_groups_per_node)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["main", "loop", "sidecar", "gate"])
def test_drain_kernel_main_path_shapes(cuda, shape):
    """[main]'s sweep (N = 5,120, G = 64, MPN = 128, K = 16, every node a
    candidate), the loop's MPN = 16, a sidecar large lane's N = 8,192, the
    what-if gate's N = 48; the plain version on the card."""
    case = {
        "main": lambda: drain_cases.world(0, 5120, 64, 128),
        "loop": lambda: drain_cases.world(1, 5120, 64, 16),
        "sidecar": lambda: drain_cases.world(2, 8192, 64, 128),
        "gate": lambda: drain_cases.world(3, 48, 64, 128),
    }[shape]().to(cuda)
    _drain_equal(case.inputs(), case.max_groups_per_node, plain_device=cuda)


@pytest.mark.cuda
def test_drain_kernel_one_launch_a_sweep_and_no_host_read(cuda):
    """`simulate_removals` and `failure_reasons` on CUDA tensors: one launch
    each, equal to the CPU's, nothing read back to the host; no candidate,
    no launch."""
    case = drain_cases.CASES["spill"]()
    kw = dict(max_pods_per_node=case.max_pods_per_node,
              max_groups_per_node=case.max_groups_per_node)
    args = (case.nodes, case.specs, case.scheduled, case.candidates,
            case.dest_allowed)
    want = (drain.simulate_removals(*args, **kw),
            drain.failure_reasons(*args, **kw))
    card = case.to(cuda)
    args = (card.nodes, card.specs, card.scheduled, card.candidates,
            card.dest_allowed)
    before = drain_kernel.launch.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (drain.simulate_removals(*args, **kw),
               drain.failure_reasons(*args, **kw))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert drain_kernel.launch.launches == before + 2
    for w, g in zip(want, got):
        for k, v in vars(w).items():
            assert torch.equal(getattr(g, k).cpu(), v), k
    none = card.candidates[:0]
    res = drain.simulate_removals(*args[:3], none, args[4], **kw)
    assert drain_kernel.launch.launches == before + 2
    assert res.dest_node.shape == (0, case.max_pods_per_node)


@pytest.mark.cuda
def test_drain_kernel_counts_the_nodes_its_slots_need(cuda):
    """No allowed destination: every filled slot needs all N nodes."""
    case = drain_cases.CASES["no_destination"]()
    inp = case.inputs()
    kk = case.max_groups_per_node
    _, _, _, n_failed, _, _ = drain_kernel.sweep_plain(inp, kk, False)
    counter = drain_kernel.node_counter(cuda)
    counter.zero_()
    drain_kernel.sweep(inp.to(cuda), kk, False)
    torch.cuda.synchronize()
    # a failed candidate's filled slots each swept every node
    slots = 0
    for c, nf in zip(inp.candidates.tolist(), n_failed.tolist()):
        if nf:
            on = (inp.node_idx == c) & inp.valid & inp.movable
            slots += min(len(set(inp.group_ref[on].tolist())), kk)
    assert int(counter) == slots * inp.free.shape[0]


@pytest.mark.cuda
def test_drain_kernel_rejects_what_it_does_not_take(cuda):
    case = drain_cases.CASES["mixed"]().to(cuda)
    inp = case.inputs()
    f = drain_kernel.sweep
    with pytest.raises(TypeError):
        f(inp.replace(req=inp.req.long()), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(feas=inp.feas.cpu()), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(node_idx=inp.node_idx[:-1]), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(free=inp.free.t().contiguous().t()), 4, False)
    # a window past 1,024 places, and shared memory past the card's limit
    wide = torch.cat([inp.pad_order,
                      torch.full((1100,), -1, dtype=torch.int32, device=cuda)])
    with pytest.raises(ValueError):
        f(inp.replace(pad_order=wide), 4, False)
    n = 200_000
    with pytest.raises(ValueError):
        drain_kernel.threads(n, 4, 16, 4)


# ------------------------------------------- the drain sweep's topology mode


def _topo_equal(inp, topo, kk, plain_device=None):
    """The kernel's topology mode on `inp`, `topo` (CUDA tensors) against
    the plain version (on `plain_device`, the CPU by default), in both
    modes: one drain launch each and no wave placer launch. Returns the
    kernel's (lane-waves, waved lanes) of the sweep and the plain version's
    active lanes."""
    dev = torch.device(plain_device or "cpu")
    counter = drain_kernel.wave_counter(inp.free.device)
    for explain in (False, True):
        lanes = drain_kernel.sweep_plain.active_lanes
        want = drain_kernel.sweep_plain(inp.to(dev), kk, explain,
                                        topo=topo.to(dev))
        lanes = drain_kernel.sweep_plain.active_lanes - lanes
        before = (drain_kernel.launch.launches,
                  constrained_kernel.launch.launches)
        counter.zero_()
        got = drain_kernel.sweep(inp, kk, explain, topo=topo)
        torch.cuda.synchronize()
        assert (drain_kernel.launch.launches,
                constrained_kernel.launch.launches) == \
            (before[0] + 1, before[1])
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, (explain, k)
            assert torch.equal(g.cpu(), w.cpu()), \
                f"output {k} (explain={explain}) differs from the plain version"
        waves, waved = counter.tolist()
        assert waved == lanes and waves >= lanes
        if not explain:
            out = (waves, waved, lanes)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(drain_topo_cases.CASES))
def test_drain_topo_kernel_cases(cuda, name):
    case = drain_topo_cases.CASES[name]().to(cuda)
    inp, topo = case.inputs()
    _, waved, _ = _topo_equal(inp, topo, case.max_groups_per_node)
    assert waved > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["constrained", "sidecar", "wide_zones"])
def test_drain_topo_kernel_every_lane_active(cuda, shape):
    """Every (candidate, slot) lane with pods re-places by waves: at
    [constrained]'s widths (N = 5,120, G = 64, MPN = 128, K = 16, Z = 16;
    1,280 candidates), at a sidecar lane's N = 8,192 and at N = 1,031 with
    K = 6; the plain version on the card."""
    case = {
        "constrained": lambda: drain_topo_cases.world(0, 5120, 64, 128,
                                                      candidates=1280),
        "sidecar": lambda: drain_topo_cases.world(1, 8192, 64, 128,
                                                  candidates=256),
        "wide_zones": lambda: drain_topo_cases.world(2, 1031, 12, 24, kk=6),
    }[shape]().to(cuda)
    inp, topo = case.inputs()
    waves, waved, lanes = _topo_equal(inp, topo, case.max_groups_per_node,
                                      plain_device=cuda)
    assert waved == lanes > 0


@pytest.mark.cuda
def test_drain_topo_one_launch_no_wave_placer_and_no_host_read(cuda):
    """`simulate_removals(..., with_constraints=True)` on CUDA tensors: one
    drain launch, no wave placer launch, no plain sweep, nothing read back
    to the host; equal to the CPU's."""
    case = drain_topo_cases.CASES["every_kind"]()
    kw = dict(max_pods_per_node=case.max_pods_per_node,
              max_groups_per_node=case.max_groups_per_node,
              max_zones=case.max_zones, with_constraints=True)

    def args(c):
        return (c.nodes, c.specs, c.scheduled, c.candidates, c.dest_allowed)

    want = drain.simulate_removals(*args(case), planes=case.planes, **kw)
    card = case.to(cuda)
    before = (drain_kernel.launch.launches, constrained_kernel.launch.launches,
              drain_kernel.sweep_plain.active_lanes,
              constrained_kernel.place_lanes.waves,
              constrained_kernel.place_lanes.flag_reads)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = drain.simulate_removals(*args(card), planes=card.planes, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (drain_kernel.launch.launches, constrained_kernel.launch.launches,
            drain_kernel.sweep_plain.active_lanes,
            constrained_kernel.place_lanes.waves,
            constrained_kernel.place_lanes.flag_reads) == \
        (before[0] + 1,) + before[1:]
    for k, v in vars(want).items():
        assert torch.equal(getattr(got, k).cpu(), v), k


@pytest.mark.cuda
def test_drain_topo_kernel_counts_its_waves(cuda):
    """The MAX_WAVES case: its one waved lane runs exactly the cap."""
    case = drain_topo_cases.CASES["max_waves"]().to(cuda)
    inp, topo = case.inputs()
    counter = drain_kernel.wave_counter(cuda)
    counter.zero_()
    drain_kernel.sweep(inp, case.max_groups_per_node, False, topo=topo)
    torch.cuda.synchronize()
    waves, waved = counter.tolist()
    assert waved >= 1 and waves >= constrained_kernel._con.MAX_WAVES
    one = drain_topo_cases.CASES["max_waves"]().to(cuda)
    one.candidates = one.candidates[3:4]
    inp, topo = one.inputs()
    counter.zero_()
    drain_kernel.sweep(inp, one.max_groups_per_node, False, topo=topo)
    torch.cuda.synchronize()
    assert counter.tolist() == [constrained_kernel._con.MAX_WAVES, 1]


@pytest.mark.cuda
def test_drain_topo_kernel_rejects_what_it_does_not_take(cuda):
    case = drain_topo_cases.CASES["mixed_slots"]().to(cuda)
    inp, topo = case.inputs()
    f = drain_kernel.sweep
    with pytest.raises(TypeError):
        f(inp, 4, False, topo=topo.replace(aff_cnt=topo.aff_cnt.long()))
    with pytest.raises(ValueError):
        f(inp, 4, False, topo=topo.replace(s_elig=topo.s_elig.cpu()))
    with pytest.raises(ValueError):
        f(inp, 4, False, topo=topo.replace(elig_zone=topo.elig_zone[:-1]))
    with pytest.raises(ValueError):
        f(inp, 4, False,
          topo=topo.replace(spread_cnt=topo.spread_cnt.t().contiguous().t()))
    # more zones than the CTA has threads
    z = 300
    wide = {k: torch.zeros((v.shape[0], z), dtype=v.dtype, device=cuda)
            for k, v in vars(topo).items() if k.endswith("_zone")}
    with pytest.raises(ValueError):
        f(inp, 4, False, topo=topo.replace(**wide))


# ---- the predicate plane (csrc/predicates.cu)


def _pred_equal(case, func):
    """FUNCTIONS[func] on the card's case: one launch, byte-equal to the
    plain version on the same CUDA tensors."""
    want = predicate_kernel.plane_plain(*pred_cases.plane_args(func, case))
    before = predicate_kernel.launch.launches
    got = pred_cases.public(func, predicates, case.nodes, case.specs,
                            case.group_mask)
    torch.cuda.synchronize()
    assert predicate_kernel.launch.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), func


@pytest.mark.cuda
@pytest.mark.parametrize("func", list(pred_cases.FUNCTIONS))
@pytest.mark.parametrize("name", list(pred_cases.CASES))
def test_predicate_kernel_cases(cuda, name, func):
    _pred_equal(pred_cases.CASES[name]().to(cuda), func)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["filter", "templates", "sidecar"])
def test_predicate_kernel_main_path_shapes(cuda, shape):
    """The main path's shapes at Dims(): the filter's and the drain's G=64
    x N=5,120, the templates' G=64 x NG=24, a sidecar lane's N=8,192."""
    n, g = {"filter": (5120, 64), "templates": (24, 64),
            "sidecar": (8192, 64)}[shape]
    case = pred_cases.world(n + g, n, g).to(cuda)
    for func in pred_cases.FUNCTIONS:
        _pred_equal(case, func)


def _pred_resident_equal(case, checks, mask=None):
    """The plane with the case's resident pods on the card: one call,
    byte-equal to the plain version on the same CUDA tensors."""
    args = (case.nodes, case.specs, checks, False, mask, case.scheduled)
    want = predicate_kernel.plane_plain(*args)
    before = predicate_kernel.launch.launches
    got = predicate_kernel.plane(*args)
    torch.cuda.synchronize()
    assert predicate_kernel.launch.launches == before + 1
    assert got.dtype == want.dtype == torch.bool
    assert torch.equal(got, want), (checks, mask is None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(pred_cases.CASES))
def test_predicate_kernel_resident_cases(cuda, name):
    """Every case with its resident pods (indices outside the plane among
    them), the static and the full checks, with and without the mask."""
    case = pred_cases.CASES[name]().to(cuda)
    for checks in (predicate_kernel.STATIC, predicate_kernel.ALL_CHECKS):
        for mask in (None, case.group_mask):
            _pred_resident_equal(case, checks, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 33, 200])
def test_predicate_kernel_group_widths(cuda, g):
    """N = 1,031 (past a tile of 32, a partial last one) at `Dims()` with
    one group, 33 (two resident words) and 200 (four chunks of groups):
    every public function, both kinds, and the resident term."""
    case = pred_cases.world(g, 1031, g).to(cuda)
    for func in pred_cases.FUNCTIONS:
        _pred_equal(case, func)
    for checks in (predicate_kernel.STATIC, predicate_kernel.ALL_CHECKS):
        for mask in (None, case.group_mask):
            _pred_resident_equal(case, checks, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3])
def test_predicate_kernel_misaligned_planes(cuda, k):
    """Every plane a view k elements into its buffer: no slice starts on a
    16-byte boundary, so the edges of each bulk copy go by plain loads."""
    for name in ("random", "residents", "wide"):
        case = pred_cases.shifted(pred_cases.CASES[name]().to(cuda), k)
        assert case.nodes.label_hash.data_ptr() % 16 != 0
        for func in pred_cases.FUNCTIONS:
            _pred_equal(case, func)
        for checks in (predicate_kernel.STATIC, predicate_kernel.ALL_CHECKS):
            _pred_resident_equal(case, checks, case.group_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("with_constraints", [False, True])
def test_predicate_fused_step_runs_no_plain_resident_term(cuda, monkeypatch,
                                                          with_constraints):
    """The fused step on the card builds the filter's and the drain's
    planes with the resident term inside row P: `resident_group_counts`
    (the plain version's term) is called nowhere, and each plane is byte-
    equal to the plain version's."""
    from torch_parity import PORT, build_world, encode_world

    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, schedule

    def refuse(*a, **kw):
        raise AssertionError("resident_group_counts on the card's path")

    enc, groups = encode_world(PORT, build_world(PORT, seed=0, pools=3),
                               device=cuda)
    calls = []
    real = predicate_kernel.plane

    def plane(*a, **kw):
        calls.append(predicate_kernel.bind_args(*a, **kw))
        return real(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(predicate_kernel, "resident_group_counts", refuse)
        m.setattr(schedule, "resident_group_counts", refuse)
        m.setattr(predicate_kernel, "plane", plane)
        autoscale_step.run_once_fused(
            enc.nodes, enc.specs, enc.scheduled, groups,
            torch.full((groups.ng,), 16, dtype=torch.int32, device=cuda),
            Dims(), max_new_nodes=16, max_pods_per_node=32,
            planes=enc.planes, with_constraints=with_constraints)
        torch.cuda.synchronize()
    resident = [c for c in calls if c[5] is not None]
    assert len(resident) == 2
    for args in resident:
        assert torch.equal(real(*args), predicate_kernel.plane_plain(*args))


@pytest.mark.cuda
def test_predicate_kernel_every_check_subset(cuda):
    """Every subset of the checks, both kinds, with and without a group
    mask, on the widest case."""
    case = pred_cases.CASES["wide"]().to(cuda)
    for checks in range(1, predicate_kernel.ALL_CHECKS + 1):
        for bits in (False, True):
            for mask in (None, case.group_mask):
                args = (case.nodes, case.specs, checks, bits, mask)
                got = predicate_kernel.plane(*args)
                want = predicate_kernel.plane_plain(*args)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (checks, bits, mask is None)


@pytest.mark.cuda
def test_predicate_kernel_reads_nothing_back(cuda):
    case = pred_cases.world(1, 5120, 64).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        predicates.feasibility_mask(case.nodes, case.specs, False)
        predicates.reason_mask_for_groups(case.nodes, case.specs,
                                          case.group_mask)
        predicate_kernel.plane(case.nodes, case.specs,
                               predicate_kernel.STATIC,
                               scheduled=case.scheduled)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_predicate_smem_matches_the_entry(cuda):
    """The wrapper's shared-memory reckoning is the C entry's
    (`ka_pred_smem`), for every check subset, with and without residents,
    at three sets of widths and at widths that make the group chunk
    halve."""
    import ctypes

    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    lib = load(predicate_kernel.SOURCE)
    lib.ka_pred_smem.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                 ctypes.c_int]
    lib.ka_pred_smem.restype = ctypes.c_int64
    widths = []
    for name in ("wide", "narrow", "residents"):
        case = pred_cases.CASES[name]()
        widths.append(predicate_kernel.check_inputs(
            case.nodes, case.specs, predicate_kernel.ALL_CHECKS)[0])
    widths.append(dict(widths[0], G=300, S=40, A=30, Sn=50, PP=200))
    for d in widths:
        for checks in range(1, predicate_kernel.ALL_CHECKS + 1):
            for resident in (0, 1):
                dims = (ctypes.c_int * len(predicate_kernel.DIMS))(
                    *[d[k] for k in predicate_kernel.DIMS])
                assert lib.ka_pred_smem(dims, checks, resident) == \
                    predicate_kernel.smem_bytes(d, checks, bool(resident)), \
                    (d, checks, resident)


@pytest.mark.cuda
def test_predicate_kernel_rejects_what_it_does_not_take(cuda):
    case = pred_cases.CASES["random"]().to(cuda)
    nd, sp = case.nodes, case.specs
    f = predicate_kernel.plane
    with pytest.raises(ValueError):
        f(nd, sp, predicate_kernel.STATIC, True, case.group_mask.cpu())
    with pytest.raises(ValueError):
        f(nd.replace(used_ports=nd.used_ports.cpu()), sp,
          predicate_kernel.STATIC)
    with pytest.raises(TypeError):
        f(nd, sp.replace(req=sp.req.long()), predicate_kernel.ALL_CHECKS)
    with pytest.raises(ValueError):
        f(nd.replace(label_hash=nd.label_hash.t().contiguous().t()), sp,
          predicate_kernel.SELECTOR)
    sc = case.scheduled
    static = predicate_kernel.STATIC
    with pytest.raises(ValueError):   # the reason kind takes no residents
        f(nd, sp, static, True, None, sc)
    with pytest.raises(ValueError):   # residents on the CPU
        f(nd, sp, static, False, None, sc.replace(valid=sc.valid.cpu()))
    with pytest.raises(TypeError):
        f(nd, sp, static, False, None,
          sc.replace(node_idx=sc.node_idx.long()))
    with pytest.raises(ValueError):
        f(nd, sp, static, False, None,
          sc.replace(group_ref=sc.group_ref[1:]))
    with pytest.raises(ValueError):
        f(nd, sp.replace(anti_affinity_self=sp.anti_affinity_self[1:]),
          static, False, None, sc)
