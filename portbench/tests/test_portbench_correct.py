"""What decides `correct`, on the CPU at a small size: the port's decisions
pass against the reference; the bfloat16 control and each fault that a
cell can have, planted in the timed path, come out as not correct."""

import dataclasses

import pytest
import torch

from portbench import judge, spec
from portbench.control import control_numbers
from portbench.program import Program
from portbench.tests.conftest import CELLS, SEED, SMALL, SMALL_TRAFFIC, small_run


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_the_reference(cell):
    res = small_run(cell)
    assert res["correct"], res["limits"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert list(res)[-1] == "limits"
    # on the CPU every end-to-end metric but those of the device trace
    assert set(res["metrics"]) == {
        m["name"] for m in spec.metrics_for(spec.benchmark(), "end_to_end", cell)
        if m["source"] != "device_trace"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails(cell):
    w = spec.cell(spec.benchmark(), cell)
    cfg = {**spec.load("configs", w["config"]), **SMALL}
    traffic = {**spec.load("traffic", w["traffic"]),
               **SMALL_TRAFFIC[w["traffic"]]}
    numbers = control_numbers(cfg, traffic, SEED)
    assert not judge.verdict(numbers), numbers


def test_the_reference_refuses_constrained_pending_pods():
    """Its semantics leave out topology constraints: a world whose pending
    pods carry one is refused, not decided without them."""
    from portbench import world
    from portbench.reference import decide as ref

    cfg = {**spec.load("configs", "ca-5k-affinity"), **SMALL}
    traffic = {**spec.load("traffic", "steady"), **SMALL_TRAFFIC["steady"]}
    with pytest.raises(NotImplementedError):
        ref.decide(cfg, traffic, world.variants(cfg, traffic, SEED)[0])


class Unchanged(Program):
    """A step that returns its state unchanged: nothing placed, every pod
    still pending, the allocations as they came in."""

    def decide(self, v, on_phase=None):
        d = super().decide(v, on_phase)
        (nodes, specs, *_), _ = self.calls[v]
        return dataclasses.replace(d, verdict=torch.zeros_like(d.verdict),
                                   pending_after=specs.count.clone(),
                                   alloc_after=nodes.alloc.clone())


class HalfTheGroups(Program):
    """Half of the batch left out: the second half of the pending groups
    is dropped before the decision."""

    def decide(self, v, on_phase=None):
        (nodes, specs, *rest), kw = self.calls[v]
        count = specs.count.clone()
        count[count.shape[0] // 2:] = 0
        args = (nodes, specs.replace(count=count), *rest)
        decision, _ = self._step(*args, **kw, on_phase=on_phase)
        return decision


class OneAnswerAltered(Program):
    """An answer altered where it is produced: one node's drain verdict
    flipped."""

    def decide(self, v, on_phase=None):
        d = super().decide(v, on_phase)
        drainable = d.drainable.clone()
        drainable[0] = ~drainable[0]
        return dataclasses.replace(d, drainable=drainable)


@pytest.mark.parametrize("fault", [Unchanged, HalfTheGroups, OneAnswerAltered])
@pytest.mark.parametrize("cell", ["ca-5k.steady"])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    res = small_run(cell, program_cls=fault)
    assert not res["correct"], res["limits"]
    assert res["failed"] > 0


def test_consolidate_catches_an_altered_answer():
    res = small_run("ca-5k-affinity.consolidate", program_cls=OneAnswerAltered)
    assert not res["correct"]


def test_traced_run_on_the_cpu_keeps_its_result_shape():
    res = small_run("ca-5k.steady", trace=True)
    assert res["correct"]
    # on the CPU only the host clock has something to read
    assert set(res["metrics"]) == {
        m["name"] for m in spec.metrics_for(spec.benchmark(), "per_layer",
                                            "ca-5k.steady")
        if m["source"] == "host_clock"}
    assert "busy_s" not in res["device"]
