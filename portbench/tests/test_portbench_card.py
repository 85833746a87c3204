"""On a card: a short run of each cell at a small size is correct, the
control is not, and the result line names the card. Skips without CUDA."""

import pytest

from portbench import judge, spec
from portbench.control import control_numbers
from portbench.tests.conftest import CELLS, SEED, SMALL, SMALL_TRAFFIC


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card(card, cell):
    from portbench import run

    traffic = cell.split(".")[1]
    res = run.run_cell(cell, SEED, 1.0, True, device=card, cfg_overrides=SMALL,
                       traffic_overrides=SMALL_TRAFFIC[traffic])
    assert res["correct"], res["limits"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    bench = spec.benchmark()
    # every per-layer metric the cell lists finds something to read
    assert set(res["metrics"]) == {
        m["name"] for m in spec.metrics_for(bench, "per_layer", cell)}
    w = spec.cell(bench, cell)
    cfg = {**spec.load("configs", w["config"]), **SMALL}
    numbers = control_numbers(cfg, {**spec.load("traffic", w["traffic"]),
                                    **SMALL_TRAFFIC[traffic]}, SEED)
    assert not judge.verdict(numbers), numbers
