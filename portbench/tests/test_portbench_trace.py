"""The reduction of a profiler trace, on hand-made events."""

import types

import torch

from portbench.trace import Traced


def ev(name, start, end, device):
    dt = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, device_type=dt,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_busy_launches_kernel_time_and_gaps():
    prof = types.SimpleNamespace(events=lambda: [
        ev("portbench.window", 0, 1000, False),
        ev("void (anonymous namespace)::drain_kernel<false, 256>(Params)", -50, -10, True),
        ev("portbench.enqueue", 0, 600, False),
        ev("portbench.enqueue", 0, 600, True),          # an annotation, no work
        ev("portbench.fetch", 600, 1000, False),
        ev("void (anonymous namespace)::drain_kernel<false, 256>(Params)", 100, 300, True),
        ev("(anonymous namespace)::fit_plane_kernel(int const*)", 250, 350, True),
        ev("(anonymous namespace)::plane_kernel((anonymous namespace)::Args)", 700, 750, True),
        ev("Memcpy DtoH (Device -> Pageable)", 900, 950, True),
    ])
    t = Traced(prof, 2, [0, 1])
    assert t.window_s == 1000 / 1e6
    assert t.busy_s == (250 + 50 + 50) / 1e6
    assert t.launches() == 3
    assert t.kernel_ms(["fit_plane_kernel", "drain_kernel"]) == 300 / 1e3
    assert t.kernel_ms(["plane_kernel"]) == 50 / 1e3
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # idle: 0-100 and 350-700 (its middle in the enqueue), then 750-900
    # and 950-1000 in the fetch
    assert gaps["enqueue: all gaps"] == (100 + 350) / 1e6
    assert gaps["enqueue: longest gap"] == 350 / 1e6
    assert abs(gaps["fetch: all gaps"] - (150 + 50) / 1e6) < 1e-12
