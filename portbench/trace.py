"""The traced part of a `--trace 1` run, reduced from torch.profiler.

`Traced` holds, for the decisions run under the profiler: every device
operation inside the traced window as (name, start us, end us), the
benchmark's own host ranges
(`portbench.enqueue`: the call into run_once_fused; `portbench.fetch`: the
packed fetch; `portbench.next`: the switch to the next variant) and the
traced window (`portbench.window`). From them: the device's busy seconds
(the union of its operations' intervals inside the window), the kernel
launches, each kernel's device time, and the idle gaps labelled by what the
host was doing at their middle.
"""

from __future__ import annotations

import gzip
import json
import re
from collections import defaultdict

RANGES = ("portbench.enqueue", "portbench.fetch", "portbench.next")
WINDOW = "portbench.window"


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Traced:
    def __init__(self, prof, decisions: int, variants: list[int]):
        import torch

        self.decisions = decisions
        self.variants = variants          # the variant of each traced decision
        self.device_ops, self.host = [], []
        window = None
        for ev in prof.events():
            tr = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                # the benchmark's own ranges come back as device-side
                # annotations too: they are no device work
                if not ev.name.startswith("portbench."):
                    self.device_ops.append((ev.name, tr.start, tr.end))
            elif ev.name == WINDOW:
                window = (tr.start, tr.end)
            elif ev.name in RANGES:
                self.host.append((ev.name, tr.start, tr.end))
        if window is None:
            raise RuntimeError("the profiler recorded no traced window")
        self.window = window
        # only what ran inside the window: the profiler's first launches,
        # which it does not all record, run before it
        self.device_ops = [op for op in self.device_ops
                           if op[1] >= window[0] and op[2] <= window[1]]
        self.device_ops.sort(key=lambda e: e[1])
        self.host.sort(key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _union(self):
        w0, w1 = self.window
        out = []
        for _, s, e in self.device_ops:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) / 1e6

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.device_ops if _is_kernel(n))

    def kernel_ms(self, names) -> float:
        """Summed device ms of the kernels called one of `names`, whatever
        their namespace, template arguments and parameters
        ("void (anonymous namespace)::drain_kernel<false, 256>(...)")."""
        pat = re.compile(r"(^|[\s:])(" + "|".join(map(re.escape, names))
                         + r")[<(]")
        return sum(e - s for n, s, e in self.device_ops if pat.search(n)) / 1e3

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for n, s, e in self.device_ops:
            by[n[:120]] += (e - s) / 1e6
        return sorted(([n, t] for n, t in by.items()), key=lambda x: -x[1])[:k]

    def _label(self, t: float) -> str:
        inner = None
        for name, s, e in self.host:
            if s > t:
                break
            if s <= t <= e:
                inner = name
        return inner.split(".", 1)[1] if inner else "other"

    def idle_gaps(self) -> list:
        """[[label, seconds]]: each host activity's summed idle time and its
        longest single gap, longest first (at most 10 entries)."""
        w0, w1 = self.window
        edges = [w0]
        for s, e in self._union():
            edges += [s, e]
        edges.append(w1)
        total, longest = defaultdict(float), defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            lab = self._label((a + b) / 2)
            total[lab] += (b - a) / 1e6
            longest[lab] = max(longest[lab], (b - a) / 1e6)
        rows = [[f"{k}: all gaps", v] for k, v in total.items()]
        rows += [[f"{k}: longest gap", v] for k, v in longest.items()]
        return sorted(rows, key=lambda x: -x[1])[:10]

    def write(self, path: str) -> None:
        """A compact Chrome trace (device operations and the benchmark's
        ranges), gzipped."""
        evs = [{"name": n, "ph": "X", "ts": s, "dur": e - s, "pid": 1,
                "tid": 1} for n, s, e in self.device_ops]
        evs += [{"name": n, "ph": "X", "ts": s, "dur": e - s, "pid": 0,
                 "tid": 0} for n, s, e in self.host]
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": evs}, f)
