"""Deterministic fault injection for the serving path (docs/ROBUSTNESS.md).

Chaos that is replayable evidence, not flakes: a FaultPlan is a SEEDED,
declaratively-configured schedule of faults bound to NAMED hook points at
every pipeline hand-off of the sidecar —

  codec_decode     ApplyDelta payload entering the C++ codec
  classify         shape-ladder classification of a tenant's world
  stack            member lanes stacking into one batched pytree
  h2d              a tenant's resident device lanes uploading
  dispatch         the vmapped sim program launching
  harvest          the async device→host result fetch completing
  assembly         one member's response assembling from the fetched pytree
  grpc_reply       the response leaving the gRPC handler
  scheduler_loop   the BatchScheduler's serve loop (thread-death chaos)

— and, since the control loop grew its own survival layer
(core/supervisor.py, docs/ROBUSTNESS.md "Control loop"), at the LOCAL
guarded phases of StaticAutoscaler.run_once:

  local_encode     the world encode / delta program building
  local_dispatch   the filter-out-schedulable + sim dispatch
  local_fetch      the device→host verdict fetch
  local_probe      the supervisor's recovery probe

Specs fire on deterministic match-hit counters (`after` skips the first N
matching invocations, `times` caps total fires; a tenant-scoped spec counts
only that tenant's invocations, so its schedule is independent of co-tenant
interleaving), and probabilistic specs draw from a per-spec `random.Random`
seeded by (plan seed, spec id) — the same plan over the same request
sequence injects the same faults.

Zero overhead when disabled is a CONTRACT, not an aspiration: the module
global `PLAN` is None unless a plan is installed, and every hook site guards
with `if faults.PLAN is not None` — one global load + identity test, no
function call, no dict lookup (the chaos bench measures the guard at
single-digit ns/op and CI asserts it stays that way).

Every fired fault is stamped three ways so a chaos run leaves evidence:
`faults_injected_total{hook,kind}` on the service registry, a closed
`fault/<hook>` span on the active tracer (when the hook runs on a traced
handler thread), and an entry in the plan's bounded fire log (sequence,
hook, kind, spec, tenant) — the log is what the bench's `chaos` block and
the Statusz faults section print.

Config: programmatic `install(specs, seed=...)` (tests, bench) or the
`KATPU_FAULTS` env var — a JSON document `{"seed": 7, "specs": [...]}` or
`@/path/to/plan.json` — read once by the first SimulatorService that
starts while no plan is installed.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass

HOOKS = ("codec_decode", "classify", "stack", "h2d", "dispatch",
         "harvest", "assembly", "grpc_reply", "scheduler_loop",
         # the local control loop's guarded phases (core/supervisor.py)
         "local_encode", "local_dispatch", "local_fetch", "local_probe",
         # the fetched filter-out-schedulable verdict plane, right after
         # its device→host copy (core/static_autoscaler.py) — the
         # shadow-audit-visible corruption point: a flip_bit spec here
         # corrupts what every downstream consumer reads while the device
         # buffer keeps the truth (audit/shadow.py detects the split)
         "verdict_plane")

# raise: typed InjectedFault; delay/hang: sleep delay_ms (hang is the same
# mechanism with an alarming name — a bounded stall, so tests can assert
# deadline behavior without wedging the suite); truncate: cut a bytes
# payload in half (a torn KAD1 section); nan: NaN every float plane of a
# dict-of-arrays payload (a poisoned world/result); flip_bit: XOR one bit
# of one element of an integer ndarray payload (single-bit silent data
# corruption — the canonical SDC shape the online shadow audit must
# detect within one loop; element/bit picked by the spec's seeded RNG,
# overridable via `index`/`bit`).
KINDS = ("raise", "delay", "hang", "truncate", "nan", "flip_bit")

ENV_VAR = "KATPU_FAULTS"


class InjectedFault(RuntimeError):
    """The typed error a `raise`-kind spec throws: carries its hook + spec
    id so the isolation layer can attribute a window failure (and the
    quarantine reason) to the exact injection point."""

    def __init__(self, hook: str, spec_id: str, message: str = ""):
        super().__init__(message or f"injected fault at {hook} [{spec_id}]")
        self.hook = hook
        self.spec_id = spec_id


@dataclass
class FaultSpec:
    """One declarative fault: where (hook, optional tenant), what (kind),
    and when (after/times/prob) it fires."""

    hook: str
    kind: str = "raise"
    tenant: str = ""        # exact tenant match; "" = any request
    after: int = 0          # skip the first N matching invocations
    times: int = 1          # fire at most N times; 0 = unlimited
    prob: float = 1.0       # seeded Bernoulli per eligible invocation
    delay_ms: float = 0.0   # delay/hang sleep
    index: int = -1         # flip_bit: element index (-1 = seeded pick)
    bit: int = -1           # flip_bit: bit position (-1 = seeded pick)
    message: str = ""
    id: str = ""

    def __post_init__(self):
        if self.hook not in HOOKS:
            raise ValueError(f"unknown fault hook {self.hook!r}; "
                             f"hooks are {', '.join(HOOKS)}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds are {', '.join(KINDS)}")
        if not self.id:
            self.id = f"{self.hook}/{self.kind}" + (
                f"@{self.tenant}" if self.tenant else "")


class FaultPlan:
    """A seeded spec set + per-spec fire state + the bounded fire log."""

    def __init__(self, specs, seed: int = 0, registry=None,
                 log_capacity: int = 512):
        self.specs: list[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs]
        self.seed = int(seed)
        # default registry for hook sites that have no handle (batch.py,
        # admission.py); server.py sites pass their service registry
        self.registry = registry
        self._lock = threading.Lock()
        self._hits = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self._rng = [random.Random(f"{self.seed}:{i}:{s.id}")
                     for i, s in enumerate(self.specs)]
        self.log: deque[dict] = deque(maxlen=log_capacity)
        self.seq = 0

    # ---- the hook-site entry ----

    def fire(self, hook: str, tenant: str = "", tenants=(),
             payload=None, registry=None):
        """Evaluate every spec against one hook invocation. Returns the
        (possibly corrupted) payload; raises InjectedFault for `raise`
        specs. `tenant` is the single-request identity, `tenants` the
        member set of a batched hand-off — a tenant-scoped spec matches
        either way, so a window fails exactly when the poison member is
        co-batched."""
        for i, s in enumerate(self.specs):
            if s.hook != hook:
                continue
            if s.tenant and s.tenant != tenant \
                    and s.tenant not in (tenants or ()):
                continue
            with self._lock:
                self._hits[i] += 1
                if self._hits[i] <= s.after:
                    continue
                if s.times and self._fired[i] >= s.times:
                    continue
                if s.prob < 1.0 and self._rng[i].random() >= s.prob:
                    continue
                self._fired[i] += 1
                seq = self.seq
                self.seq += 1
                self.log.append({
                    "seq": seq, "hook": hook, "kind": s.kind, "spec": s.id,
                    "tenant": s.tenant or tenant or ""})
            payload = self._act(s, hook, s.tenant or tenant,
                                payload, registry or self.registry,
                                rng=self._rng[i])
        return payload

    def _act(self, s: FaultSpec, hook: str, tenant: str, payload, registry,
             rng=None):
        self._stamp(s, hook, tenant, registry)
        if s.kind in ("delay", "hang"):
            time.sleep(max(s.delay_ms, 0.0) / 1000.0)
            return payload
        if s.kind == "raise":
            raise InjectedFault(hook, s.id, s.message)
        if s.kind == "truncate":
            if isinstance(payload, (bytes, bytearray)):
                return bytes(payload)[: max(len(payload) // 2 - 1, 0)]
            return payload
        if s.kind == "nan":
            return _nan_corrupt(payload)
        if s.kind == "flip_bit":
            return _flip_bit(payload, s, rng)
        return payload  # pragma: no cover — KINDS is exhaustive

    @staticmethod
    def _stamp(s: FaultSpec, hook: str, tenant: str, registry) -> None:
        """Every injected fault is accounted evidence: a labelled counter
        on the registry and a closed span on the active tracer (handler
        threads run under `traced_call`, so payload/classify/reply faults
        land on the request's own timeline)."""
        if registry is not None:
            registry.counter(
                "faults_injected_total",
                help="Faults injected by the deterministic chaos plane "
                     "(sidecar/faults.py), by hook point and kind",
            ).inc(hook=hook, kind=s.kind)
        from kubernetes_autoscaler_tpu_torch.metrics import trace as _trace

        tr = _trace.current_tracer()
        if tr is not None:
            tr.add_span(f"fault/{hook}", cat="fault", kind=s.kind,
                        spec=s.id, **({"tenant": tenant} if tenant else {}))

    # ---- accounting ----

    def fired_total(self) -> int:
        with self._lock:
            return sum(self._fired)

    def stats(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [
                    {"id": s.id, "hook": s.hook, "kind": s.kind,
                     "tenant": s.tenant, "hits": self._hits[i],
                     "fired": self._fired[i]}
                    for i, s in enumerate(self.specs)],
                "fired_total": sum(self._fired),
                "log_tail": list(self.log)[-8:],
            }


def _nan_corrupt(payload):
    """NaN every float plane of a dict-of-arrays payload (int planes are
    left alone — NaN has no int encoding; the validation layer catches
    negative/oversize int corruption separately)."""
    import numpy as np

    if not isinstance(payload, dict):
        return payload
    out = {}
    for k, v in payload.items():
        if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating):
            v = np.full_like(v, np.nan)
        out[k] = v
    return out


def _flip_bit(payload, s: FaultSpec, rng):
    """XOR one bit of one element of an integer ndarray (a COPY — the
    caller's array may be a host mirror shared with other readers). The
    single-bit-flip is the canonical silent-data-corruption shape: the
    payload stays structurally valid, finite, plausible — only a
    golden-output check (the shadow audit) can tell."""
    import numpy as np

    if not isinstance(payload, np.ndarray) or payload.size == 0 \
            or not np.issubdtype(payload.dtype, np.integer):
        return payload
    out = payload.copy()
    flat = out.reshape(-1)
    idx = s.index if 0 <= s.index < flat.size else \
        (rng.randrange(flat.size) if rng is not None else 0)
    nbits = out.dtype.itemsize * 8 - 1   # spare the sign bit
    bit = s.bit if 0 <= s.bit < nbits else \
        (rng.randrange(nbits) if rng is not None else 0)
    flat[idx] = int(flat[idx]) ^ (1 << bit)
    return out


# ---- module-level plan (the zero-overhead guard reads this) ----

PLAN: FaultPlan | None = None


def install(specs, seed: int = 0, registry=None) -> FaultPlan:
    """Install a plan as the process's active fault plane (tests/bench)."""
    global PLAN
    PLAN = specs if isinstance(specs, FaultPlan) else FaultPlan(
        specs, seed=seed, registry=registry)
    return PLAN


def clear() -> None:
    global PLAN
    PLAN = None


def from_env(registry=None) -> FaultPlan | None:
    """Install from KATPU_FAULTS (JSON, or @path) — no-op when unset or a
    plan is already installed (programmatic install wins)."""
    if PLAN is not None:
        return PLAN
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    doc = json.loads(raw)
    if not isinstance(doc, dict):
        raise ValueError(f"{ENV_VAR} must be a JSON object "
                         f"{{'seed': ..., 'specs': [...]}}")
    return install(doc.get("specs", []), seed=doc.get("seed", 0),
                   registry=registry)
