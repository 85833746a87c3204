"""PerfHistory: append-only, chain-sealed JSONL store of bench evidence.

One row per bench mode per run. Each row carries the run id, the commit,
an INJECTED timestamp (the store never reads a clock behind the caller's
back — tests and seed migration stamp historical times), the backend
lineage, a shape/mesh signature, the jax + device fingerprint, the mode's
flattened numeric metrics, and the full original record (so triage can
diff compile-census variants and phase spans without chasing artifacts).

Sealing is the flight journal's pattern (replay/journal.py): every row
carries `parent` (the previous row's digest) and `digest`
(sha256/16hex over the canonical body), so any in-place edit, deletion or
reorder breaks the chain structurally — `load(verify=True)` raises
HistoryTamperError instead of silently serving doctored baselines. Files
rotate at max_bytes/keep_files; each file opens with a meta line whose
`parentDigest` anchors the first row, so a retained file verifies on its
own even after older files are pruned (pruned rows are counted, never
silently vanished: `perf_history_dropped_total{reason}`).

Lineage separation is the load-bearing rule: `lineage_of(backend)` maps
the record's provenance field (docs/BENCH.md "The backend field") to the
baseline bucket, and every query filters on EXACT lineage — the floor
child emits the tpu headline metric NAME with `backend: cpu-floor`, and
that row lands in the cpu-floor bucket, never under a tpu baseline.
Dropped rows (null-valued error records) are banked for the trajectory's
honesty but excluded from baselines unless explicitly requested.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import time

from kubernetes_autoscaler_tpu_torch.utils.canonical import digest_of

HISTORY_VERSION = 1
# bench JSON record schema: v2 added schema_version + the propagated run_id
# (the floor child and parent used to emit unversioned, uncorrelated lines)
SCHEMA_VERSION = 2

_FILE_PREFIX = "perf-"
_FILE_SUFFIX = ".jsonl"
_FILE_RE = re.compile(r"perf-(\d{6})\.jsonl$")

_RUNS_HELP = "Bench rows appended to the perf history store"
_DROPPED_HELP = "Perf-history rows dropped, by reason"

# bookkeeping/identity fields of a bench record that are not metrics
_NON_METRIC_KEYS = frozenset({
    "metric", "unit", "backend", "mode", "error", "run_id",
    "schema_version", "floor_shapes", "device", "trace", "journal",
    "modes", "results",
})
_MAX_FLAT_KEYS = 512


class HistoryTamperError(RuntimeError):
    """The chain seal failed: a row's digest or parent link does not match
    what is on disk — the history was edited, truncated mid-row, or
    reordered. Structural, not a verdict: a legitimately slower build
    changes METRICS; it cannot change an already-sealed row."""


def lineage_of(backend) -> str:
    """Map a bench record's `backend` provenance field to its baseline
    bucket. tpu | cpu-floor | any explicit platform string; records with
    no backend (old null-value error lines) bucket as `unknown` and are
    never anyone's baseline."""
    b = str(backend or "").strip()
    return b if b else "unknown"


def flatten_metrics(obj: dict, prefix: str = "", out: dict | None = None
                    ) -> dict[str, float]:
    """Flatten a bench record's numeric leaves to dotted keys
    (`phases.encode_ms`, `world_store_churn` fields, ...). Bools flatten
    to 0/1 (identity predicates like `verdicts_identical` are evidence
    too); strings, nulls and lists are not metrics and are skipped."""
    if out is None:
        out = {}
    for k, v in obj.items():
        if not prefix and k in _NON_METRIC_KEYS:
            continue
        if len(out) >= _MAX_FLAT_KEYS:
            break
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            out[key] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[key] = float(v)
        elif isinstance(v, dict):
            flatten_metrics(v, prefix=f"{key}.", out=out)
    return out


_SHAPE_KEYS = ("floor_shapes", "mesh_devices", "wavefronts", "tenants",
               "loops", "lanes", "steps", "rollout_steps", "n_devices",
               "mode")


def shape_signature(obj: dict) -> tuple[dict, str]:
    """The shape/mesh identity of a record: the metric name (headline
    names encode pods/nodes/ng) plus any explicit shape fields —
    `floor_shapes` makes a degraded child's signature differ from a true
    full-shape run even though both carry the headline metric name, a
    second fence under the lineage rule."""
    shape = {"metric": obj.get("metric", "")}
    for k in _SHAPE_KEYS:
        if obj.get(k) is not None:
            shape[k] = obj[k]
    return shape, digest_of(shape)


def git_commit(cwd: str | None = None) -> str:
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        if proc.returncode == 0:
            return proc.stdout.strip()
    except Exception:  # noqa: BLE001 — provenance is best-effort, never fatal
        pass
    return ""


def runtime_fingerprint() -> dict:
    """torch + device identity for the row, under the reference's keys so
    a store written by either package reads in the other (`jax` stays
    empty; `torch` names this package's framework). Asking whether a card
    exists creates no CUDA context."""
    import torch

    cuda = torch.cuda.is_available()
    return {"platform": "gpu" if cuda else "cpu", "jax": "",
            "torch": torch.__version__,
            "pack": os.environ.get("KA_TPU_PACK", "")}


def seal_row(row: dict) -> dict:
    body = {k: v for k, v in row.items() if k != "digest"}
    row["digest"] = digest_of(body)
    return row


class PerfHistory:
    """The store. Construction scans the newest file's tail to resume the
    chain; appends are O(1) in history size. `registry` (optional) gets
    `bench_runs_total{mode,backend}` + `perf_history_dropped_total{reason}`
    on the normal exposition path; `clock` is injectable for tests."""

    def __init__(self, root: str, max_mb: float = 16.0, keep_files: int = 8,
                 registry=None, clock=time.time):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep_files = max(2, int(keep_files))
        self.rotate_bytes = max(4096, int(max_mb * 1e6) // self.keep_files)
        self.registry = registry
        self.clock = clock
        self.drops: dict[str, int] = {}
        self._seq = 0
        self._last_digest = ""
        self._file_index = -1
        self._cur_bytes = 0
        self._load_tail()

    # ---- file plumbing ----

    def files(self) -> list[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = [n for n in names if _FILE_RE.match(n)]
        return [os.path.join(self.root, n) for n in sorted(out)]

    def _path(self, index: int) -> str:
        return os.path.join(self.root,
                            f"{_FILE_PREFIX}{index:06d}{_FILE_SUFFIX}")

    def _load_tail(self) -> None:
        files = self.files()
        if not files:
            return
        last = files[-1]
        m = _FILE_RE.search(last)
        self._file_index = int(m.group(1)) if m else len(files) - 1
        self._cur_bytes = os.path.getsize(last)
        with open(last, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError as e:
                    raise HistoryTamperError(
                        f"{last}: unparseable tail line ({e})") from e
                if obj.get("kind") == "meta":
                    # an empty freshly-rotated file still anchors the chain
                    self._last_digest = obj.get("parentDigest", "")
                    self._seq = int(obj.get("nextSeq", self._seq))
                    continue
                self._seq = int(obj.get("seq", self._seq - 1)) + 1
                self._last_digest = obj.get("digest", "")

    def _open_next(self) -> None:
        self._file_index += 1
        path = self._path(self._file_index)
        meta = {"kind": "meta", "v": HISTORY_VERSION,
                "file": self._file_index, "nextSeq": self._seq,
                "parentDigest": self._last_digest}
        line = json.dumps(meta, separators=(",", ":")) + "\n"
        with open(path, "w", encoding="utf-8") as f:
            f.write(line)
        self._cur_bytes = len(line.encode())
        self._prune()

    def _prune(self) -> None:
        files = self.files()
        while len(files) > self.keep_files:
            victim = files.pop(0)
            dropped = 0
            try:
                with open(victim, encoding="utf-8") as f:
                    for line in f:
                        if line.strip() and '"kind":"meta"' not in line:
                            dropped += 1
                os.remove(victim)
            except OSError:
                break
            if dropped:
                self._drop("rotated", dropped)

    def _drop(self, reason: str, n: int = 1) -> None:
        self.drops[reason] = self.drops.get(reason, 0) + n
        if self.registry is not None:
            self.registry.counter(
                "perf_history_dropped_total", help=_DROPPED_HELP,
            ).inc(n, reason=reason)

    # ---- append ----

    def append(self, row: dict) -> dict:
        """Seal and append one row (already shaped by
        `append_bench_record`, or hand-built by tests). Assigns seq +
        parent, writes, rotates, returns the sealed row."""
        if self._file_index < 0:
            self._open_next()
        row = dict(row)
        row["v"] = HISTORY_VERSION
        row["seq"] = self._seq
        row["parent"] = self._last_digest
        seal_row(row)
        line = json.dumps(row, separators=(",", ":"), default=str) + "\n"
        path = self._path(self._file_index)
        with open(path, "a", encoding="utf-8") as f:
            f.write(line)
        self._cur_bytes += len(line.encode())
        self._seq += 1
        self._last_digest = row["digest"]
        if self.registry is not None:
            self.registry.counter("bench_runs_total", help=_RUNS_HELP).inc(
                mode=str(row.get("mode") or "unknown"),
                backend=str(row.get("lineage") or "unknown"))
        if row.get("dropped"):
            self._drop(str(row["dropped"]))
        if self._cur_bytes >= self.rotate_bytes:
            self._open_next()
        return row

    def append_bench_record(self, obj: dict, run_id: str = "",
                            commit: str = "", ts: float | None = None,
                            fingerprint: dict | None = None,
                            notes: str = "") -> dict:
        """Bank one bench JSON record (one mode's line). Null-valued
        error records are banked as DROPPED rows — visible in the
        trajectory, never a baseline."""
        metric = obj.get("metric")
        if not metric:
            raise ValueError("bench record has no 'metric' field")
        if metric == "bench_all_combined":
            raise ValueError("bench_all_combined is an envelope, not a "
                             "mode record — append the per-mode lines")
        shape, shape_sig = shape_signature(obj)
        row = {
            "kind": "row",
            "ts": float(self.clock() if ts is None else ts),
            "run": run_id or str(obj.get("run_id") or ""),
            "commit": commit,
            "metric": metric,
            "mode": obj.get("mode") or "",
            "backend": obj.get("backend"),
            "lineage": lineage_of(obj.get("backend")),
            "shape": shape,
            "shape_sig": shape_sig,
            "fingerprint": fingerprint if fingerprint is not None
            else runtime_fingerprint(),
            "metrics": flatten_metrics(obj),
            "record": obj,
        }
        if notes:
            row["notes"] = notes
        if obj.get("value") is None and "value" in obj:
            row["dropped"] = ("null-value: " + str(obj.get("error") or
                                                   "no error recorded"))[:200]
        return self.append(row)

    # ---- read side ----

    def load(self, verify: bool = True) -> list[dict]:
        """Read every retained row in order; with verify (the default)
        re-derive the chain and raise HistoryTamperError on any digest,
        parent-link or seq break."""
        rows: list[dict] = []
        for path in self.files():
            parent = None
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError as e:
                        raise HistoryTamperError(
                            f"{path}:{i + 1}: unparseable line ({e})") from e
                    if obj.get("kind") == "meta":
                        if parent is not None:
                            raise HistoryTamperError(
                                f"{path}:{i + 1}: meta line mid-file")
                        parent = obj.get("parentDigest", "")
                        continue
                    if verify:
                        if parent is None:
                            raise HistoryTamperError(
                                f"{path}:{i + 1}: row before meta line")
                        body = {k: v for k, v in obj.items()
                                if k != "digest"}
                        if digest_of(body) != obj.get("digest"):
                            raise HistoryTamperError(
                                f"{path}:{i + 1}: digest mismatch — row "
                                f"edited after sealing")
                        if obj.get("parent") != parent:
                            raise HistoryTamperError(
                                f"{path}:{i + 1}: parent-link break — row "
                                f"deleted, reordered or spliced")
                        if rows and obj.get("seq") != rows[-1]["seq"] + 1:
                            raise HistoryTamperError(
                                f"{path}:{i + 1}: seq gap "
                                f"{rows[-1]['seq']} -> {obj.get('seq')}")
                        parent = obj["digest"]
                    rows.append(obj)
        return rows

    def verify(self) -> int:
        return len(self.load(verify=True))

    def rows(self, metric: str | None = None, lineage: str | None = None,
             shape_sig: str | None = None, include_dropped: bool = False,
             verify: bool = True) -> list[dict]:
        """Filtered view. `lineage` filtering is EXACT — this is the
        never-cross rule; there is deliberately no 'any lineage'
        baseline helper."""
        out = []
        for r in self.load(verify=verify):
            if metric is not None and r.get("metric") != metric:
                continue
            if lineage is not None and r.get("lineage") != lineage:
                continue
            if shape_sig is not None and r.get("shape_sig") != shape_sig:
                continue
            if r.get("dropped") and not include_dropped:
                continue
            out.append(r)
        return out

    def last_run_id(self, lineage: str | None = None) -> str:
        """The run id of the newest non-dropped row (optionally within a
        lineage) — what `gate` targets by default."""
        for r in reversed(self.load(verify=False)):
            if r.get("dropped"):
                continue
            if lineage is not None and r.get("lineage") != lineage:
                continue
            if r.get("run"):
                return str(r["run"])
        return ""

    def stats(self) -> dict:
        rows = self.load(verify=False)
        lineages: dict[str, int] = {}
        dropped = 0
        for r in rows:
            if r.get("dropped"):
                dropped += 1
                continue
            lin = str(r.get("lineage") or "unknown")
            lineages[lin] = lineages.get(lin, 0) + 1
        return {"files": len(self.files()), "rows": len(rows),
                "dropped_rows": dropped, "lineages": lineages,
                "drops": dict(self.drops), "next_seq": self._seq}
