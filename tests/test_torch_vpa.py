"""The port's VPA against the JAX package's, on the CPU.

The recommendation is the bucket end where a row's running sum crosses a
quantile, so the port must reproduce the reference bit for bit: its bucket
index, every bin and total, the running sum and the bucket end. Each part
is held to the JAX package on its own (the threshold and bucket-end tables,
`bucket_of`, the blocked running sum, the ordered scatter, the decay), then
every case of tests/test_vpa.py runs on both packages with the same
numpy-made inputs: bank weights and totals byte-equal, recommendations,
updater decisions and admission patches exactly equal, checkpoints loading
across the packages byte-equal.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.ops.kernels import (
    hist_cases,
    histogram_kernel,
)

REF = "kubernetes_autoscaler_tpu"
PORT = "kubernetes_autoscaler_tpu_torch"


def _mods(pkg: str) -> SimpleNamespace:
    sub = ("histogram", "model", "recommender", "updater", "admission",
           "checkpoint", "history")
    return SimpleNamespace(pkg=pkg, **{
        s: importlib.import_module(f"{pkg}.vpa.{s}") for s in sub})


J, T = _mods(REF), _mods(PORT)
BOTH = [J, T]
SCHEMES = ["CPU_SCHEME", "MEMORY_SCHEME"]


def recommender(m, **kw):
    return (m.recommender.Recommender(**kw) if m is J
            else m.recommender.Recommender(device="cpu", **kw))


def bank(m, *args):
    return (m.histogram.HistogramBank(*args) if m is J
            else m.histogram.HistogramBank(*args, device="cpu"))


def host(x) -> np.ndarray:
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def bank_arrays(rec) -> dict[str, np.ndarray]:
    return {f"{name}.{f}": host(getattr(getattr(rec, name), f))
            for name in ("cpu", "memory") for f in ("weights", "total")}


def recs(vpas) -> list:
    return [[dataclasses.asdict(r) for r in v.recommendation] for v in vpas]


# ---------------------------------------------------------------- tables


def ref_bucket_of(scheme, values) -> np.ndarray:
    """The reference's bucket_of called as its HistogramBank.add_samples
    calls it: eagerly, outside any jit (under jit XLA folds log(ratio) to a
    constant one ulp away, and the thresholds move)."""
    return np.asarray(scheme.bucket_of(jnp.asarray(values, jnp.float32)))


def derive_thresholds(scheme) -> np.ndarray:
    """i32[n-1]: for each bucket i = 1..n-1, the bit pattern of the smallest
    f32 that the reference's bucket_of places in bucket >= i, found by
    bisection over the bit patterns of positive floats (whose order is
    their values' order)."""
    f = functools.partial(ref_bucket_of, scheme)
    target = np.arange(1, scheme.n_buckets)
    lo = np.full(target.size, np.float32(scheme.start).view(np.int32), np.int64)
    hi = np.full(target.size, np.float32(np.inf).view(np.int32), np.int64)
    while np.any(lo < hi):
        mid = (lo + hi) // 2
        ok = np.asarray(f(mid.astype(np.int32).view(np.float32))) >= target
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    return lo.astype(np.int32)


def derive_ends(scheme) -> np.ndarray:
    """i32[n]: the bit patterns of the reference's bucket ends, read off its
    own percentile: row i holds one sample in bucket i."""
    n = scheme.n_buckets
    out = J.histogram._percentile(jnp.eye(n, dtype=jnp.float32),
                                  jnp.ones(n, jnp.float32), 0.5,
                                  scheme.start, scheme.ratio)
    return np.asarray(out).view(np.int32)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_threshold_table_is_the_reference_s(scheme):
    s_ref, s_port = getattr(J.histogram, scheme), getattr(T.histogram, scheme)
    table = s_port.thresholds().numpy().view(np.int32)
    assert table.tolist() == derive_thresholds(s_ref).tolist()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bucket_end_table_is_the_reference_s(scheme):
    s_ref, s_port = getattr(J.histogram, scheme), getattr(T.histogram, scheme)
    ends = s_port.ends().numpy().view(np.int32)
    want = derive_ends(s_ref)
    for i in range(s_port.n_buckets):
        assert ends[i] == want[i], f"bucket {i}"


def test_another_scheme_has_no_table():
    s = T.histogram.BucketScheme(start=0.5, ratio=1.1, n_buckets=176)
    with pytest.raises(ValueError, match="no threshold table"):
        s.bucket_of(np.asarray([1.0]))


# ---------------------------------------------------------------- bucket_of


def _bucket_parity(scheme: str, values: np.ndarray) -> None:
    want = ref_bucket_of(getattr(J.histogram, scheme), values)
    got = getattr(T.histogram, scheme).bucket_of(values).numpy()
    assert got.dtype == want.dtype == np.int32
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (values[bad[:5]], got[bad[:5]], want[bad[:5]])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bucket_of_around_every_threshold(scheme):
    """±64 ulp around each of the 175 thresholds."""
    table = getattr(T.histogram, scheme).thresholds().numpy().view(np.int32)
    bits = (table[:, None].astype(np.int64) + np.arange(-64, 65)).ravel()
    _bucket_parity(scheme, bits.astype(np.int32).view(np.float32))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bucket_of_on_log_uniform_values(scheme):
    """10^6 seeded values, log-uniform from a tenth of the first bucket to
    ten times the last bucket's end."""
    s = getattr(T.histogram, scheme)
    rng = np.random.default_rng(7)
    lo, hi = np.log(s.start / 10), np.log(s.boundaries()[-1] * 10)
    _bucket_parity(scheme, np.exp(rng.uniform(lo, hi, 1_000_000)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bucket_of_at_the_edges(scheme):
    s = getattr(T.histogram, scheme)
    f32 = np.finfo(np.float32)
    values = np.asarray([0.0, -0.0, -1.0, -s.start, f32.min, -np.inf, np.inf,
                         np.nan, -np.nan, f32.max, f32.tiny, s.start / 2,
                         s.start, s.start * 0.999999, s.boundaries()[-1],
                         s.boundaries()[-1] * 2, 1e38], np.float64)
    _bucket_parity(scheme, values)
    # a tensor stays on its device and is cast to f32 as an array would be
    t = s.bucket_of(torch.tensor(values))
    assert t.dtype == torch.int32
    assert t.tolist() == s.bucket_of(values).tolist()


# ---------------------------------------------------------------- running sum


@pytest.mark.parametrize("rows,density", [(64, 1.0), (4096, 1.0), (64, 0.05),
                                          (4096, 0.05), (1, 1.0)])
def test_running_sum_is_xla_s_cumsum(rows, density):
    """The blocked scan equals jnp.cumsum on the CPU entry for entry (and
    torch.cumsum, summing in another order, does not)."""
    rng = np.random.default_rng(rows)
    w = (rng.lognormal(0, 2, (rows, 176))
         * (rng.random((rows, 176)) < density)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=-1))(w))
    got = T.histogram.running_sum(torch.from_numpy(w)).numpy()
    assert got.tobytes() == want.tobytes()
    if rows == 4096 and density == 1.0:
        assert torch.cumsum(torch.from_numpy(w), -1).numpy().tobytes() != \
            want.tobytes()


def test_running_sum_refuses_other_widths():
    with pytest.raises(ValueError):
        T.histogram.running_sum(torch.zeros(2, 100))


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.0, 1.0])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_percentile_is_the_reference_s(scheme, q):
    """Seeded banks with empty, one-bucket, sparse and dense rows."""
    s_ref, s_port = getattr(J.histogram, scheme), getattr(T.histogram, scheme)
    rng = np.random.default_rng(3)
    a = 512
    w = (rng.lognormal(0, 2, (a, 176))
         * (rng.random((a, 176)) < rng.random((a, 1)) ** 3)).astype(np.float32)
    w[:8] = 0.0
    w[8:16] = 0.0
    w[8:16, rng.integers(0, 176, 8)] = 1.0
    total = w.sum(-1, dtype=np.float32)
    want = np.asarray(J.histogram._percentile(
        jnp.asarray(w), jnp.asarray(total), q, s_ref.start, s_ref.ratio))
    got = to_host(T.histogram._percentile(
        torch.from_numpy(w), torch.from_numpy(total), q, s_port.ends()))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------- the bank


def _bank_pair(scheme, a, half_life=3600.0):
    return [bank(m, a, getattr(m.histogram, scheme), half_life) for m in BOTH]


def _assert_banks(pair) -> None:
    for f in ("weights", "total"):
        x, y = host(getattr(pair[0], f)), host(getattr(pair[1], f))
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scatter_sums_in_sample_order(scheme):
    """Heavy duplicates, weights spanning many binades, bins that already
    hold weight: every bin and total byte-equal after each batch."""
    rng = np.random.default_rng(11)
    pair = _bank_pair(scheme, 40)
    s = getattr(T.histogram, scheme)
    for step in range(3):
        n = 20_000
        agg = rng.integers(0, 40, n).astype(np.int32)
        values = s.start * np.exp(rng.normal(4, 1.5, n))
        w = rng.lognormal(0, 3, n).astype(np.float32)
        for b in pair:
            b.add_samples(agg, values, w)
        _assert_banks(pair)
        for b in pair:
            b.decay_to(1000.0 * (step + 1))
        _assert_banks(pair)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_add_samples_around_every_threshold(scheme):
    """±3 ulp around each of the 175 thresholds, through both packages'
    HistogramBank.add_samples (row i takes the values around threshold
    i): banks byte-equal."""
    table = getattr(T.histogram, scheme).thresholds().numpy().view(np.int32)
    bits = table[:, None].astype(np.int64) + np.arange(-3, 4)
    values = bits.astype(np.int32).view(np.float32).ravel()
    agg = np.repeat(np.arange(table.size, dtype=np.int32), 7)
    pair = _bank_pair(scheme, table.size)
    for b in pair:
        b.add_samples(agg, values)
    _assert_banks(pair)
    assert host(pair[1].weights).astype(bool).sum() == 2 * table.size


def test_one_sample_near_a_threshold_recommends_as_the_reference():
    """One container, one sample right at a threshold of each scheme: the
    eager reference's targets (a table derived from a jit of bucket_of put
    the sample one bucket lower: cpu 58.72482)."""
    out = []
    for m in BOTH:
        r = recommender(m)
        r.feed([_sample(m, namespace="default", pod_name="p",
                        container_name="app", owner_name="web",
                        cpu_cores=51.06503677368164,
                        memory_bytes=51_065_036_800.0)], now=10.0)
        vpa = m.model.VerticalPodAutoscaler(name="v", target_name="web")
        r.recommend([vpa], {"web": ["app"]}, now=10.0)
        out.append((bank_arrays(r), recs([vpa])))
    _assert_same(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    target = out[1][1][0][0]["target"]
    assert np.float32(target["cpu"]) == np.float32(61.66106)
    assert target["memory"] == pytest.approx(61_661_062_553.6, rel=0, abs=1.0)


@pytest.mark.parametrize("dt", [1.0, 3600.0, 86400.0 * 3.3, 1e7,
                                86400.0 * 126.5, 86400.0 * 130.0, 1.7e9])
def test_decay_is_the_reference_s(dt):
    """Day-long half-lives; from 1e7 s on some products are subnormal,
    which XLA's CPU flushes to zero, and from 126.5 days the factor itself
    is (a subnormal operand counts as zero)."""
    pair = _bank_pair("CPU_SCHEME", 16, half_life=86400.0)
    rng = np.random.default_rng(5)
    agg = np.repeat(np.arange(16), 64)
    vals = rng.lognormal(0, 1, agg.size)
    w = rng.lognormal(0, 3, agg.size).astype(np.float32)
    for b in pair:
        b.add_samples(agg, vals, w)
        b.add_samples(agg, vals)
        b.decay_to(dt)
        b.decay_to(dt / 2)            # earlier than ref_time: a no-op
    _assert_banks(pair)
    assert pair[0].ref_time == pair[1].ref_time
    for b in pair:                    # what a subnormal bank would read
        b.add_samples(agg[:9], vals[:9])
    _assert_banks(pair)
    for q in (0.5, 0.95):
        assert pair[0].percentile(q).tobytes() == pair[1].percentile(q).tobytes()


def test_subnormal_sample_weights_add_nothing():
    """XLA's CPU reads a subnormal operand as zero."""
    pair = _bank_pair("MEMORY_SCHEME", 2)
    w = np.asarray([1e-39, 2e-40, 1.0, 1.17e-38, 1.2e-38], np.float32)
    for b in pair:
        b.add_samples(np.asarray([0, 0, 1, 1, 0]), np.full(5, 3e8), w)
    _assert_banks(pair)
    assert pair[1].percentile(0.5)[0] > 0 and host(pair[1].total)[1] == 1.0


def test_grow_keeps_rows_and_pads_zeros():
    pair = _bank_pair("MEMORY_SCHEME", 3)
    for b in pair:
        b.add_samples(np.asarray([0, 2]), np.asarray([5e8, 7e9]))
        b.grow(2)                      # smaller: a no-op
        b.grow(9)
    _assert_banks(pair)
    assert tuple(pair[1].weights.shape) == (9, 176)


def test_bank_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.histogram.HistogramBank(2, T.histogram.CPU_SCHEME, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.recommender.Recommender()


# ------------------------------------------- the cases of tests/test_vpa.py


def _sample(m, **kw):
    return m.model.ContainerUsageSample(**kw)


def case_histogram_percentile(m):
    b = bank(m, 2, m.histogram.CPU_SCHEME, 3600.0)
    b.add_samples(np.zeros(100, np.int32), np.full(100, 0.5))
    p50 = b.percentile(0.5)
    assert 0.45 < p50[0] < 0.60
    assert p50[1] == 0.0
    return {"p50": p50, "w": host(b.weights), "t": host(b.total)}


def case_histogram_decay_shifts_weight(m):
    b = bank(m, 1, m.histogram.CPU_SCHEME, 100.0)
    b.add_samples(np.zeros(10, np.int32), np.full(10, 2.0))
    b.decay_to(1000.0)
    b.add_samples(np.zeros(10, np.int32), np.full(10, 0.1))
    p50 = b.percentile(0.5)
    assert p50[0] < 0.2
    return {"p50": p50, "w": host(b.weights), "t": host(b.total)}


def case_recommender_end_to_end(m):
    r = recommender(m)
    samples = [_sample(m, namespace="default", pod_name=f"p{i % 5}",
                       container_name="app", owner_name="web",
                       cpu_cores=0.30 + 0.01 * (i % 10), memory_bytes=400e6,
                       timestamp=float(i)) for i in range(200)]
    r.feed(samples, now=300.0)
    vpa = m.model.VerticalPodAutoscaler(name="web-vpa", target_name="web")
    r.recommend([vpa], {"web": ["app"]}, now=400.0)
    rec = vpa.recommendation[0]
    assert 0.3 < rec.target["cpu"] < 0.7
    assert rec.lower_bound["cpu"] <= rec.target["cpu"] <= rec.upper_bound["cpu"]
    assert rec.target["memory"] >= 400e6
    return {"banks": bank_arrays(r), "recs": recs([vpa])}


def case_recommender_respects_policy_caps(m):
    r = recommender(m)
    r.feed([_sample(m, namespace="default", pod_name="p",
                    container_name="app", owner_name="web", cpu_cores=4.0,
                    memory_bytes=8e9)] * 50, now=10.0)
    vpa = m.model.VerticalPodAutoscaler(
        name="v", target_name="web",
        resource_policies=[m.model.ContainerResourcePolicy(
            container_name="app", max_allowed={"cpu": 2.0, "memory": 4e9})])
    r.recommend([vpa], {"web": ["app"]}, now=10.0)
    rec = vpa.recommendation[0]
    assert rec.target["cpu"] == 2.0 and rec.target["memory"] == 4e9
    assert rec.uncapped_target["cpu"] > 2.0
    return {"banks": bank_arrays(r), "recs": recs([vpa])}


def case_confidence_widens_band_for_young_aggregates(m):
    young, old = recommender(m), recommender(m)
    for rec, n in ((young, 10), (old, 3 * 24 * 60)):
        rec.feed([_sample(m, namespace="default", pod_name="p0",
                          container_name="app", owner_name="web",
                          cpu_cores=0.5, memory_bytes=400e6,
                          timestamp=60.0 * (i + 1)) for i in range(n)],
                 now=60.0 * (n + 1))
    v_young = m.model.VerticalPodAutoscaler(name="v", target_name="web")
    v_old = m.model.VerticalPodAutoscaler(name="v", target_name="web")
    young.recommend([v_young], {"web": ["app"]}, now=600.0)
    old.recommend([v_old], {"web": ["app"]}, now=3 * 24 * 3600.0)
    ry, ro = v_young.recommendation[0], v_old.recommendation[0]

    def band(r):
        return r.upper_bound["cpu"] - r.lower_bound["cpu"]

    assert band(ry) > band(ro)
    assert ry.upper_bound["cpu"] > ro.upper_bound["cpu"] * 2
    return {"young": bank_arrays(young), "old": bank_arrays(old),
            "recs": recs([v_young, v_old])}


def case_prometheus_history_provider(m):
    def query_fn(query, start, end):
        metric = {"namespace": "default", "pod": "web-abc12", "container": "app"}
        v = "0.4" if "cpu" in query else "5e8"
        return [{"metric": metric,
                 "values": [[start + 60.0 * i, v] for i in range(120)]}]

    r = recommender(m)
    prov = m.history.PrometheusHistoryProvider(
        query_fn=query_fn, pod_owner=lambda ns, pod: "web")
    assert prov.load_into(r, now=1_000_000.0) == 240
    vpa = m.model.VerticalPodAutoscaler(name="v", target_name="web")
    r.recommend([vpa], {"web": ["app"]}, now=1_000_000.0)
    rec = vpa.recommendation[0]
    assert 0.4 <= rec.target["cpu"] <= 0.6
    assert rec.target["memory"] >= 5e8
    return {"banks": bank_arrays(r), "recs": recs([vpa])}


def case_history_batch_ingestion_matches_sequential(m):
    seq, bat = recommender(m), recommender(m)
    samples = [_sample(m, namespace="default", pod_name="p",
                       container_name="app", owner_name="web",
                       cpu_cores=0.2 + 0.05 * (i % 7),
                       memory_bytes=3e8 + 1e7 * (i % 11),
                       timestamp=3600.0 * (i + 1)) for i in range(48)]
    now = 3600.0 * 50
    for s in samples:
        seq.feed([s], now=s.timestamp)
    seq.cpu.decay_to(now)
    seq.memory.decay_to(now)
    bat.feed_history(samples, now=now)
    for f in ("cpu", "memory"):
        np.testing.assert_allclose(host(getattr(seq, f).weights[:1]),
                                   host(getattr(bat, f).weights[:1]),
                                   rtol=1e-5)
    return {"seq": bank_arrays(seq), "bat": bank_arrays(bat)}


def case_recommender_scale_10k_containers(m):
    n_targets, pods_per = 500, 4
    rec = recommender(m)
    samples = [_sample(m, namespace="default", pod_name=f"w{t}-{p}",
                       container_name="app", owner_name=f"w{t}",
                       cpu_cores=0.1 + (t % 10) * 0.1,
                       memory_bytes=(64 + (t % 7) * 32) * 2**20,
                       timestamp=float(k * 60))
               for t in range(n_targets) for p in range(pods_per)
               for k in range(5)]
    rec.feed(samples, now=300.0)
    vpas = [m.model.VerticalPodAutoscaler(name=f"v{t}", target_name=f"w{t}")
            for t in range(n_targets)]
    rec.recommend(vpas, {f"w{t}": ["app"] for t in range(n_targets)},
                  now=300.0)
    assert all(v.recommendation for v in vpas)
    assert (vpas[9].recommendation[0].target["cpu"]
            > vpas[0].recommendation[0].target["cpu"] * 3)
    return {"banks": bank_arrays(rec), "recs": recs(vpas)}


def case_seeded_world(m):
    """Many aggregates over several feeds a simulated minute apart, with
    OOMs, a history warm-up, policies and a container left Off."""
    rng = np.random.default_rng(2024)
    n_w = 150
    base_cpu = np.exp(rng.uniform(np.log(0.05), np.log(4.0), n_w))
    base_mem = np.exp(rng.uniform(np.log(64 * 2**20), np.log(8 * 2**30), n_w))
    r = recommender(m)
    hist = []
    for w in range(n_w):
        for h in range(24):
            for c, f in (("app", 1.0), ("sidecar", 0.2)):
                hist.append(_sample(
                    m, namespace="ns", pod_name=f"w{w}-0", container_name=c,
                    owner_name=f"w{w}",
                    cpu_cores=float(base_cpu[w] * f * rng.lognormal(0, 0.3)),
                    memory_bytes=float(base_mem[w] * f * rng.lognormal(0, 0.2)),
                    timestamp=3600.0 * h))
    r.feed_history(hist, now=86400.0)
    vpas = [m.model.VerticalPodAutoscaler(
        name=f"v{w}", namespace="ns", target_name=f"w{w}",
        resource_policies=[m.model.ContainerResourcePolicy(
            container_name="sidecar", mode="Off" if w % 7 == 0 else "Auto",
            max_allowed={"cpu": 1.0})]) for w in range(n_w)]
    out = {"history": bank_arrays(r)}
    for step in range(3):
        now = 86400.0 + 60.0 * (step + 1)
        batch = []
        for w in range(n_w):
            for p in range(3):
                for c, f in (("app", 1.0), ("sidecar", 0.2)):
                    batch.append(_sample(
                        m, namespace="ns", pod_name=f"w{w}-{p}",
                        container_name=c, owner_name=f"w{w}",
                        cpu_cores=float(base_cpu[w] * f * rng.lognormal(0, 0.3)),
                        memory_bytes=float(base_mem[w] * f
                                           * rng.lognormal(0, 0.2)),
                        is_oom=bool(rng.random() < 0.01), timestamp=now))
        r.feed(batch, now=now)
        r.recommend(vpas, {f"w{w}": ["app", "sidecar"] for w in range(n_w)},
                    now=now)
        out[f"step{step}"] = bank_arrays(r)
        out[f"recs{step}"] = recs(vpas)
    return out


CASES = [case_histogram_percentile, case_histogram_decay_shifts_weight,
         case_recommender_end_to_end, case_recommender_respects_policy_caps,
         case_confidence_widens_band_for_young_aggregates,
         case_prometheus_history_provider,
         case_history_batch_ingestion_matches_sequential,
         case_recommender_scale_10k_containers, case_seeded_world]


def _assert_same(want, got, path="") -> None:
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert want.dtype == got.dtype and want.shape == got.shape, path
        assert want.tobytes() == got.tobytes(), f"{path}: bytes differ"
    elif isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _assert_same(want[k], got[k], f"{path}.{k}")
    else:
        assert want == got, path         # recommendation dicts: floats exact


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_equals_the_reference(case):
    _assert_same(case(J), case(T))


# ---------------------------------------------------------------- the updater


def _updater_world(m):
    model = m.model
    vpa = model.VerticalPodAutoscaler(name="v", target_name="web",
                                      min_replicas=1)
    vpa.recommendation = [model.RecommendedContainerResources(
        container_name="app", target={"cpu": 1.0, "memory": 2e9},
        lower_bound={"cpu": 0.8, "memory": 1.5e9},
        upper_bound={"cpu": 1.5, "memory": 3e9})]
    lone = model.VerticalPodAutoscaler(name="l", target_name="lone",
                                       min_replicas=2)
    lone.recommendation = [model.RecommendedContainerResources(
        container_name="app", target={"cpu": 1.0},
        lower_bound={"cpu": 0.8}, upper_bound={"cpu": 1.5})]
    resize = model.VerticalPodAutoscaler(
        name="r", target_name="rz", min_replicas=1,
        update_mode=model.UpdateMode.IN_PLACE_OR_RECREATE)
    resize.recommendation = list(vpa.recommendation)
    pv = m.updater.PodView
    pods = [pv("under", "default", "web", {"app": {"cpu": 0.2, "memory": 2e9}},
               replicas_of_owner=3),
            pv("fine", "default", "web", {"app": {"cpu": 1.0, "memory": 2e9}},
               replicas_of_owner=3),
            pv("drift", "default", "web", {"app": {"cpu": 1.2, "memory": 2e9}},
               start_time=0.0, replicas_of_owner=3),
            pv("lone", "default", "lone", {"app": {"cpu": 0.1}},
               replicas_of_owner=1),
            pv("rz", "default", "rz", {"app": {"cpu": 0.1, "memory": 2e9}},
               replicas_of_owner=2)]
    pods += [pv(f"p{i}", "default", "web", {"app": {"cpu": 0.1 * i}},
                replicas_of_owner=3) for i in range(12)]
    return [vpa, lone, resize], pods


def _run_updater(m):
    evicted, resized = [], []
    budget = {"web": 6}

    def can_evict(pod):
        if budget.get(pod.owner_name, 1) <= 0:
            return False
        budget[pod.owner_name] = budget.get(pod.owner_name, 1) - 1
        return True

    u = m.updater.Updater(
        evict=lambda p: evicted.append(p.name),
        in_place_resize=lambda p, t: resized.append((p.name, t)) or True,
        eviction_rate_limit_per_loop=5, can_evict=can_evict)
    vpas, pods = _updater_world(m)
    acted = u.run_once(vpas, pods, now=1e6)
    return ([(d.pod.name, d.priority, d.outside_bounds, d.in_place)
             for d in acted], evicted, resized)


def test_updater_decisions_equal_the_reference():
    want, got = _run_updater(J), _run_updater(T)
    assert want == got
    acted, evicted, resized = got
    assert "under" in evicted and "fine" not in evicted
    assert "lone" not in evicted                 # min_replicas
    assert resized and resized[0][0] == "rz"     # in place, no eviction
    assert len(evicted) == 5                     # the loop's rate limit


# ---------------------------------------------------------------- admission


def test_admission_patches_equal_the_reference():
    out = []
    for m in BOTH:
        model = m.model
        vpa = model.VerticalPodAutoscaler(name="v", target_name="web")
        vpa.recommendation = [model.RecommendedContainerResources(
            container_name="app", target={"cpu": 2.0, "memory": 4e9})]
        off = model.VerticalPodAutoscaler(name="o", target_name="off",
                                          update_mode=model.UpdateMode.OFF)
        ops = m.admission.patch_for_pod(
            "default", "web", containers={"app": {"cpu": 1.0, "memory": 2e9}},
            limits={"app": {"cpu": 2.0}}, vpas=[vpa, off])
        none = m.admission.patch_for_pod("default", "off",
                                         {"app": {"cpu": 1.0}}, None, [off])
        bad = model.VerticalPodAutoscaler(
            name="v", target_name="", resource_policies=[
                model.ContainerResourcePolicy(
                    container_name="app", mode="Sometimes",
                    min_allowed={"cpu": 2.0}, max_allowed={"cpu": 1.0})])
        out.append(([dataclasses.astuple(o) for o in ops], none,
                    m.admission.validate_vpa(bad),
                    m.admission.validate_vpa(vpa)))
    assert out[0] == out[1]
    by = {(c, r): v for c, r, v in out[1][0]}
    assert by[("app", "cpu")] == 2.0 and by[("app", "limit:cpu")] == 4.0
    assert out[1][1] == [] and out[1][3] == []
    assert any("unknown mode" in p for p in out[1][2])


# ---------------------------------------------------------------- checkpoints


def _fed(m):
    r = recommender(m)
    rng = np.random.default_rng(9)
    r.feed([_sample(m, namespace="d", pod_name=f"p{i}", container_name="app",
                    owner_name=f"w{i % 70}", cpu_cores=float(rng.lognormal(-1, 1)),
                    memory_bytes=float(rng.lognormal(20, 1)))
            for i in range(700)], now=100.0)
    return r


def _load(m, path):
    return (m.checkpoint.load_checkpoint(path) if m is J
            else m.checkpoint.load_checkpoint(path, device="cpu"))


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J), (T, T)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_checkpoint_loads_across_packages(tmp_path, writer, reader):
    r = _fed(writer)
    path = os.path.join(tmp_path, "ckpt.npz")
    writer.checkpoint.save_checkpoint(r, path, 100.0)
    r2 = _load(reader, path)
    _assert_same(bank_arrays(r), bank_arrays(r2))
    assert r2._index == r._index
    assert r2.cpu.ref_time == r2.memory.ref_time == 100.0
    assert _load(reader, os.path.join(tmp_path, "missing.npz")) is None
    # both packages write the same file from the same state
    other = J if writer is T else T
    path2 = os.path.join(tmp_path, "other.npz")
    other.checkpoint.save_checkpoint(_fed(other), path2, 100.0)
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    # the loaded recommender recommends as the writer's package's does
    outs = []
    for m, rec in ((writer, _load(writer, path)), (reader, r2)):
        vpas = [m.model.VerticalPodAutoscaler(name="v", namespace="d",
                                            target_name="w3")]
        rec.recommend(vpas, {"w3": ["app"]}, now=100.0)
        outs.append(recs(vpas))
    assert outs[0] == outs[1] and outs[0][0]


# ------------------------------------- the scatter's plain version and cases


@pytest.mark.parametrize("name", sorted(hist_cases.CASES))
def test_scatter_plain_is_a_sequential_sum_on_every_case(name):
    """The cases the card holds the kernel to: the plain version equals an
    unbuffered sum in sample order (np.add.at) and XLA's scatter."""
    weights, total, agg, bucket, w = hist_cases.CASES[name]()
    n_a, n_b = weights.shape
    seq_w, seq_t = weights.numpy().copy(), total.numpy().copy()
    # rows and buckets as `.at[]` reads them: [-n, -1] from the end, a row
    # still outside dropped, a bucket still outside adding to the total only
    row, bkt = agg.numpy().astype(np.int64), bucket.numpy().astype(np.int64)
    row = np.where((row >= -n_a) & (row < 0), row + n_a, row)
    bkt = np.where((bkt >= -n_b) & (bkt < 0), bkt + n_b, bkt)
    in_row = (row >= 0) & (row < n_a)
    in_bin = in_row & (bkt >= 0) & (bkt < n_b)
    np.add.at(seq_w.reshape(-1), row[in_bin] * n_b + bkt[in_bin],
              w.numpy()[in_bin])
    np.add.at(seq_t, row[in_row], w.numpy()[in_row])
    # JAX gets its own copies and finishes before the port updates the
    # torch tensors in place: jnp.asarray may alias a numpy buffer, and
    # its dispatch is asynchronous
    jw, jt = jax.block_until_ready(J.histogram._scatter_add(
        *(jnp.asarray(x.numpy().copy()) for x in
          (weights, total, agg, bucket, w))))
    before = histogram_kernel.scatter_add_ordered.launches
    histogram_kernel.scatter_add_ordered(weights, total, agg, bucket, w)
    assert histogram_kernel.scatter_add_ordered.launches == before
    assert weights.numpy().tobytes() == seq_w.tobytes() == np.asarray(jw).tobytes()
    assert total.numpy().tobytes() == seq_t.tobytes() == np.asarray(jt).tobytes()


def test_scatter_cases_reach_the_kernels_edges():
    """The cases pin what their names say: a row key past 16 bits (three
    sort passes), rows in descending sample order, every row dropped, one
    row over more than five sort tiles, n one past a tile boundary."""
    cases = {k: hist_cases.CASES[k]() for k in (
        "wide_bank", "descending_rows", "all_dropped", "one_row_many_tiles",
        "tile_edge")}
    a = cases["wide_bank"][0].shape[0]
    assert a > 65_536 and histogram_kernel.sort_plan(a) == (3, 6)
    assert histogram_kernel.sort_plan(33_790) == (2, 8)
    rows = cases["descending_rows"][2]
    assert bool((rows[1:] <= rows[:-1]).all()) and rows[0] > rows[-1]
    weights, total, agg, bucket, w = cases["all_dropped"]
    assert bool(((agg >= weights.shape[0]) | (agg < -weights.shape[0])).all())
    before = weights.clone(), total.clone()
    histogram_kernel.scatter_add_ordered(weights, total, agg, bucket, w)
    assert torch.equal(weights, before[0]) and torch.equal(total, before[1])
    agg = cases["one_row_many_tiles"][2]
    assert agg.numel() > 5 * histogram_kernel.TILE and agg.unique().numel() == 1
    assert cases["tile_edge"][2].numel() == 2 * histogram_kernel.TILE + 1


@pytest.mark.parametrize("name", sorted(hist_cases.CASES))
def test_scatter_sort_plan_orders_rows_stably(name):
    """The kernel's radix passes as its plan splits the row key (digits of
    `sort_plan`'s width, least significant first, each pass stable) give
    the samples stably sorted by row, dropped rows (key A) last; and the
    workspace holds its buffers and control words."""
    weights, _total, agg, _bucket, _w = hist_cases.CASES[name]()
    a, n = weights.shape[0], agg.numel()
    key = histogram_kernel._wrap(agg, a).long()
    passes, bits = histogram_kernel.sort_plan(a)
    assert passes * bits >= a.bit_length() and bits <= 8
    order = torch.arange(n)
    for p in range(passes):
        digit = (key[order] >> (p * bits)) & ((1 << bits) - 1)
        order = order[torch.sort(digit, stable=True).indices]
    assert torch.equal(order, torch.sort(key, stable=True).indices)
    tiles = -(-n // histogram_kernel.TILE)
    assert histogram_kernel.workspace_words(n, a) == (
        4 * n + passes * 256 * tiles + passes * 256 + 2 * a)


def test_scatter_wrapper_checks_its_contract_on_the_cpu():
    weights, total, agg, bucket, w = hist_cases.hist_case(0, 8, 50)
    f = histogram_kernel.scatter_add_ordered
    with pytest.raises(TypeError):
        f(weights, total, agg.long(), bucket, w)
    with pytest.raises(TypeError):
        f(weights.double(), total, agg, bucket, w)
    with pytest.raises(ValueError):
        f(weights, total[:4], agg, bucket, w)
    with pytest.raises(ValueError):
        f(weights, total, agg, bucket[:10], w)
    with pytest.raises(ValueError):
        f(torch.zeros(176, 8).t(), total, agg, bucket, w)   # not contiguous


@pytest.mark.parametrize("row,bucket", hist_cases.OUT_OF_BANK)
def test_scatter_reads_indices_outside_the_bank_as_the_reference(row, bucket):
    """A negative row or bucket counts from the end, a row still outside
    the bank is dropped, and a bin outside it is dropped while the row's
    total still counts the sample: the wrapper equals JAX's `_scatter_add`
    byte for byte, for the sample alone on an empty bank and among seeded
    samples (the card's kernel is held to the plain version on the same
    cases in test_torch_kernels_cuda.py)."""
    for n in (1, 100):
        args = hist_cases.out_of_bank_case(row, bucket, n)
        jw, jt = jax.block_until_ready(J.histogram._scatter_add(
            *(jnp.asarray(x.numpy().copy()) for x in args)))
        histogram_kernel.scatter_add_ordered(*args)
        assert args[0].numpy().tobytes() == np.asarray(jw).tobytes(), n
        assert args[1].numpy().tobytes() == np.asarray(jt).tobytes(), n
    # the sample alone, against the effect the reference has
    a, b = hist_cases.OOB_ROWS, hist_cases.OOB_BUCKETS
    r = row + a if row < 0 else row
    k = bucket + b if bucket < 0 else bucket
    one = hist_cases.out_of_bank_case(row, bucket, 1)
    histogram_kernel.scatter_add_ordered(*one)
    want_t = np.zeros(a, np.float32)
    want_w = np.zeros((a, b), np.float32)
    if 0 <= r < a:
        want_t[r] = 1.0
        if 0 <= k < b:
            want_w[r, k] = 1.0
    assert one[1].numpy().tolist() == want_t.tolist()
    assert one[0].numpy().tolist() == want_w.tolist()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bucket_of_on_every_f32_of_the_range(scheme):
    """Every f32 from 1,000 ulp below the first bucket's start to 100,000
    ulp above the last threshold (≈ 1.03e8 values): the port's table search
    equals the reference's floor(log) formula, so that formula is monotone
    there; below the range both clamp to bucket 0 and above it to the last
    bucket."""
    s_ref, s_port = getattr(J.histogram, scheme), getattr(T.histogram, scheme)
    f = functools.partial(ref_bucket_of, s_ref)
    table = s_port.thresholds().numpy().view(np.int32)
    lo = int(np.float32(s_port.start).view(np.int32)) - 1000
    hi = int(table[-1]) + 100_000
    step = 1 << 23
    for a in range(lo, hi, step):
        v = np.arange(a, min(a + step, hi), dtype=np.int32).view(np.float32)
        want = np.asarray(f(v))
        got = s_port.bucket_of(torch.from_numpy(v)).numpy()
        assert np.array_equal(got, want), a
