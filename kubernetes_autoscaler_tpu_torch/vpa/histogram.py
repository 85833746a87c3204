"""Vectorized decaying histograms: the VPA recommender's core state, on the
device.

The port's counterpart of the reference package's vpa/histogram.py (itself
modelled on vertical-pod-autoscaler/pkg/recommender/util/histogram.go +
decaying_histogram.go). ALL aggregates are rows of one [A, B] f32 weight
tensor on the bank's device:

  * decay        — one elementwise multiply by 2^(-Δt/half_life)
  * add samples  — bucket lookup, then one scatter-add in sample order
                   (ops/kernels/histogram_kernel: `index_add_` on the CPU,
                   the CUDA kernel csrc/histogram.cu on the card)
  * percentile   — a running sum + first-crossing argmax per row

A recommendation is the END of the bucket where a row's running sum crosses
a quantile, so one ulp in a bucket index, a bin, a running sum or a bucket
end moves a pod's request. Every decision here is byte-equal to the JAX
package's on the CPU, and the card's equals the CPU's:

  * `bucket_of` is a search in a table of f32 thresholds (the smallest
    value the reference places in each bucket), not the reference's
    floor(log(v/start)/log(ratio)): XLA's f32 log and torch's differ in the
    last bit on some inputs, and the comparisons of a search give the same
    answer on any device. tests/test_torch_vpa.py derives the tables from
    the JAX package by bisection and holds these to it.
  * the running sum is the one XLA's CPU computes for a cumulative sum over
    176 buckets: sequential adds within blocks of 16 buckets, and a
    sequential prefix of the block totals added to each block — written as
    elementwise adds, exact on both devices (torch.cumsum sums in another
    order).
  * the bucket ends are a second table, the reference's f32
    `start * ratio ** (i + 1)`.
  * the scatter adds each bin's samples in sample order from its current
    value, as XLA's CPU scatter does.
  * XLA's CPU flushes subnormal floats to zero, as operands and as
    results. The bank keeps the invariant that it holds none: the decay
    flushes its factor and its products, and sample weights are flushed
    before the scatter. Sums and comparisons of the non-negative normal
    values left then round as XLA's do, on either device.

The reference's checkpointing (VerticalPodAutoscalerCheckpoint CRD)
serializes bucket weights; vpa/checkpoint.py round-trips the same arrays.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.device import resolve_device
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.ops.kernels.histogram_kernel import (
    scatter_add_ordered,
)

SCAN_BLOCK = 16      # XLA's CPU scans a cumulative sum in blocks of 16
F32_TINY = float(np.finfo(np.float32).tiny)   # the smallest normal f32

# f32 bit patterns, derived from the JAX package (tests/test_torch_vpa.py
# `derive_thresholds` / `derive_ends`). _THRESHOLD_BITS[i - 1] is the
# smallest f32 the reference's bucket_of places in bucket >= i (i = 1..175);
# _END_BITS[i] is its f32 bucket end start * ratio ** (i + 1).
_CPU_THRESHOLD_BITS = (
    1009518642, 1010082355, 1010674255, 1011295749, 1011948319, 1012633515,
    1013352974, 1014108403, 1014901605, 1015378018, 1015815270, 1016274385,
    1016756456, 1017262631, 1017794113, 1018352170, 1018938130, 1019553389,
    1020199410, 1020877732, 1021589969, 1022337817, 1023123062, 1023678871,
    1024111735, 1024566243, 1025043476, 1025544572, 1026070721, 1026623178,
    1027203259, 1027812342, 1028451880, 1029123394, 1029828486, 1030568832,
    1031346193, 1031980604, 1032409125, 1032859073, 1033331518, 1033827582,
    1034348453, 1034895365, 1035469625, 1036072598, 1036705716, 1037370495,
    1038068508, 1038801425, 1039570989, 1040283209, 1040707431, 1041152862,
    1041620566, 1042111655, 1042627297, 1043168723, 1043737218, 1044334140,
    1044960909, 1045619013, 1046310024, 1047035584, 1047797424, 1048586677,
    1049006641, 1049447602, 1049910613, 1050396775, 1050907242, 1051443234,
    1052006025, 1052596957, 1053217436, 1053868936, 1054553014, 1055271292,
    1056025489, 1056817392, 1057306749, 1057743288, 1058201651, 1058682931,
    1059188281, 1059718893, 1060276036, 1060861035, 1061475291, 1062120252,
    1062797463, 1063508540, 1064255164, 1065039119, 1065607749, 1066039904,
    1066493667, 1066970117, 1067470396, 1067995684, 1068547234, 1069126370,
    1069734455, 1070372946, 1071043366, 1071747301, 1072486433, 1073262521,
    1073909623, 1074337442, 1074786652, 1075258326, 1075753580, 1076273596,
    1076819618, 1077392936, 1077994920, 1078627003, 1079290696, 1079987566,
    1080719282, 1081487590, 1082212369, 1082635895, 1083080596, 1083547537,
    1084037821, 1084552619, 1085093157, 1085660727, 1086256669, 1086882409,
    1087539435, 1088229321, 1088953692, 1089714282, 1090512911, 1090935251,
    1091375491, 1091837746, 1092323110, 1092832742, 1093367855, 1093929729,
    1094519693, 1095139153, 1095789592, 1096472548, 1097189651, 1097942617,
    1098733224, 1099235504, 1099671326, 1100128942, 1100609436, 1101113953,
    1101643702, 1102199933, 1102783976, 1103397226, 1104041133, 1104717234,
    1105427141, 1106172555, 1106955228, 1107536645, 1107968094, 1108421114,
    1108896785, 1109396250, 1109920678, 1110471327, 1111049509, 1111656599,
    1112294044,
)

_CPU_END_BITS = (
    1009518640, 1010082354, 1010674254, 1011295749, 1011948317, 1012633515,
    1013352972, 1014108403, 1014901605, 1015378017, 1015815270, 1016274385,
    1016756455, 1017262630, 1017794113, 1018352170, 1018938130, 1019553387,
    1020199408, 1020877730, 1021589968, 1022337817, 1023123060, 1023678870,
    1024111735, 1024566243, 1025043476, 1025544571, 1026070721, 1026623178,
    1027203257, 1027812341, 1028451879, 1029123394, 1029828485, 1030568830,
    1031346192, 1031980603, 1032409124, 1032859072, 1033331516, 1033827582,
    1034348452, 1034895365, 1035469624, 1036072596, 1036705716, 1037370493,
    1038068508, 1038801424, 1039570986, 1040283209, 1040707430, 1041152861,
    1041620565, 1042111654, 1042627297, 1043168722, 1043737218, 1044334139,
    1044960906, 1045619012, 1046310022, 1047035584, 1047797423, 1048586677,
    1049006641, 1049447603, 1049910613, 1050396774, 1050907242, 1051443234,
    1052006026, 1052596957, 1053217435, 1053868937, 1054553012, 1055271293,
    1056025487, 1056817391, 1057306749, 1057743286, 1058201650, 1058682932,
    1059188278, 1059718891, 1060276036, 1060861037, 1061475288, 1062120252,
    1062797464, 1063508536, 1064255163, 1065039120, 1065607746, 1066039902,
    1066493666, 1066970119, 1067470394, 1067995682, 1068547236, 1069126366,
    1069734453, 1070372946, 1071043362, 1071747300, 1072486433, 1073262524,
    1073909621, 1074337441, 1074786652, 1075258323, 1075753578, 1076273596,
    1076819614, 1077392934, 1077994919, 1078627004, 1079290692, 1079987566,
    1080719282, 1081487585, 1082212367, 1082635894, 1083080597, 1083547535,
    1084037821, 1084552619, 1085093159, 1085660725, 1086256669, 1086882411,
    1087539440, 1088229321, 1088953694, 1089714287, 1090512910, 1090935252,
    1091375492, 1091837744, 1092323110, 1092832743, 1093367858, 1093929729,
    1094519694, 1095139156, 1095789591, 1096472549, 1097189653, 1097942613,
    1098733222, 1099235504, 1099671327, 1100128941, 1100609436, 1101113955,
    1101643700, 1102199933, 1102783977, 1103397223, 1104041132, 1104717236,
    1105427145, 1106172550, 1106955224, 1107536644, 1107968094, 1108421115,
    1108896788, 1109396245, 1109920674, 1110471325, 1111049509, 1111656601,
    1112294048, 1112963367,
)

_MEMORY_THRESHOLD_BITS = (
    1260402592, 1260927591, 1261478841, 1262057653, 1262665405, 1263303545,
    1263973593, 1264677141, 1265415868, 1266191531, 1266842892, 1267270477,
    1267719440, 1268190852, 1268685834, 1269205565, 1269751282, 1270324287,
    1270925941, 1271557677, 1272221000, 1272917488, 1273648804, 1274416683,
    1275145686, 1275568980, 1276013437, 1276480119, 1276970134, 1277484649,
    1278024891, 1278592144, 1279187760, 1279813157, 1280469825, 1281159326,
    1281883299, 1282643473, 1283441655, 1283868387, 1284308385, 1284770382,
    1285255480, 1285764832, 1286299653, 1286861215, 1287450853, 1288069976,
    1288720051, 1289402633, 1290119346, 1290871889, 1291662063, 1292168688,
    1292604271, 1293061634, 1293541863, 1294046105, 1294575557, 1295131484,
    1295715208, 1296328115, 1296971669, 1297647400, 1298356919, 1299101910,
    1299884156, 1300469875, 1300901087, 1301353860, 1301829270, 1302328452,
    1302852591, 1303402940, 1303980806, 1304587562, 1305224660, 1305893608,
    1306596009, 1307333527, 1308107919, 1308771943, 1309198826, 1309647053,
    1310117697, 1310611867, 1311130747, 1311675571, 1312247641, 1312848308,
    1313479009, 1314141251, 1314836599, 1315566714, 1316333343, 1317074876,
    1317497475, 1317941205, 1318407126, 1318896338, 1319410009, 1319949372,
    1320515695, 1321110336, 1321734713, 1322390304, 1323078674, 1323801463,
    1324560398, 1325357273, 1325797028, 1326236308, 1326697549, 1327181852,
    1327690375, 1328224319, 1328784960, 1329373633, 1329991745, 1330640756,
    1331322220, 1332037763, 1332789075, 1333577953, 1334097473, 1334532346,
    1334988958, 1335468402, 1335971817, 1336500407, 1337055422, 1337638187,
    1338250091, 1338892597, 1339567220, 1340275575, 1341019356, 1341800317,
    1342398804, 1342829313, 1343281343, 1343755975, 1344254338, 1344777624,
    1345327070, 1345903987, 1346509756, 1347145808, 1347813663, 1348514917,
    1349251226, 1350024351, 1350701010, 1351127199, 1351574693, 1352044562,
    1352537928, 1353055960, 1353599891, 1354171025, 1354770710, 1355400378,
    1356061531, 1356755752, 1357484673, 1358250039, 1359004085, 1359425993,
    1359868997, 1360334160, 1360822572, 1361335403, 1361873877, 1362439274,
    1363032941,
)

_MEMORY_END_BITS = (
    1260402592, 1260927590, 1261478840, 1262057653, 1262665404, 1263303545,
    1263973592, 1264677141, 1265415868, 1266191531, 1266842892, 1267270477,
    1267719440, 1268190851, 1268685834, 1269205565, 1269751283, 1270324286,
    1270925940, 1271557676, 1272221000, 1272917488, 1273648803, 1274416682,
    1275145686, 1275568979, 1276013438, 1276480118, 1276970134, 1277484650,
    1278024891, 1278592144, 1279187760, 1279813157, 1280469824, 1281159325,
    1281883299, 1282643473, 1283441656, 1283868386, 1284308384, 1284770382,
    1285255479, 1285764832, 1286299652, 1286861214, 1287450853, 1288069975,
    1288720052, 1289402633, 1290119343, 1290871889, 1291662062, 1292168687,
    1292604270, 1293061632, 1293541863, 1294046104, 1294575558, 1295131483,
    1295715206, 1296328114, 1296971668, 1297647400, 1298356918, 1299101912,
    1299884156, 1300469876, 1300901087, 1301353860, 1301829271, 1302328452,
    1302852593, 1303402940, 1303980805, 1304587564, 1305224659, 1305893610,
    1306596008, 1307333526, 1308107920, 1308771941, 1309198826, 1309647054,
    1310117694, 1310611866, 1311130748, 1311675572, 1312247638, 1312848308,
    1313479011, 1314141248, 1314836598, 1315566716, 1316333339, 1317074874,
    1317497475, 1317941206, 1318407124, 1318896337, 1319410011, 1319949368,
    1320515694, 1321110336, 1321734710, 1322390303, 1323078674, 1323801465,
    1324560394, 1325357272, 1325797028, 1326236306, 1326697548, 1327181853,
    1327690372, 1328224318, 1328784960, 1329373635, 1329991742, 1330640757,
    1331322220, 1332037758, 1332789073, 1333577953, 1334097474, 1334532344,
    1334988958, 1335468402, 1335971819, 1336500406, 1337055422, 1337638190,
    1338250096, 1338892597, 1339567223, 1340275580, 1341019355, 1341800319,
    1342398806, 1342829311, 1343281343, 1343755976, 1344254340, 1344777624,
    1345327071, 1345903991, 1346509755, 1347145809, 1347813665, 1348514914,
    1349251226, 1350024353, 1350701012, 1351127198, 1351574694, 1352044564,
    1352537927, 1353055960, 1353599893, 1354171023, 1354770710, 1355400381,
    1356061535, 1356755748, 1357484669, 1358250038, 1359004086, 1359425995,
    1359869000, 1360334155, 1360822568, 1361335402, 1361873877, 1362439276,
    1363032945, 1363656297,
)


_TABLES = {
    (0.01, 1.05, 176): (_CPU_THRESHOLD_BITS, _CPU_END_BITS),
    (1e7, 1.05, 176): (_MEMORY_THRESHOLD_BITS, _MEMORY_END_BITS),
}


@functools.lru_cache(maxsize=None)
def _f32_table(bits: tuple, device: torch.device) -> torch.Tensor:
    """A table of f32 bit patterns as an f32 tensor on `device`."""
    return torch.from_numpy(np.asarray(bits, np.int32).view(np.float32)).to(
        device)


@dataclass(frozen=True)
class BucketScheme:
    """Exponential buckets: bucket i covers [start*ratio^i, start*ratio^(i+1)).

    Reference defaults (model/aggregations_config.go): CPU histograms start at
    0.01 cores with 5% growth; memory at 1e7 bytes with 5% growth. The port
    holds the threshold and bucket-end tables of these two schemes; another
    scheme raises."""

    start: float
    ratio: float
    n_buckets: int

    def _tables(self) -> tuple[tuple, tuple]:
        key = (self.start, self.ratio, self.n_buckets)
        if key not in _TABLES:
            raise ValueError(f"no threshold table for {self}: the port holds "
                             f"the schemes {sorted(_TABLES)}")
        return _TABLES[key]

    def thresholds(self, device=None) -> torch.Tensor:
        """f32[n_buckets - 1]: the smallest value of each bucket 1..n-1."""
        return _f32_table(self._tables()[0], torch.device(device or "cpu"))

    def ends(self, device=None) -> torch.Tensor:
        """f32[n_buckets]: each bucket's end, as the reference computes it."""
        return _f32_table(self._tables()[1], torch.device(device or "cpu"))

    def bucket_of(self, value, device=None) -> torch.Tensor:
        """i32 bucket indices for sample values (clamped to range). A tensor
        stays on its device; anything else is cast on the host and goes to
        `device` (default the CPU). Values are cast to f32 first, as the
        reference casts them; NaN falls in bucket 0, as the reference's
        conversion puts it."""
        if isinstance(value, torch.Tensor):
            v = value.to(torch.float32)
        else:
            v = torch.from_numpy(np.asarray(value, np.float32)).to(
                device or "cpu")
        v = torch.nan_to_num(v, nan=0.0)
        idx = torch.searchsorted(self.thresholds(v.device), v, right=True)
        return idx.clamp(0, self.n_buckets - 1).to(torch.int32)

    def bucket_start(self, idx):
        return self.start * self.ratio ** idx

    def boundaries(self) -> np.ndarray:
        return self.start * self.ratio ** np.arange(self.n_buckets + 1)


CPU_SCHEME = BucketScheme(start=0.01, ratio=1.05, n_buckets=176)
MEMORY_SCHEME = BucketScheme(start=1e7, ratio=1.05, n_buckets=176)

CPU_HALF_LIFE_S = 24.0 * 3600.0   # reference: DefaultCPUHistogramDecayHalfLife
MEMORY_HALF_LIFE_S = 24.0 * 3600.0


class HistogramBank(object):
    """Host handle over the [A, B] weight tensor + reference timestamps, on
    `device` (None = CUDA, raising without a card; tests pass "cpu")."""

    def __init__(self, n_aggregates: int, scheme: BucketScheme,
                 half_life_s: float, device=None):
        self.device = resolve_device(device)
        self.scheme = scheme
        self.half_life_s = half_life_s
        self.weights = torch.zeros((n_aggregates, scheme.n_buckets),
                                   dtype=torch.float32, device=self.device)
        self.total = torch.zeros((n_aggregates,), dtype=torch.float32,
                                 device=self.device)
        self.ref_time = 0.0

    def grow(self, n_aggregates: int) -> None:
        a, b = self.weights.shape
        if n_aggregates <= a:
            return
        self.weights = torch.cat([self.weights, torch.zeros(
            (n_aggregates - a, b), dtype=torch.float32, device=self.device)])
        self.total = torch.cat([self.total, torch.zeros(
            (n_aggregates - a,), dtype=torch.float32, device=self.device)])

    def decay_to(self, now: float) -> None:
        dt = now - self.ref_time
        if dt <= 0:
            return
        factor = float(np.float32(2.0 ** (-dt / self.half_life_s)))
        if factor < F32_TINY:
            factor = 0.0            # a subnormal operand counts as zero
        # one f32 multiply by the factor, as the reference's, then its
        # subnormal products flushed to zero
        self.weights = flush_subnormals(self.weights * factor)
        self.total = flush_subnormals(self.total * factor)
        self.ref_time = now

    def add_samples(self, agg_idx: np.ndarray, values: np.ndarray,
                    sample_weights: np.ndarray | None = None) -> None:
        """Batched sample ingestion: one scatter-add for the whole batch
        (reference: per-sample AddSample, decaying_histogram.go), each bin
        summed in sample order. Updates the bank's tensors in place."""
        if len(agg_idx) == 0:
            return
        agg = np.asarray(agg_idx, np.int32)
        w = (np.array(sample_weights, np.float32)
             if sample_weights is not None
             else np.ones((len(agg),), np.float32))
        w[np.abs(w) < F32_TINY] = 0.0          # subnormal weights add nothing
        dev = self.device
        scatter_add_ordered(
            self.weights, self.total, torch.from_numpy(agg).to(dev),
            self.scheme.bucket_of(values, device=dev),
            torch.from_numpy(w).to(dev))

    def percentile(self, q: float) -> np.ndarray:
        """f32[A]: value at quantile q per aggregate (0 for empty rows).

        Matches the reference convention (histogram.go:160 Percentile): returns
        the END of the bucket where the cumulative weight crosses q."""
        return to_host(_percentile(self.weights, self.total, q,
                                   self.scheme.ends(self.device)))


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """`x` with its subnormal entries set to zero, as XLA's CPU leaves the
    result of an f32 operation."""
    return torch.where(x.abs() < F32_TINY, torch.zeros_like(x), x)


def running_sum(weights: torch.Tensor) -> torch.Tensor:
    """f32[A, B]: the cumulative sum along the buckets, added in the order
    XLA's CPU adds it: within each block of SCAN_BLOCK buckets one after
    another, then each block's sum of all earlier blocks (themselves summed
    one after another) added to the block's entries. B must be a multiple
    of SCAN_BLOCK and at most SCAN_BLOCK ** 2 (one level of blocks)."""
    a, n = weights.shape
    nblk = n // SCAN_BLOCK
    if n % SCAN_BLOCK or nblk > SCAN_BLOCK:
        raise ValueError(f"running_sum takes a multiple of {SCAN_BLOCK} "
                         f"buckets, at most {SCAN_BLOCK ** 2}; got {n}")
    x = weights.view(a, nblk, SCAN_BLOCK)
    cols = [x[:, :, 0]]
    for k in range(1, SCAN_BLOCK):
        cols.append(cols[-1] + x[:, :, k])
    local = torch.stack(cols, dim=2)                  # [A, nblk, 16]
    before = [torch.zeros_like(local[:, 0, 0])]
    for j in range(1, nblk):
        before.append(before[-1] + local[:, j - 1, -1])
    return (local + torch.stack(before, dim=1)[:, :, None]).reshape(a, n)


def _percentile(weights, total, q, ends):
    cum = running_sum(weights)
    threshold = total[:, None] * q
    crossed = cum >= threshold - 1e-12
    first = torch.argmax(crossed.to(torch.uint8), dim=-1)
    value = ends[first]                                  # bucket end
    return torch.where(total > 0, value, torch.zeros_like(value))
