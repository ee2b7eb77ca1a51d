"""The port's SOD metrics vs ``dgtd_tpu`` (CPU): the host algorithms
(``metrics/sod_metrics.py``, exact in float64), the streaming evaluators
(parity and strict reductions), and ``metrics/device.py::batch_statistics``
in torch against the JAX ``batch_statistics`` and against the host path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgtd_tpu.metrics import evaluators as JE
from dgtd_tpu.metrics import sod_metrics as JS
from dgtd_tpu.metrics.device import batch_statistics as jax_batch_statistics
from dgtd_tpu_torch.core.registry import METRICS
from dgtd_tpu_torch.data.device_norm import scale_plane
from dgtd_tpu_torch.metrics import evaluators as PE
from dgtd_tpu_torch.metrics import sod_metrics as PS
from dgtd_tpu_torch.metrics.device import batch_statistics, statistics_to_host

# tests/test_metrics.py's bars: device S-measure against the host or JAX,
# and the device-stats route against the full-map route
SM_TOL = dict(rtol=1e-4, atol=1e-5)
ROUTE_TOL = dict(rtol=1e-4, atol=1e-6)
# the same float64 arithmetic in the same order on both sides
EVAL_TOL = dict(rtol=0, atol=1e-12)


# ---------------------------------------------------------------- fixtures


def make_pair(seed=0, size=32):
    """tests/test_metrics.py's random uint8 prediction and 0/255 gt."""
    rng = np.random.RandomState(seed)
    pred_u8 = (rng.rand(size, size) * 255).astype(np.uint8)
    gt_u8 = np.where(rng.rand(size, size) > 0.6, 255, 0).astype(np.uint8)
    return pred_u8, gt_u8


def _blob(h, w, box=(6, 20, 10, 28)):
    g = np.zeros((h, w), np.uint8)
    g[box[0]:box[1], box[2]:box[3]] = 255
    return g


def _host_cases():
    rng = np.random.RandomState(8)
    rand = lambda h, w: (rng.rand(h, w) * 255).astype(np.uint8)
    cases = {f"pair{s}": make_pair(s) for s in range(5)}
    cases["blob"] = (rand(32, 32), _blob(32, 32))
    cases["random_gt"] = (rand(32, 32), np.where(rng.rand(32, 32) > 0.5, 255, 0).astype(np.uint8))
    cases["empty_gt"] = (rand(32, 32), np.zeros((32, 32), np.uint8))
    cases["full_gt"] = (rand(32, 32), np.full((32, 32), 255, np.uint8))
    cases["constant_pred"] = (np.full((32, 32), 77, np.uint8), _blob(32, 32))
    cases["perfect"] = (_blob(32, 32), _blob(32, 32))
    cases["odd_37x23"] = (rand(37, 23), _blob(37, 23, (3, 30, 4, 15)))
    cases["narrow_range"] = ((rng.rand(32, 32) * 60 + 80).astype(np.uint8), _blob(32, 32))
    return cases


HOST_CASES = _host_cases()
HOST_FUNCTIONS = {
    "adaptive_threshold": lambda S, p, g: S.adaptive_threshold(p),
    "threshold_histograms": lambda S, p, g: S.threshold_histograms(p, g),
    "fmeasure_curve": lambda S, p, g: S.fmeasure_curve(*S.threshold_histograms(p, g), int(np.count_nonzero(g))),
    "adaptive_fmeasure": lambda S, p, g: S.adaptive_fmeasure(p, g),
    "emeasure_curve": lambda S, p, g: S.emeasure_curve(*S.threshold_histograms(p, g), int(np.count_nonzero(g)), g.size),
    "adaptive_emeasure": lambda S, p, g: S.adaptive_emeasure(p, g),
    "smeasure": lambda S, p, g: S.smeasure(p, g),
    "mae": lambda S, p, g: S.mae(p, g),
    "weighted_fmeasure": lambda S, p, g: S.weighted_fmeasure(p, g),
}


# ---------------------------------------------------------------- host algorithms


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_prepare_matches_jax(case):
    pred_u8, gt_u8 = HOST_CASES[case]
    got, ref = PS.prepare(pred_u8, gt_u8), JS.prepare(pred_u8, gt_u8)
    assert got[0].dtype == ref[0].dtype == np.float64 and got[1].dtype == ref[1].dtype == bool
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("fn", sorted(HOST_FUNCTIONS))
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_metric_matches_jax_exactly(case, fn):
    pred, gt = JS.prepare(*HOST_CASES[case])
    got, ref = HOST_FUNCTIONS[fn](PS, pred, gt), HOST_FUNCTIONS[fn](JS, pred, gt)
    got, ref = (list(x) if isinstance(x, tuple) else [x] for x in (got, ref))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))


@pytest.mark.parametrize("num_classes", [2, 3, 5])
def test_miou_matches_jax_exactly(num_classes):
    rng = np.random.RandomState(num_classes)
    pc, gc = rng.randint(0, num_classes, (2, 24, 20)), rng.randint(-1, num_classes + 1, (2, 24, 20))
    assert PS.miou(pc, gc, num_classes) == JS.miou(pc, gc, num_classes)


# ---------------------------------------------------------------- evaluators


def _batches(seed=9):
    """Three batches of (prob, gt) float maps in [0, 1]: blobs, one empty and
    one full gt, sizes that change between batches."""
    rng = np.random.RandomState(seed)
    out = []
    for b, (h, w) in zip((2, 1, 3), ((24, 24), (20, 28), (24, 24))):
        prob = rng.rand(b, h, w).astype(np.float32)
        gt = np.zeros((b, h, w), np.float32)
        gt[:, 4:h - 6, 6:w - 4] = 1.0
        out.append((prob, gt))
    out[1][1][0] = 0.0
    out[2][1][1] = 1.0
    return out


def _make(module, name):
    return getattr(module, name)(prefix="SOD") if name != "meanIntersectionOverUnion" else getattr(module, name)()


EVALUATORS = ["Smeasure", "MAE", "Fmeasure", "Emeasure", "WeightedFmeasure", "meanIntersectionOverUnion"]


@pytest.mark.parametrize("name", EVALUATORS)
def test_evaluator_matches_jax(name):
    assert METRICS.get(name) is getattr(PE, name)
    port, ref = _make(PE, name), _make(JE, name)
    for prob, gt in _batches():
        port.process(prob, gt)
        ref.process(prob, gt)
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EVAL_TOL, err_msg=k)
    # a second stream after reset gives the same numbers again
    port.reset()
    for prob, gt in _batches():
        port.process(prob, gt)
    assert port.compute() == got


def test_miou_multiclass_scores_match_jax():
    rng = np.random.RandomState(4)
    port, ref = PE.meanIntersectionOverUnion(num_classes=3), JE.meanIntersectionOverUnion(num_classes=3)
    for _ in range(2):
        scores = rng.randn(2, 16, 16, 3).astype(np.float32)
        gt = (rng.randint(0, 3, (2, 16, 16, 1)) / 255.0).astype(np.float32)
        port.process(scores, gt)
        ref.process(scores, gt)
    assert port.compute() == ref.compute()


@pytest.mark.parametrize("name", ["Smeasure", "MAE", "Fmeasure", "Emeasure"])
def test_process_stats_matches_jax_on_the_same_stats(name):
    port, ref = _make(PE, name), _make(JE, name)
    assert port.supports_device_stats and ref.supports_device_stats
    for prob, gt in _batches():
        stats = statistics_to_host(batch_statistics(torch.from_numpy(prob), torch.from_numpy(gt)))
        port.process_stats(stats)
        ref.process_stats(stats)
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EVAL_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["Smeasure", "MAE", "Fmeasure", "Emeasure"])
def test_process_stats_equals_process(name):
    """The device-stats route equals the full-map route (tests/test_metrics.py:197-221)."""
    host, dev = _make(PE, name), _make(PE, name)
    for prob, gt in _batches(10):
        host.process(prob, gt)
        dev.process_stats(statistics_to_host(batch_statistics(torch.from_numpy(prob), torch.from_numpy(gt))))
    hv, dv = host.compute(), dev.compute()
    for k in hv:
        np.testing.assert_allclose(dv[k], hv[k], **ROUTE_TOL, err_msg=k)


def test_parity_reduction_is_mean_of_prefix_means():
    m = PE.MAE()
    rng = np.random.RandomState(5)
    vals = []
    for _ in range(4):
        pred = rng.rand(1, 16, 16).astype(np.float32)
        gt = (rng.rand(1, 16, 16) > 0.5).astype(np.float32)
        m.process(pred, gt)
        vals.append(PS.mae(*PS.prepare((pred[0] * 255).astype(np.uint8), (gt[0] * 255).astype(np.uint8))))
    out = m.compute()
    assert out["COD/MAE"] == pytest.approx(np.mean([np.mean(vals[: i + 1]) for i in range(4)]))
    assert out["COD/MAE_strict"] == pytest.approx(np.mean(vals))


def test_evaluator_refuses_a_shape_mismatch():
    with pytest.raises(ValueError, match="shape mismatch"):
        PE.Smeasure().process(np.zeros((1, 8, 8, 1)), np.zeros((1, 8, 9)))


# ---------------------------------------------------------------- batch_statistics


def _stat_case(name):
    rng = np.random.RandomState(len(name))
    if name == "3d":
        return rng.rand(3, 24, 24).astype(np.float32), (rng.rand(3, 24, 24) > 0.5).astype(np.float32)
    if name == "4d":
        return rng.rand(3, 24, 24, 1).astype(np.float32), (rng.rand(3, 24, 24, 1) > 0.5).astype(np.float32)
    if name == "uint8_label":
        label = torch.from_numpy(np.where(rng.rand(2, 24, 24, 1) > 0.5, 255, 0).astype(np.uint8))
        return rng.rand(2, 24, 24, 1).astype(np.float32), scale_plane(label).numpy()
    if name == "odd_37x23":
        gt = np.zeros((2, 37, 23), np.float32)
        gt[:, 5:30, 3:17] = 1.0
        return rng.rand(2, 37, 23).astype(np.float32), gt
    if name == "above_jax_chunk_160x160":
        gt = np.zeros((1, 160, 160), np.float32)
        gt[0, 30:110, 40:150] = 1.0
        return rng.rand(1, 160, 160).astype(np.float32), gt
    if name == "empty_full_constant":
        prob = rng.rand(3, 32, 32).astype(np.float32)
        prob[2] = 0.4
        gt = np.stack([np.zeros((32, 32)), np.ones((32, 32)), _blob(32, 32) / 255.0]).astype(np.float32)
        return prob, gt
    if name == "blob_soft":
        gt = (_blob(32, 32) / 255.0).astype(np.float32)[None].repeat(2, 0)
        prob = np.clip(gt * 0.8 + rng.rand(2, 32, 32).astype(np.float32) * 0.3, 0, 1)
        return prob, gt
    raise KeyError(name)


STAT_CASES = ["3d", "4d", "uint8_label", "odd_37x23", "above_jax_chunk_160x160", "empty_full_constant", "blob_soft"]


@pytest.mark.parametrize("case", STAT_CASES)
def test_batch_statistics_matches_jax(case):
    prob, label = _stat_case(case)
    got = statistics_to_host(batch_statistics(torch.from_numpy(prob), torch.from_numpy(label)))
    ref = {k: np.asarray(v) for k, v in jax_batch_statistics(jnp.asarray(prob), jnp.asarray(label)).items()}
    assert sorted(got) == sorted(ref)
    for k in ("fg_hist", "bg_hist", "gt_count", "n_pixels"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["mae_sum"], ref["mae_sum"], rtol=1e-5, err_msg="mae_sum")
    np.testing.assert_allclose(got["sm"], ref["sm"], **SM_TOL, err_msg="sm")


def test_batch_statistics_tensors_stay_on_the_device_as_counts():
    prob, label = _stat_case("3d")
    stats = batch_statistics(torch.from_numpy(prob), torch.from_numpy(label))
    assert stats["fg_hist"].shape == (3, 256) and stats["fg_hist"].dtype == torch.int64
    assert int(stats["fg_hist"].sum() + stats["bg_hist"].sum()) == prob.size
    assert stats["gt_count"].tolist() == stats["fg_hist"].sum(1).tolist()
    # an inference-mode prediction (cod.predict's) is taken as it is
    with torch.inference_mode():
        inf = torch.from_numpy(prob) * 1.0
    assert torch.equal(batch_statistics(inf, torch.from_numpy(label))["sm"], stats["sm"])


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.3, 0.6), (0.31, 0.35), (0.5, 0.9), (0.02, 0.2)])
def test_batch_statistics_equal_the_host_path(lo, hi):
    """Histograms and counts equal the host's ``prepare`` and
    ``threshold_histograms`` exactly, also on narrow prediction ranges,
    where a mapminmax in fp32 would bin some values apart; S-measure and
    MAE agree to float64 rounding."""
    rng = np.random.RandomState(int(hi * 100))
    prob = (lo + (hi - lo) * rng.rand(4, 40, 36)).astype(np.float32)
    gt = np.zeros((4, 40, 36), np.float32)
    gt[:, 8:30, 5:22] = 1.0
    gt[3] = rng.rand(40, 36) > 0.5
    stats = statistics_to_host(batch_statistics(torch.from_numpy(prob), torch.from_numpy(gt)))
    for i in range(4):
        pred, g = PS.prepare((prob[i] * 255).astype(np.uint8), (gt[i] * 255).astype(np.uint8))
        fg, bg = PS.threshold_histograms(pred, g)
        np.testing.assert_array_equal(stats["fg_hist"][i], fg)
        np.testing.assert_array_equal(stats["bg_hist"][i], bg)
        assert stats["gt_count"][i] == np.count_nonzero(g) and stats["n_pixels"][i] == g.size
        np.testing.assert_allclose(stats["mae_sum"][i], PS.mae(pred, g) * g.size, rtol=1e-12)
        np.testing.assert_allclose(stats["sm"][i], PS.smeasure(pred, g), rtol=1e-10, atol=1e-12)


def test_smeasure_region_follows_the_host_on_a_one_pixel_quadrant():
    """A gt whose centroid sits on the last row and column leaves one-pixel
    quadrants, which the host scores 1 or 0 by equality."""
    gt = np.zeros((1, 9, 7), np.float32)
    gt[0, 8, 6] = 1.0
    gt[0, 7, 5] = 1.0
    prob = np.random.RandomState(2).rand(1, 9, 7).astype(np.float32)
    stats = statistics_to_host(batch_statistics(torch.from_numpy(prob), torch.from_numpy(gt)))
    pred, g = PS.prepare((prob[0] * 255).astype(np.uint8), (gt[0] * 255).astype(np.uint8))
    np.testing.assert_allclose(stats["sm"][0], PS.smeasure(pred, g), rtol=1e-10, atol=1e-12)


def test_statistics_to_host_is_one_copy_per_batch(monkeypatch):
    prob, label = _stat_case("3d")
    stats = batch_statistics(torch.from_numpy(prob), torch.from_numpy(label))
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(self.shape) or real_cpu(self, *a, **k))
    host = statistics_to_host(stats)
    assert calls == [torch.Size([3, 516])]
    for k, v in stats.items():
        np.testing.assert_array_equal(host[k], v.numpy())
    assert host["fg_hist"].dtype == np.int64 and host["sm"].dtype == np.float64
