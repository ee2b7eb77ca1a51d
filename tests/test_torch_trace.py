"""The port's spans (``dgtd_tpu_torch/core/trace.py``) on the CPU, no JAX:
  * ``span`` is one shared no-op context, and calls no ``record_function``,
    while no profiler records;
  * under ``torch.profiler.profile``, a train step and a served batch of a
    tiny ``cod`` and a tiny ``DQnet`` record every span, each once and
    nested as the train step and the forwards run them; ``dgtd.train.step``
    is opened with the step index and the path (``eager`` on the CPU);
    ``dgtd.train.all_reduce`` only where a
    gradient group exists;
  * a traced batched call of a tiny depther opens ``dgtd.depther`` once,
    ``dgtd.depther.backbone`` and ``dgtd.depther.head`` inside it in that
    order, and ``dgtd.depther.attention`` once a block inside the
    backbone; an untraced one opens none;
  * a ``torch.export`` of a tiny ``cod`` bundle holds no profiler operation
    and still equals the eager ``predict``;
  * ``tools/profile_step.py``'s layer table names the spans.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgtd_tpu_torch.core import trace
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.models import dinov2
from dgtd_tpu_torch.models.dpt import DinoDPTDepther
from dgtd_tpu_torch.models.dqnet import DQnet
from dgtd_tpu_torch.tools import export_serving as E
from dgtd_tpu_torch.tools import profile_step
from dgtd_tpu_torch.tools.depth_gen import Dinov2Depther
from dgtd_tpu_torch.train import state
from dgtd_tpu_torch.train.optim import Optimizer

TINY_COD = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
                channel=8, latent_dim=8, grid=8, refine_iters=2)
TINY_DQNET = dict(variant="tiny", channel=8, cross_size=11)
OPTIM = {"optimizer": {"type": "AdamW", "lr": 1e-4, "weight_decay": 0.05}}
SIZE = 64

FORWARD = ("dgtd.prompt_encoder", "dgtd.prompt_decoders", "dgtd.backbone", "dgtd.decode")
PHASES = ("dgtd.train.normalize", "dgtd.train.forward", "dgtd.train.backward", "dgtd.train.optimizer")


def _model(kind):
    if kind == "cod":
        return cod(dtype=torch.float32, seed=0, **TINY_COD)
    return DQnet(dtype=torch.float32, seed=0, **TINY_DQNET)


def _batch(seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    return {"input": torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=g, dtype=torch.uint8),
            "depth": torch.randint(0, 256, (b, SIZE, SIZE, 1), generator=g, dtype=torch.uint8),
            "label": torch.randint(0, 2, (b, SIZE, SIZE, 1), generator=g, dtype=torch.uint8) * 255}


def _spans(prof):
    """{name: [(start, end)]} of the ``dgtd.*`` ranges of a profile."""
    out = {}
    for e in prof.events():
        if e.name.startswith("dgtd."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler on")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = trace.span("dgtd.train.step", "3"), trace.span("dgtd.backbone")
    assert a is b
    with a, b:
        pass
    model = _model("cod")
    opt = Optimizer(model.named_parameters(), OPTIM, 1, 1)
    state.train_step(model, opt, _batch(), 0, 1)
    model.predict(torch.rand(1, SIZE, SIZE, 3), torch.rand(1, SIZE, SIZE, 1))


def test_span_is_a_record_function_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("dgtd.probe", "7") as ctx:
            assert isinstance(ctx, torch.profiler.record_function)
    assert "dgtd.probe" in _spans(prof)


@pytest.mark.parametrize("kind", ["cod", "DQnet"])
def test_train_step_records_its_spans_nested(kind, monkeypatch):
    opened = []
    real = trace.record_function

    def recording(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(trace, "record_function", recording)
    model = _model(kind)
    opt = Optimizer(model.named_parameters(), OPTIM, 1, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state.train_step(model, opt, _batch(), 3, 1)
    spans = _spans(prof)
    forward = FORWARD if kind == "cod" else FORWARD[1:]
    want = {"dgtd.train.step", *PHASES, "dgtd.loss", *forward}
    assert set(spans) == want and all(len(v) == 1 for v in spans.values())
    assert ("dgtd.train.step", "3 eager") in opened
    step = spans["dgtd.train.step"][0]
    assert all(_within(spans[p][0], step) for p in PHASES)
    # the phases in order, each after the last has closed
    ends = [spans[p][0] for p in PHASES]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    fwd = spans["dgtd.train.forward"][0]
    assert all(_within(spans[n][0], fwd) for n in (*forward, "dgtd.loss"))
    # the network's parts in the order the forward runs them, then the loss
    order = [spans[n][0] for n in (*forward, "dgtd.loss")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    assert "dgtd.train.all_reduce" not in spans


@pytest.mark.parametrize("kind", ["cod", "DQnet"])
def test_predict_records_its_spans_nested(kind):
    model = _model(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.predict(torch.rand(2, SIZE, SIZE, 3), torch.rand(2, SIZE, SIZE, 1))
    spans = _spans(prof)
    forward = FORWARD if kind == "cod" else FORWARD[1:]
    assert set(spans) == {"dgtd.predict", *forward} and all(len(v) == 1 for v in spans.values())
    assert all(_within(spans[n][0], spans["dgtd.predict"][0]) for n in forward)


def test_all_reduce_span_only_with_a_gradient_group(monkeypatch):
    reduced = []
    monkeypatch.setattr(state, "grad_group", lambda: "group")
    monkeypatch.setattr(state, "all_mean_", lambda tensors, group: reduced.append(group))
    model = _model("DQnet")
    opt = Optimizer(model.named_parameters(), OPTIM, 1, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state.train_step(model, opt, _batch(), 0, 1)
    spans = _spans(prof)
    assert reduced == ["group"]
    ar = spans["dgtd.train.all_reduce"][0]
    assert _within(ar, spans["dgtd.train.step"][0])
    assert spans["dgtd.train.backward"][0][1] <= ar[0] and ar[1] <= spans["dgtd.train.optimizer"][0][0]


@pytest.mark.parametrize("traced", [False, True])
def test_depther_batch_records_its_spans_nested(traced, monkeypatch):
    opened = []
    real = trace.record_function

    def recording(name, args=None):
        opened.append(name)
        return real(name, args)

    monkeypatch.setattr(trace, "record_function", recording)
    monkeypatch.setitem(dinov2.DINOV2_ARCHS, "tiny", (16, 3, 2, "mlp"))
    torch.manual_seed(0)
    model = DinoDPTDepther(arch="tiny", n_bins=8, channels=8, post_process_channels=(4, 8, 16, 32), pretrain_grid=3)
    depther = Dinov2Depther(model, torch.device("cpu"))
    images = torch.randint(0, 256, (2, 30, 44, 3), dtype=torch.uint8)
    if not traced:
        assert depther.batch(images).shape == (2, 30, 44) and opened == []
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        depther.batch(images)
    spans = _spans(prof)
    assert set(spans) == {"dgtd.depther", "dgtd.depther.backbone", "dgtd.depther.head", "dgtd.depther.attention"}
    assert len(spans["dgtd.depther.attention"]) == 3 and sorted(opened) == sorted(
        ["dgtd.depther", "dgtd.depther.backbone", "dgtd.depther.head"] + ["dgtd.depther.attention"] * 3)
    outer, backbone, head = spans["dgtd.depther"][0], spans["dgtd.depther.backbone"][0], spans["dgtd.depther.head"][0]
    assert _within(backbone, outer) and _within(head, outer) and backbone[1] <= head[0]
    assert all(_within(a, backbone) for a in spans["dgtd.depther.attention"])


def test_export_holds_no_profiler_op_and_equals_eager(tmp_path):
    model = cod(dtype=torch.float32, seed=2, **TINY_COD)
    E.export_bundle(model, str(tmp_path), sizes=(48,), platforms=["cpu"])
    exported = torch.export.load(str(tmp_path / "predict_48_cpu.pt2"))
    targets = {str(n.target) for m in exported.graph_module.modules() if hasattr(m, "graph")
               for n in m.graph.nodes if n.op == "call_function"}
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    rng = np.random.RandomState(0)
    img, dep = rng.randn(1, 48, 48, 3).astype(np.float32), rng.rand(1, 48, 48, 1).astype(np.float32)
    got = E.ServingModel.load(str(tmp_path), "cpu")(img, dep)
    want = model.predict(torch.from_numpy(img), torch.from_numpy(dep))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_profile_step_layer_table_names_the_spans(train):
    model = _model("cod")
    batch = _batch()
    if train:
        opt = Optimizer(model.named_parameters(), OPTIM, 1, 1)

        def run():
            state.train_step(model, opt, batch, 0, 1)
    else:
        img, dep = torch.rand(1, SIZE, SIZE, 3), torch.rand(1, SIZE, SIZE, 1)

        def run():
            model.predict(img, dep)

    report = profile_step.profile_spans(run, iters=2, cuda=False)
    names = [row["span"] for row in report["spans"]]
    outer = "dgtd.train.step" if train else "dgtd.predict"
    assert names[0] == outer and set(FORWARD) <= set(names)
    if train:
        assert set(PHASES) | {"dgtd.loss"} <= set(names)
    for row in report["spans"]:
        assert row["calls"] == pytest.approx(1.0) and row["host_ms"] > 0
        assert row["device_ms"] == row["idle_ms"] == row["launches"] == 0.0
    assert report["busy_ms"] == 0.0 and report["window_ms"] > 0
    lines = profile_step.span_lines(report, "step" if train else "batch")
    assert any(outer in line for line in lines)
