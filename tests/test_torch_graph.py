"""The train step's CUDA graphs (``train/state.py``) and the device
constants that make a step capturable (``core/device.py::constant``). No JAX.

On the CPU:
  * the ImageNet mean and std, the legacy nearest resize's indices and the
    FFT high-pass mask are bit-equal to the numpy arrays they were made
    from, and each is made once per key and device;
  * ``eager_reason`` keeps each step that cannot be captured eager: the
    CPU, a gradient group, a data×space layout, ``bf16_state``'s optimizer,
    a checkpointed block, anomaly mode;
  * an eager CPU step is the step as it was: normalize, loss, backward,
    AdamW at the step's lr, bit for bit, counted in ``EAGER_STEPS``;
  * a graphed step that has captured nothing follows the batch signature,
    and one that has captured keeps its own.

On the card (``-m cuda``; tiny ``cod`` and ``DQnet``, bf16 autocast as the
recipes run): 4 graphed steps equal 4 eager ones from the same weights and
seed, bit for bit under deterministic algorithms (without them cuDNN's and
``index_add``'s atomics move two eager runs apart as far as a graphed run
from either: a tiny-gradient leaf's AdamW update flips sign); the DropPath
draws of a replayed step equal to the eager step's for the same ``(seed,
step)``; a partial batch between replays, or before the first capture,
runs eagerly and the sequence equals the all-eager one; the ``ops/``
counters count the eager and capture steps' launches and a profiler trace
finds the same hand-written kernels under a replay's ``cudaGraphLaunch``;
``GRAPH_STEPS``, ``EAGER_STEPS`` and ``CAPTURES``.
"""

import re
import types

import numpy as np
import pytest
import torch

from dgtd_tpu_torch.core import device as D
from dgtd_tpu_torch.data import device_norm
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.models.dqnet import DQnet
from dgtd_tpu_torch.ops import diffusion
from dgtd_tpu_torch.train import state
from dgtd_tpu_torch.train.optim import AdamWBf16State, Optimizer
from dgtd_tpu_torch.utils import image

TINY_COD = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
                channel=8, latent_dim=8, grid=8, refine_iters=2)
TINY_DQNET = dict(variant="tiny", channel=8, cross_size=11)
OPTIM = {"optimizer": {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05}}
SIZE = 64


def _model(kind, dtype=torch.float32, **kw):
    if kind == "cod":
        return cod(dtype=dtype, seed=0, **{**TINY_COD, **kw})
    return DQnet(dtype=dtype, seed=0, **{**TINY_DQNET, **kw})


def _batch(seed=0, b=2, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    out = {"input": torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=g, dtype=torch.uint8),
           "depth": torch.randint(0, 256, (b, SIZE, SIZE, 1), generator=g, dtype=torch.uint8),
           "label": torch.randint(0, 2, (b, SIZE, SIZE, 1), generator=g, dtype=torch.uint8) * 255}
    return {k: v.to(device) for k, v in out.items()}


# -- the device constants ------------------------------------------------------


def _normalize_before(x):
    mean = torch.as_tensor(device_norm.IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(device_norm.IMAGENET_STD, device=x.device)
    return (x.float() / 255.0 - mean) / std


def _nearest_before(x, size):
    h, w = x.shape[-2:]
    rows = np.floor(np.arange(size[0]) * (h / size[0])).astype(np.int64)
    cols = np.floor(np.arange(size[1]) * (w / size[1])).astype(np.int64)
    return x.index_select(-2, torch.as_tensor(rows)).index_select(-1, torch.as_tensor(cols))


def _high_pass_before(x, rate):
    h, w = x.shape[-2:]
    line = int((h * w * rate) ** 0.5 // 2)
    keep = np.ones((h, w), dtype=np.float32)
    keep[h // 2 - line : h // 2 + line, w // 2 - line : w // 2 + line] = 0.0
    spec = torch.fft.fft2(x.float(), dim=(-2, -1), norm="forward") * torch.as_tensor(np.fft.ifftshift(keep))
    return torch.fft.ifft2(spec, dim=(-2, -1), norm="forward").real.abs().to(x.dtype)


@pytest.mark.parametrize("what", ["normalize", "nearest", "high_pass"])
def test_constants_are_bit_equal_and_made_once_per_key_and_device(what):
    g = torch.Generator().manual_seed(3)
    if what == "normalize":
        x = torch.randint(0, 256, (2, 5, 7, 3), generator=g, dtype=torch.uint8)
        got, want = device_norm.normalize_image(x), _normalize_before(x)
        keys = [("imagenet_mean", torch.device("cpu")), ("imagenet_std", torch.device("cpu"))]
    elif what == "nearest":
        x = torch.rand(2, 3, 23, 17, generator=g)
        got, want = image.resize_nearest(x, (12, 40)), _nearest_before(x, (12, 40))
        keys = [(("nearest_index", 23, 12), torch.device("cpu")), (("nearest_index", 17, 40), torch.device("cpu"))]
    else:
        x = torch.rand(2, 3, 24, 20, generator=g)
        got, want = image.fft_high_pass(x, 0.3), _high_pass_before(x, 0.3)
        keys = [(("fft_high_pass", 24, 20, 0.3), torch.device("cpu"))]
    assert torch.equal(got, want)
    made = [D.CONSTANTS[k] for k in keys]
    # a second call makes nothing: the same tensors, no new entry
    n = len(D.CONSTANTS)
    {"normalize": lambda: device_norm.normalize_image(x), "nearest": lambda: image.resize_nearest(x, (12, 40)),
     "high_pass": lambda: image.fft_high_pass(x, 0.3)}[what]()
    assert len(D.CONSTANTS) == n and all(D.CONSTANTS[k] is t for k, t in zip(keys, made))


def test_a_constant_is_made_once_per_device():
    calls = []

    def make():
        calls.append(1)
        return np.arange(4, dtype=np.float32)

    a, b = D.constant(("probe", 4), "cpu", make), D.constant(("probe", 4), torch.device("cpu"), make)
    m = D.constant(("probe", 4), "meta", make)
    assert a is b and len(calls) == 2 and m.device.type == "meta" and torch.equal(a, torch.arange(4.0))


# -- which steps stay eager -----------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cod():
    return _model("cod")


def _capturable(model):
    """An optimizer that passes the optimizer's rule: torch AdamW, capturable."""
    return types.SimpleNamespace(opt=torch.optim.AdamW(model.parameters(), lr=1e-3, capturable=True))


@pytest.mark.parametrize("case", ["eligible", "cpu", "grad group", "layout", "bf16_state", "non-capturable",
                                  "checkpointed", "anomaly mode"])
def test_eager_reason_keeps_each_excluded_step_eager(tiny_cod, case, monkeypatch):
    cuda = torch.device("cuda")
    model, opt, device = tiny_cod, _capturable(tiny_cod), cuda
    want = None
    if case == "cpu":
        device, want = torch.device("cpu"), "not a CUDA device"
    elif case == "grad group":
        monkeypatch.setattr(state, "grad_group", lambda: "group")
        want = "a gradient group"
    elif case == "layout":
        monkeypatch.setattr(state.space, "current", lambda: "layout")
        want = "a data×space layout"
    elif case == "bf16_state":
        opt = Optimizer(model.named_parameters(), {**OPTIM, "bf16_state": True}, 1, 1)
        assert isinstance(opt.opt, AdamWBf16State) and not opt.capturable
        want = "not torch AdamW"
    elif case == "non-capturable":
        # a CPU-built Optimizer: torch AdamW, its update not capturable
        opt, want = Optimizer(model.named_parameters(), OPTIM, 1, 1), "AdamW not capturable"
    elif case == "checkpointed":
        model, want = _model("cod", remat=True), "a checkpointed block"
    elif case == "anomaly mode":
        monkeypatch.setattr(torch, "is_anomaly_enabled", lambda: True)
        want = "anomaly mode"
    assert state.eager_reason(model, opt, device) == want


def test_an_eager_cpu_step_is_the_step_as_it_was():
    """Two CPU steps through ``train_step`` against the step spelled out:
    normalize, loss with the step's generator, backward, AdamW at the
    step's lr (floats, not capturable), gradients cleared; bit for bit."""
    model, ref = _model("cod"), _model("cod")
    opt = Optimizer(model.named_parameters(), OPTIM, 2, 1)
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=1e-3, weight_decay=0.05, eps=1e-8)
    eager, graph = state.EAGER_STEPS, state.GRAPH_STEPS
    for step in range(2):
        batch = _batch(step)
        aux = state.train_step(model, opt, batch, step, 5)
        b = device_norm.normalize_batch(batch)
        loss, ref_aux = ref.loss(b["input"], b["depth"], b["label"], generator=state.step_generator(5, step, "cpu"))
        loss.backward()
        for group in ref_opt.param_groups:
            group["lr"] = opt.lr(step)
        ref_opt.step()
        ref_opt.zero_grad(set_to_none=True)
        assert all(torch.equal(aux[k], ref_aux[k].detach()) for k in ref_aux)
    for (n, p), r in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, r), n
    assert state.EAGER_STEPS == eager + 2 and state.GRAPH_STEPS == graph and opt.graphed is None
    assert all(p.grad is None for p in model.parameters())
    assert not opt.capturable and isinstance(opt.state_dict()["param_groups"][0]["lr"], float)


class _Uncaptured:
    """A stand-in for :class:`state.GraphedStep` (which needs a card's
    stream): what ``_graphed_step`` reads of it."""

    def __init__(self, model, signature, device):
        self.model, self.signature, self.phases = model, signature, None


@pytest.mark.parametrize("case", ["first signature twice", "partial batch first", "after the capture",
                                  "another model"])
def test_an_uncaptured_graphed_step_follows_the_batch_signature(tiny_cod, case, monkeypatch):
    """A run may start on a loader's last partial batch: the step that has
    captured nothing yet is made anew for the next signature, so the full
    batches are captured; once captured, another signature stays eager."""
    monkeypatch.setattr(state, "GraphedStep", _Uncaptured)
    opt = types.SimpleNamespace(graphed=None)
    first = state._graphed_step(tiny_cod, opt, _batch(b=2 if case == "partial batch first" else 4))
    assert first is opt.graphed and first.model is tiny_cod
    if case == "after the capture":
        first.phases = ("graphs",)
    model = _model("cod") if case == "another model" else tiny_cod
    second = state._graphed_step(model, opt, _batch(b=2 if case == "after the capture" else 4))
    if case == "first signature twice":
        assert second is first
    elif case == "after the capture":
        assert second is None and opt.graphed is first
    else:
        assert second is opt.graphed and second is not first and second.model is model
        assert second.signature[1] == ("input", (4, SIZE, SIZE, 3), torch.uint8, torch.device("cpu"))


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SEED = 2 ** 31 + 11


def _train(kind, dev, sizes, graphs, **kw):
    """Steps of a fresh tiny bf16 model (the same weights every call), one a
    batch size in ``sizes``, through ``train_step`` (``graphs``) or its
    eager body alone; returns the parameters and each step's loss terms
    (``"<step>.<term>"``), by name."""
    model = _model(kind, torch.bfloat16, **kw).to(dev)
    opt = Optimizer(model.named_parameters(), OPTIM, 4, 2)
    run = state.train_step if graphs else state.eager_step
    out = {}
    for step, b in enumerate(sizes):
        aux = run(model, opt, _batch(step, b, dev), step, SEED)
        out.update({f"{step}.{k}": v.float().clone() for k, v in aux.items()})
    out.update({n: p.detach().float().clone() for n, p in model.named_parameters()})
    return out


def _bit_equal(got, want):
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert torch.equal(got[n], w), (n, float((got[n] - w).abs().max()))


@pytest.fixture
def deterministic():
    """Deterministic algorithms (cuDNN's and ``index_add``'s without atomics),
    put back after the test."""
    was = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    torch.backends.cudnn.deterministic = was[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cod", "DQnet"])
def test_cuda_graphed_steps_match_eager_steps(cuda, deterministic, kind):
    sizes = [4, 4, 4, 4]
    graph_steps, captures = state.GRAPH_STEPS, state.CAPTURES
    got = _train(kind, cuda, sizes, graphs=True)
    assert (state.GRAPH_STEPS - graph_steps, state.CAPTURES - captures) == (3, 1)
    _bit_equal(got, _train(kind, cuda, sizes, graphs=False))


@pytest.mark.cuda
def test_cuda_replayed_dropout_draws_equal_the_eager_steps(cuda, monkeypatch):
    """Every draw of a DropPath generator (``torch.rand`` with a
    ``generator``), kept by reference: in a replay the captured draws'
    buffers hold that replay's values."""
    real = torch.rand
    draws = []

    def recording(*a, **k):
        out = real(*a, **k)
        if k.get("generator") is not None:
            draws.append(out)
        return out

    monkeypatch.setattr(torch, "rand", recording)
    model = _model("cod", torch.bfloat16, drop_path_rate=0.5, convnext_drop_path_rate=0.5).to(cuda)
    opt = Optimizer(model.named_parameters(), OPTIM, 4, 2)
    eager = {}
    for step in range(4):
        draws.clear()
        state.eager_step(model, opt, _batch(step, 4, cuda), step, SEED)
        eager[step] = [d.clone() for d in draws]
    assert eager[0] and not all(torch.equal(x, y) for x, y in zip(eager[0], eager[1]))
    model = _model("cod", torch.bfloat16, drop_path_rate=0.5, convnext_drop_path_rate=0.5).to(cuda)
    opt = Optimizer(model.named_parameters(), OPTIM, 4, 2)
    for step in range(4):
        if step <= 1:
            draws.clear()
        state.train_step(model, opt, _batch(step, 4, cuda), step, SEED)
        # step 0 eager (its own draws), step 1 captures: the draws kept from
        # then on are the graph's buffers, refilled by every replay
        assert len(draws) == len(eager[step])
        assert all(torch.equal(d, e) for d, e in zip(draws, eager[step])), step


@pytest.mark.cuda
@pytest.mark.parametrize("sizes, counts", [
    # the warm-up and the partial batch eager; the capture step and two replays graphed
    ([4, 4, 4, 2, 4], (2, 3)),
    # a run that starts on a last partial batch: it and the full batch's
    # warm-up eager, then the full batches captured and replayed
    ([2, 4, 4, 4], (2, 2)),
])
def test_cuda_partial_batch_between_replays_equals_all_eager(cuda, deterministic, sizes, counts):
    eager_steps, graph_steps = state.EAGER_STEPS, state.GRAPH_STEPS
    got = _train("cod", cuda, sizes, graphs=True)
    assert (state.EAGER_STEPS - eager_steps, state.GRAPH_STEPS - graph_steps) == counts
    _bit_equal(got, _train("cod", cuda, sizes, graphs=False))


def _kernels(fn, path):
    """The kernels ``fn()`` runs on the card, by name: those launched one by
    one, and those launched by a ``cudaGraphLaunch`` (a replay's), from a
    ``torch.profiler`` trace matched by correlation id."""
    import json
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    graph = {e["args"]["correlation"] for e in events
             if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaGraphLaunch"}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return (Counter(e["name"] for e in kernels if e["args"]["correlation"] not in graph),
            Counter(e["name"] for e in kernels if e["args"]["correlation"] in graph))


@pytest.mark.cuda
def test_cuda_ops_counters_read_the_same_launches_on_both_paths(cuda, tmp_path):
    """The ``ops/`` counters count their wrappers' launches: an eager step's
    and the capture's alike, a replay's none. That a replay runs the same
    hand-written kernels as an eager step is read from a profiler trace:
    the stencil, LayerNorm and MSDA kernels, by name and number, under the
    replay's ``cudaGraphLaunch``."""
    names = [n for n in vars(diffusion) if n.endswith("LAUNCHES")]

    def counted(graphs):
        model = _model("cod", torch.bfloat16).to(cuda)
        opt = Optimizer(model.named_parameters(), OPTIM, 4, 2)
        run = state.train_step if graphs else state.eager_step
        per_step = []
        for step in range(4):
            for n in names:
                setattr(diffusion, n, 0)
            run(model, opt, _batch(step, 4, cuda), step, SEED)
            per_step.append({n: getattr(diffusion, n) for n in names})
        traced = _kernels(lambda: run(model, opt, _batch(4, 4, cuda), 4, SEED), tmp_path / f"{graphs}.json")
        return per_step, traced

    (eager, (eager_one, eager_graph)), (graphed, (replay_one, replay_graph)) = counted(False), counted(True)
    assert eager[0]["FUSED_LAUNCHES"] == 1 and eager[0]["FUSED_BWD_LAUNCHES"] == 1
    # the warm-up and the capture step count as the eager steps; replays call no wrapper
    assert graphed[:2] == eager[:2] and all(not any(c.values()) for c in graphed[2:])
    own = re.compile(r"\b(stencil|ln|msda)_\w*kernel\b").search
    mine = {k: v for k, v in eager_one.items() if own(k)}
    assert not eager_graph and any("stencil_fused_bwd_kernel" in k for k in mine)
    assert {k: v for k, v in replay_graph.items() if own(k)} == mine
    assert not any(own(k) for k in replay_one)


@pytest.mark.cuda
def test_cuda_resumed_graphed_run_equals_the_uninterrupted_one(cuda, deterministic, tmp_path):
    """Two graphed steps, a checkpoint as the train CLI writes and reads it
    (``map_location="cpu"``), a fresh model and optimizer that load it and
    go on: the same parameters and loss terms as four graphed steps."""
    whole = _train("cod", cuda, [4] * 4, graphs=True)
    model = _model("cod", torch.bfloat16).to(cuda)
    opt = Optimizer(model.named_parameters(), OPTIM, 4, 2)
    for step in range(2):
        state.train_step(model, opt, _batch(step, 4, cuda), step, SEED)
    torch.save({"state_dict": model.state_dict(), "optimizer": opt.state_dict()}, tmp_path / "half.pth")
    ckpt = torch.load(tmp_path / "half.pth", map_location="cpu", weights_only=True)
    model = _model("cod", torch.bfloat16).to(cuda)
    model.load_state_dict(ckpt["state_dict"])
    opt = Optimizer(model.named_parameters(), OPTIM, 4, 2)
    opt.load_state_dict(ckpt["optimizer"])
    st = next(iter(opt.opt.state.values()))
    assert st["step"].device.type == "cuda" and all(torch.is_tensor(g["lr"]) for g in opt.opt.param_groups)
    got = {}
    for step in range(2, 4):
        aux = state.train_step(model, opt, _batch(step, 4, cuda), step, SEED)
        got.update({f"{step}.{k}": v.float().clone() for k, v in aux.items()})
    got.update({n: p.detach().float().clone() for n, p in model.named_parameters()})
    _bit_equal(got, {k: v for k, v in whole.items() if not k.startswith(("0.", "1."))})
