"""The port's run-time switches (``dgtd_tpu_torch/core/flags.py``): the
diffusion stencil's layout and ``debug_nans``. Plain torch on the CPU;
the layout against the JAX model is in ``tests/test_torch_cod.py``.
"""

import pytest
import torch
import torch.nn as nn

from dgtd_tpu_torch.core import flags
from dgtd_tpu_torch.models import diffusion as MD
from dgtd_tpu_torch.models.cod import cod

TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2, drop_path_rate=0.0, convnext_drop_path_rate=0.0)
# the two layouts' plain steps sum the k² taps in other orders (fp32)
PROB_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


@pytest.fixture
def layout():
    """Set the layout flag for a test and put it back afterwards."""
    saved = flags.diffusion_plane_layout
    yield lambda value: flags.set_flag("diffusion_plane_layout", value)
    flags.set_flag("diffusion_plane_layout", saved)


@pytest.fixture
def nan_checks():
    yield
    flags.set_flag("debug_nans", False)


def test_set_flag_refuses_unknown_names():
    for name in ("no_such_flag", "set_flag", "_nan_hook", "torch"):
        with pytest.raises(AttributeError, match="unknown flag"):
            flags.set_flag(name, True)


def test_defaults():
    assert flags.diffusion_plane_layout is None and flags.debug_nans is False


def _batch(seed, b=2, h=64, w=64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h, w, 3, generator=g), torch.rand(b, h, w, 1, generator=g),
            (torch.rand(b, h, w, 1, generator=g) > 0.5).float())


def _spy(monkeypatch, name):
    calls = []
    real = getattr(MD, name)

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(MD, name, spy)
    return calls


def test_layout_false_runs_the_nhwc_stencil_and_matches_the_planes(layout, monkeypatch):
    """False sends MessagePassing to ``diffusion_nhwc`` (x (B, g, g, C)),
    None and True to ``diffusion_planes`` (x (B·C, g, g)), read at each
    call; the probabilities agree."""
    model = cod(dtype=torch.float32, seed=0, **TINY)
    img, dep, _ = _batch(0)
    nhwc, planes = _spy(monkeypatch, "diffusion_nhwc"), _spy(monkeypatch, "diffusion_planes")
    probs = {}
    for value in (None, True, False):
        layout(value)
        probs[value] = model.predict(img, dep)[0]
    assert planes == [(2 * 8, 8, 8)] * 2 and nhwc == [(2, 8, 8, 8)]
    torch.testing.assert_close(probs[True], probs[None], rtol=0, atol=0)
    torch.testing.assert_close(probs[False], probs[True], rtol=0, atol=PROB_ATOL)


def test_layout_false_loss_and_every_gradient_match_the_planes(layout):
    """The NHWC forward with the plane backward on NHWC gradients gives the
    plane layout's loss and gradients."""
    model = cod(dtype=torch.float32, seed=1, **TINY)
    img, dep, label = _batch(1)
    results = {}
    for value in (True, False):
        layout(value)
        model.zero_grad(set_to_none=True)
        loss, aux = model.loss(img, dep, label)
        loss.backward()
        results[value] = (aux, {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})
    (aux_t, grads_t), (aux_f, grads_f) = results[True], results[False]
    for k in aux_t:
        torch.testing.assert_close(aux_f[k], aux_t[k], rtol=LOSS_RTOL, atol=0)
    assert sorted(grads_f) == sorted(grads_t)
    top = max(float(g.abs().max()) for g in grads_t.values())
    for k, g in grads_t.items():
        scale = max(float(g.abs().max()), top * 1e-4)
        torch.testing.assert_close(grads_f[k], g, rtol=0, atol=GRAD_RTOL * scale, msg=k)
    # the regressor's gradient comes through the stencil's backward
    assert float(grads_f["hitnet.backbone.prompt_encoder.propagation_weight_regressor.reg.weight"].abs().max()) > 0


class _Sqrt(nn.Module):
    def forward(self, x):
        return torch.sqrt(x)


class _SafeSqrt(nn.Module):
    """Finite forward at 0, NaN gradient there: 0 · d sqrt(x)/dx = 0 · inf."""

    def forward(self, x):
        return torch.where(x > 0, torch.sqrt(x), torch.zeros_like(x))


def test_debug_nans_raises_in_forward_naming_the_module(nan_checks):
    layer = nn.Sequential(nn.Linear(3, 3), _Sqrt())
    x = -torch.ones(2, 3) * 1e3
    flags.set_flag("debug_nans", True)
    with pytest.raises(FloatingPointError, match=r"NaN in the output of _Sqrt\(\)"):
        layer(x)
    with pytest.raises(FloatingPointError, match=r"infinity in the output of Identity\(\)"):
        nn.Identity()(torch.tensor([1.0, float("inf")]))
    flags.set_flag("debug_nans", False)
    assert torch.isnan(_Sqrt()(-torch.ones(2))).all()


def test_debug_nans_raises_in_backward_and_is_silent_once_reset(nan_checks):
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    flags.set_flag("debug_nans", True)
    assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    y = _SafeSqrt()(x)
    assert torch.isfinite(y).all()
    with pytest.raises(RuntimeError, match="returned nan"):
        y.sum().backward()
    flags.set_flag("debug_nans", False)
    assert not torch.is_anomaly_enabled()
    x.grad = None
    _SafeSqrt()(x).sum().backward()
    assert torch.isnan(x.grad[0]) and float(x.grad[1]) == 0.25


def test_debug_nans_passes_a_finite_model(nan_checks):
    flags.set_flag("debug_nans", True)
    model = cod(dtype=torch.float32, seed=0, **TINY)
    img, dep, label = _batch(2)
    prob = model.predict(img, dep)[0]
    assert torch.isfinite(prob).all()
    model.loss(img, dep, label)[0].backward()
