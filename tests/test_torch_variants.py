"""The port's ``baseline`` and the prompt toggles of ``cod``
(``use_prompts=False``: the reference's ``pure_hitnet``;
``inject_prompts=False``: ``cod_no_te``) vs ``dgtd_tpu`` (fp32, CPU): the
prediction, the loss terms and every parameter gradient on weights carried
across by ``state_dict_from_flax``; ``baseline``'s frozen prompt modules
over optimizer steps, through the Runner and the train CLI, the val pass
and the serving CLI; ``baseline_init``.

One JAX init of tiny ``cod`` serves every variant: ``baseline`` takes it
with a k = 3 weight regressor, ``use_prompts=False`` without the prompt
modules.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgtd_tpu.core.registry import MODELS as JAX_MODELS
from dgtd_tpu_torch.core.config import load_config
from dgtd_tpu_torch.core.registry import MODELS
from dgtd_tpu_torch.models.cod import baseline as PortBaseline
from dgtd_tpu_torch.models import diffusion as MD
from dgtd_tpu_torch.train import cli
from dgtd_tpu_torch.train.hooks import baseline_init
from dgtd_tpu_torch.train.optim import Optimizer
from dgtd_tpu_torch.train.state import train_step
from torch_jax_parity import (NO_DROP, SHAPE, TINY, assert_matches_jax, batch, carry, flat_variables,
                              jax_results, nested, serve_and_check, torch_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ("hitnet/prompt_encoder/", "hitnet/prompt_decoder")
FROZEN = ("hitnet.backbone.prompt_encoder.", "hitnet.backbone.prompt_decoder.")
TINY_ARGS = [a for k, v in TINY.items() for a in ("-o", f"{k}={list(v) if isinstance(v, tuple) else v}")]


@pytest.fixture(scope="module")
def cod_tree():
    jm = JAX_MODELS.get("cod")(dtype=jnp.float32, **TINY)
    return flat_variables(jm.init(jax.random.PRNGKey(0), (1,) + SHAPE[1:] + (3,)))


def _variant_tree(cod_tree, name, overrides):
    """The JAX variables of a variant, from tiny cod's."""
    flat = dict(cod_tree)
    if not overrides.get("use_prompts", True):
        flat = {k: v for k, v in flat.items() if not k.startswith(tuple(f"params/{p}" for p in PROMPTS))}
    if name == "baseline":  # k = 3: latent·9 affinities
        rng = np.random.RandomState(7)
        key = "params/hitnet/prompt_encoder/weight_regressor/Conv_0/"
        c = TINY["latent_dim"] * 9
        flat[key + "kernel"] = (rng.randn(1, 1, 3, c) * 0.5).astype(np.float32)
        flat[key + "bias"] = np.zeros(c, np.float32)
    return flat


VARIANTS = {"baseline": ("baseline", {}), "use_prompts_false": ("cod", {"use_prompts": False}),
            "inject_prompts_false": ("cod", {"inject_prompts": False})}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, cod_tree):
    name, overrides = VARIANTS[request.param]
    flat = _variant_tree(cod_tree, name, overrides)
    jm = JAX_MODELS.get(name)(dtype=jnp.float32, **TINY, **overrides)
    ref = jax_results(jm, nested(flat), batch(0))
    return name, overrides, flat, ref, tuple(p.replace("/", ".") for p in jm.frozen_param_prefixes)


def test_variant_matches_jax(variant):
    """Prediction to 1e-5, no texture, the staged loss alone, every gradient
    to 1e-4 of its scale; the dead prompt modules get no gradient."""
    name, overrides, flat, ref, jax_frozen = variant
    pm = carry(MODELS.get(name)(dtype=torch.float32, seed=None, **TINY, **NO_DROP, **overrides), flat)
    assert ref["texture"] is None and set(ref["aux"]) == {"loss", "loss_seg"}
    has_dead = name == "baseline" or overrides == {"inject_prompts": False}
    assert pm.frozen_param_prefixes == (FROZEN if has_dead else ())
    assert len(jax_frozen) == len(pm.frozen_param_prefixes)
    if not overrides.get("use_prompts", True):
        assert not any("prompt" in n for n, _ in pm.named_parameters())
    assert_matches_jax(pm, ref, batch(0), frozen=pm.frozen_param_prefixes)


@pytest.mark.parametrize("size", [48, 704])
def test_baseline_predict_at_48_and_704_matches_jax(cod_tree, size):
    """The served sizes' extremes: a 48² input (stride-32 map 2x2) and a 704²
    one (COD_TEST's), probabilities to 1e-5."""
    flat = _variant_tree(cod_tree, "baseline", {})
    jm = JAX_MODELS.get("baseline")(dtype=jnp.float32, **TINY)
    b = batch(2, (1, size, size))
    ref = jax.jit(lambda v, i, d: jm.predict(v, i, d)[0])(nested(flat), b["input"], b["depth"])
    pm = carry(PortBaseline(dtype=torch.float32, seed=None, **TINY), flat)
    tb = torch_batch(b)
    prob = pm.predict(tb["input"], tb["depth"])[0]
    np.testing.assert_allclose(prob.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_dead_prompt_modules_launch_no_stencil_and_run_no_tower(variant):
    """baseline and both toggles never call the prompt encoder: no stencil
    call, no ConvNeXt forward."""
    name, overrides, flat, _, _ = variant
    pm = MODELS.get(name)(dtype=torch.float32, seed=0, **TINY, **overrides)
    calls = []
    handles = [m.register_forward_hook(lambda *a: calls.append(1)) for m in pm.modules()
               if type(m).__name__ in ("PromptEncoder", "ConvNeXtFPNEncoder", "MessagePassing")]
    planes = MD.diffusion_planes
    MD.diffusion_planes = lambda *a, **k: calls.append(1) or planes(*a, **k)
    try:
        tb = torch_batch(batch(1))
        pm.predict(tb["input"], tb["depth"])
        pm.loss(tb["input"], tb["depth"], tb["label"], generator=torch.Generator().manual_seed(0))
    finally:
        MD.diffusion_planes = planes
        for h in handles:
            h.remove()
    assert calls == []


def test_baseline_frozen_modules_stay_bit_identical_over_three_steps():
    """configs/cod.yml's optimizer (its encoder2 lr keys name the frozen
    tower and must not raise) over 3 train steps with drop-path on: the
    prompt modules take no update and no weight decay, the rest moves."""
    optim_cfg = load_config(os.path.join(ROOT, "configs", "cod.yml"))["optim_wrapper"]
    pm = PortBaseline(dtype=torch.float32, seed=0, **TINY)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = Optimizer(pm.named_parameters(), optim_cfg, max_epochs=2, steps_per_epoch=2,
                    frozen_prefixes=pm.frozen_param_prefixes)
    frozen = {n for n, _ in opt.frozen}
    assert frozen == {n for n in before if n.startswith(FROZEN)} and len(frozen) > 50
    for step in range(3):
        train_step(pm, opt, torch_batch(batch(10 + step)), step, seed=1)
    for n, p in pm.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), before[n]), n
        else:
            assert not torch.equal(p.detach(), before[n]), n


def test_optimizer_frozen_prefixes_and_custom_keys():
    """A frozen parameter that gets a gradient raises at the step; cod.yml's
    prompt-tower keys raise on a model without prompt modules (as the JAX
    zero-match guard does)."""
    optim_cfg = load_config(os.path.join(ROOT, "configs", "cod.yml"))["optim_wrapper"]
    pm = PortBaseline(dtype=torch.float32, seed=0, **TINY)
    opt = Optimizer(pm.named_parameters(), optim_cfg, 1, 1, frozen_prefixes=pm.frozen_param_prefixes)
    assert all(p.grad is None for _, p in opt.frozen)
    opt.frozen[0][1].grad = torch.zeros_like(opt.frozen[0][1])
    with pytest.raises(RuntimeError, match="frozen parameters received a gradient"):
        opt.step(0)
    pure = MODELS.get("cod")(dtype=torch.float32, seed=0, use_prompts=False, **TINY)
    with pytest.raises(ValueError, match="match no parameter"):
        Optimizer(pure.named_parameters(), optim_cfg, 1, 1)


def _smoke_overrides(work):
    return [f"work_dir={work}", "model.type=baseline", "train_dataloader.dataset.size=32",
            "val_dataloader.dataset.size=32", "train_dataloader.dataset.n=8", "train_dataloader.batch_size=4",
            "val_dataloader.dataset.n=4", "val_dataloader.batch_size=2"] + [
        f"model.{k}={list(v) if isinstance(v, tuple) else v}" for k, v in TINY.items()]


def test_baseline_trains_validates_and_restores_through_the_cli(tmp_path):
    """configs/synthetic_smoke.yml with model.type=baseline through the train
    CLI: the losses logged are the ones the model returns (no loss_ssim),
    the prompt modules in epoch_2.pth equal the seeded init, and a val pass
    restores the checkpoint through baseline_init's val_ckpt and writes no
    _diffusion.png."""
    recipe = os.path.join(ROOT, "configs", "synthetic_smoke.yml")
    work = tmp_path / "run"
    overrides = _smoke_overrides(work) + ["default_hooks.checkpoint={'type': 'CheckpointHook', 'interval': 2}"]
    argv = [recipe, "--device", "cpu", "--fp32"] + [a for o in overrides for a in ("-o", o)]
    summary = cli.main(argv)
    assert summary["steps"] == 4
    with open(work / "log.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r for r in records if "loss" in r]
    assert losses and all("loss_seg" in r and "loss_ssim" not in r for r in losses)
    assert any("COD/Smeasure" in r for r in records)
    saved = torch.load(work / "epoch_2.pth", weights_only=True)["state_dict"]
    init = PortBaseline(dtype=torch.float32, seed=0, **TINY).state_dict()
    prompt_keys = [k for k in init if k.startswith(FROZEN)]
    assert prompt_keys and all(torch.equal(saved[k], init[k]) for k in prompt_keys)
    assert not torch.equal(saved["hitnet.out_SAM.weight"], init["hitnet.out_SAM.weight"])

    hook = f"custom_hooks=[{{'type': 'baseline_init', 'val_ckpt': '{work / 'epoch_2.pth'}'}}]"
    val_argv = [recipe, "--device", "cpu", "--fp32", "-m", "val", "-o", hook, "-o", "save_visualizations=true"]
    val_argv += [a for o in _smoke_overrides(tmp_path / "val") for a in ("-o", o)]
    metrics = cli.main(val_argv)
    assert np.isfinite(metrics["COD/Smeasure"])
    vis = os.listdir(tmp_path / "val" / "visualizations")
    assert len(vis) == 4 * 4 and not any(f.endswith("_diffusion.png") for f in vis)
    with open(tmp_path / "val" / "log.jsonl") as f:
        assert any(json.loads(line).get("restored") == str(work / "epoch_2.pth") for line in f)


def test_baseline_init_grafts_towers_and_refuses_what_matches_nothing(tmp_path):
    r_logs = []
    model = PortBaseline(dtype=torch.float32, seed=0, **TINY)
    runner = type("R", (), {"model": model, "resumed": False, "log": staticmethod(r_logs.append)})()
    bb = {k: v + 1 for k, v in model.hitnet.backbone.state_dict().items() if not k.startswith("prompt_")}
    torch.save(bb, tmp_path / "pvt.pth")
    tower = model.hitnet.backbone.prompt_encoder.encoder2
    cx = {k: v - 1 for k, v in tower.state_dict().items()}
    torch.save(cx, tmp_path / "convnext.pth")
    baseline_init(backbone_ckpt=str(tmp_path / "pvt.pth"), convnext_ckpt=str(tmp_path / "convnext.pth")
                  ).before_train(runner)
    assert [r["loaded"] for r in r_logs] == [len(bb), len(cx)] and r_logs[0]["hook"] == "baseline_init"
    torch.testing.assert_close(model.hitnet.backbone.patch_embed1.proj.weight, bb["patch_embed1.proj.weight"])
    torch.testing.assert_close(tower.fusion_conv.weight, cx["fusion_conv.weight"])
    torch.save({"head.weight": torch.zeros(3)}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="baseline_init: 0 of 1"):
        baseline_init(backbone_ckpt=str(tmp_path / "other.pth")).before_train(runner)


def test_importing_the_serving_cli_alone_registers_every_model():
    """``python -m dgtd_tpu_torch.predict`` imports no model module by name;
    the models must be registered all the same (a fresh interpreter)."""
    code = ("import dgtd_tpu_torch.predict; from dgtd_tpu_torch.core.registry import MODELS; "
            "print(sorted(MODELS._store))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "['DQnet', 'baseline', 'cod']"


def test_predict_cli_serves_baseline_on_cpu(tmp_path):
    """``--model baseline`` with ``-o`` model args serves the model's own
    predictions; no stencil runs."""
    pm = PortBaseline(dtype=torch.float32, seed=3, **TINY)
    assert serve_and_check(str(tmp_path), pm, "baseline", TINY_ARGS)["batches"] == 2
