"""The port's recipe loader, data loader, optimizer, hooks and train CLI vs
``dgtd_tpu`` (CPU), and the CPU journey of ``python -m dgtd_tpu_torch.train``
with an exact mid-epoch resume.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from dgtd_tpu.core import config as JC
from dgtd_tpu.data.datasets import SyntheticSODDataset as JaxSynthetic
from dgtd_tpu.data.loader import DataLoader as JaxLoader
from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.train.optim import build_lr_mults, cosine_epoch_schedule
from dgtd_tpu_torch import predict as port_predict
from dgtd_tpu_torch.convert import map_flax_key
from dgtd_tpu_torch.core import config as PC
from dgtd_tpu_torch.data.datasets import SyntheticSODDataset
from dgtd_tpu_torch.data.loader import DataLoader
from dgtd_tpu_torch.models.cod import cod as PortCod
from dgtd_tpu_torch.train import cli
from dgtd_tpu_torch.train.hooks import Hook, our_init
from dgtd_tpu_torch.train.loop import Runner
from dgtd_tpu_torch.train.optim import Optimizer, cosine_epoch_lr, lr_mult
from dgtd_tpu_torch.train.state import step_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2)
OVERRIDES = ["work_dir=/tmp/x", "train_cfg.max_epochs=3", "custom_hooks.0.backbone_ckpt=a.npz",
             "model.convnext_depths=[1,1,1,1]", "sizes.384.bs=8", "custom_hooks.1.type=Extra",
             "train_dataloader.dataset={'type': 'SyntheticSODDataset', 'n': 4}", "optim_wrapper.clip_grad.max_norm=1.0"]


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("recipe", ["cod", "sod", "synthetic_smoke"])
def test_load_config_matches_jax(recipe):
    path = os.path.join(ROOT, "configs", f"{recipe}.yml")
    assert PC.load_config(path) == JC.load_config(path)
    assert PC.load_config(path, OVERRIDES) == JC.load_config(path, OVERRIDES)


def test_base_include_anchors_and_dotted_access_match_jax(tmp_path):
    (tmp_path / "child.yml").write_text(
        f"_base_: {os.path.join(ROOT, 'configs', 'cod.yml')}\n"
        "train_cfg: {max_epochs: 7}\nsizes: {384: {bs: 4}}\nlist: [1, 2]\n")
    ovs = ["sizes.384.bs=16", "list.2=3", "train_dataloader.batch_size=2"]
    got, ref = PC.load_config(str(tmp_path / "child.yml"), ovs), JC.load_config(str(tmp_path / "child.yml"), ovs)
    assert got == ref
    assert got["train_cfg"] == {"by_epoch": True, "max_epochs": 7, "val_interval": 100}
    assert got["param_scheduler"]["T_max"] == 100  # the recipe's YAML anchor
    for key in ("sizes.384.bs", "list.2", "custom_hooks.0.type", "model.nothing", "list.9"):
        assert PC.get_dotted(got, key, "d") == JC.get_dotted(ref, key, "d")
    for bad in ("list.4=1", "list.x=1", "custom_hooks.12.type=a"):
        with pytest.raises((ValueError, KeyError)) as pe:
            PC.load_config(str(tmp_path / "child.yml"), [bad])
        with pytest.raises(pe.type):
            JC.load_config(str(tmp_path / "child.yml"), [bad])


# ---------------------------------------------------------------- data


def test_loader_order_and_flips_match_jax():
    jl = JaxLoader(JaxSynthetic(n=7, size=16, seed=3), batch_size=3, shuffle=True, seed=5,
                   drop_last=True, device_put=False)
    pl = DataLoader(SyntheticSODDataset(n=7, size=16, seed=3), batch_size=3, shuffle=True, seed=5,
                    drop_last=True, device="cpu")
    assert len(pl) == len(jl) == 2
    for epoch in range(3):
        ref, got = list(jl), list(pl)
        assert len(got) == len(ref) == 2
        for b_ref, b_got in zip(ref, got):
            for k in ("input", "label", "depth"):
                assert b_got[k].dtype == torch.float32
                np.testing.assert_array_equal(b_got[k].numpy(), b_ref[k], err_msg=f"epoch {epoch} {k}")
            assert isinstance(b_got["raw"], list)
            np.testing.assert_array_equal(np.stack(b_got["raw"]), np.stack(b_ref["raw"]))
    # a resumed loader re-enters the stream at its epoch
    pl2 = DataLoader(SyntheticSODDataset(n=7, size=16, seed=3), 3, shuffle=True, seed=5, drop_last=True)
    pl2.epoch = 2
    np.testing.assert_array_equal(next(iter(pl2))["input"], got[0]["input"].numpy())


# ---------------------------------------------------------------- optimizer


def test_lr_mults_match_jax_through_the_key_table():
    jm = JaxCod(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(0), (1, 32, 32, 3))["params"]
    ref = {k: float(v) for k, v in flatten_dict(build_lr_mults(params), sep="/").items()}
    keys = PC.load_config(os.path.join(ROOT, "configs", "cod.yml"))["optim_wrapper"]["paramwise_cfg"]["custom_keys"]
    custom = {k: v["lr_mult"] for k, v in keys.items()}
    pm = PortCod(dtype=torch.float32, seed=None, **TINY)
    opt = Optimizer(pm.named_parameters(), {"paramwise_cfg": {"custom_keys": keys}}, 2, 2)
    group_of = {id(p): g["lr_mult"] for g in opt.opt.param_groups for p in g["params"]}
    names = dict(pm.named_parameters())
    for path, mult in ref.items():
        name = map_flax_key(path)[0]
        assert lr_mult(name, custom) == mult, name
        assert group_of[id(names[name])] == mult, name
    assert sorted({g["lr_mult"] for g in opt.opt.param_groups}) == [0.02, 0.2, 1.0]


def test_optimizer_refuses_unmatched_keys_and_bad_clip():
    pm = PortCod(dtype=torch.float32, seed=None, **TINY)
    with pytest.raises(ValueError, match="match no parameter"):
        Optimizer(pm.named_parameters(), {"paramwise_cfg": {"custom_keys": {"hitnet.backbone.nope": {"lr_mult": 0.1}}}}, 1, 1)
    with pytest.raises(ValueError, match="clip_value or max_norm"):
        Optimizer(pm.named_parameters(), {"clip_grad": {"type": "norm"}}, 1, 1)


@pytest.mark.parametrize("clip", [{"clip_value": 0.01}, {"max_norm": 0.5}])
def test_optimizer_clips_then_steps(clip):
    lin = torch.nn.Linear(4, 3)
    named = [("hitnet." + n, p) for n, p in lin.named_parameters()]
    opt = Optimizer(named, {"optimizer": {"lr": 0.1, "weight_decay": 0.0}, "clip_grad": clip}, 1, 1)
    (lin(torch.ones(2, 4)) * 100).sum().backward()
    grads = [p.grad.clone() for p in lin.parameters()]
    want = [g.clamp(-0.01, 0.01) for g in grads] if "clip_value" in clip else None
    if want is None:
        norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
        want = [g * 0.5 / (norm + 1e-6) for g in grads]
    before = [p.detach().clone() for p in lin.parameters()]
    ref = torch.optim.AdamW([torch.nn.Parameter(b.clone()) for b in before], lr=0.1, weight_decay=0.0)
    for p, g in zip(ref.param_groups[0]["params"], want):
        p.grad = g
    ref.step()
    opt.step(0)
    for p, r in zip(lin.parameters(), ref.param_groups[0]["params"]):
        torch.testing.assert_close(p.detach(), r.detach())
        assert p.grad is None


def test_cosine_schedule_matches_jax():
    sched = cosine_epoch_schedule(5e-4, 4, 3)
    for step in range(16):
        np.testing.assert_allclose(cosine_epoch_lr(step, 5e-4, 4, 3), float(sched(step)), rtol=1e-6, atol=1e-12)


def test_step_generator_is_keyed_by_seed_and_step_only():
    draw = lambda s, t: torch.rand(4, generator=step_generator(s, t, torch.device("cpu")))
    assert torch.equal(draw(1, 5), draw(1, 5))
    assert not torch.equal(draw(1, 5), draw(1, 6)) and not torch.equal(draw(1, 5), draw(2, 5))


# ---------------------------------------------------------------- hooks


def _fake_runner(resumed=False):
    logs = []
    return SimpleNamespace(model=PortCod(dtype=torch.float32, seed=0, **TINY), resumed=resumed,
                           log=logs.append, logs=logs)


def test_our_init_loads_pth_and_npz_and_refuses_what_matches_nothing(tmp_path):
    r = _fake_runner()
    before = {k: v.clone() for k, v in r.model.state_dict().items()}
    our_init().before_train(r)  # the recipe names no file: nothing happens
    assert all(torch.equal(before[k], v) for k, v in r.model.state_dict().items()) and not r.logs

    # an official-style PVT .pth (keys relative to the backbone)
    bb = {k: v + 1 for k, v in r.model.hitnet.backbone.state_dict().items() if not k.startswith("prompt_")}
    torch.save(bb, tmp_path / "pvt.pth")
    our_init(backbone_ckpt=str(tmp_path / "pvt.pth")).before_train(r)
    assert r.logs[-1]["loaded"] == len(bb)
    torch.testing.assert_close(r.model.hitnet.backbone.patch_embed1.proj.weight, bb["patch_embed1.proj.weight"])

    # a JAX-converted ConvNeXt .npz (keys relative to the JAX tower)
    jm = JaxCod(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(3), (1, 32, 32, 3))["params"]
    tower = {k: np.asarray(v) for k, v in flatten_dict(params["hitnet"]["prompt_encoder"]["encoder2"], sep="/").items()}
    np.savez(tmp_path / "convnext.npz", **tower)
    our_init(convnext_ckpt=str(tmp_path / "convnext.npz")).before_train(r)
    assert r.logs[-1]["loaded"] == len(tower)
    np.testing.assert_array_equal(r.model.hitnet.backbone.prompt_encoder.encoder2.stages[0][0].gamma.detach().numpy(),
                                  tower["stage0_block0/gamma"])

    torch.save({"head.weight": torch.zeros(3)}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="0 of 1"):
        our_init(backbone_ckpt=str(tmp_path / "other.pth")).before_train(r)
    with pytest.raises(FileNotFoundError):
        our_init(backbone_ckpt=str(tmp_path / "missing.pth")).before_train(r)
    resumed = _fake_runner(resumed=True)
    our_init(backbone_ckpt=str(tmp_path / "missing.pth")).before_train(resumed)
    assert resumed.logs == [{"hook": "our_init", "skip_pretrains": "resumed"}]


# ---------------------------------------------------------------- the CLI


def _argv(work_dir, extra=()):
    ovs = [f"work_dir={work_dir}", "train_cfg.val_interval=0", "train_cfg.max_epochs=2",
           "train_dataloader.batch_size=2", "train_dataloader.dataset.n=6", "train_dataloader.dataset.size=32",
           "default_hooks.checkpoint={'type': 'CheckpointHook', 'interval': 1}",
           "model.variant=tiny", "model.convnext_dims=[8,16,32,64]", "model.convnext_depths=[1,1,1,1]",
           "model.channel=8", "model.latent_dim=8", "model.grid=8", "model.refine_iters=2", *extra]
    return [os.path.join(ROOT, "configs", "synthetic_smoke.yml"), "--device", "cpu", "--fp32"] + [
        a for o in ovs for a in ("-o", o)]


class _Stop(Exception):
    pass


class _StopAt(Hook):
    """Save a checkpoint after train step ``step`` and end the run there."""

    def __init__(self, step):
        self.step = step

    def after_train_iter(self, runner, metrics):
        if runner.host_step == self.step:
            runner.save_checkpoint(f"iter_{self.step}")
            raise _Stop


def test_train_cli_journey_and_exact_mid_epoch_resume(tmp_path):
    full = cli.main(_argv(tmp_path / "a"))
    assert full["steps"] == 6
    records = [json.loads(line) for line in open(tmp_path / "a" / "log.jsonl")]
    losses = [r for r in records if "loss" in r]
    assert [r["step"] for r in losses] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in losses)
    for e in (1, 2):
        ckpt = torch.load(tmp_path / "a" / f"epoch_{e}.pth", weights_only=True)
        assert ckpt["meta"] == {"epoch": e, "iter": 3 * e} and "optimizer" in ckpt

    # stop inside epoch 2, after step 4, then resume through the CLI
    args = cli.parse_args(_argv(tmp_path / "b"))
    cfg = PC.load_config(args.config, args.override)
    runner = Runner(cfg, work_dir=str(tmp_path / "b"), seed=0, device=torch.device("cpu"), dtype=torch.float32)
    runner.hooks.append(_StopAt(4))
    with pytest.raises(_Stop):
        runner.train()
    resumed = cli.main(_argv(tmp_path / "c") + ["--resume", str(tmp_path / "b" / "iter_4.pth")])
    assert resumed["steps"] == 2
    log_c = [json.loads(line) for line in open(tmp_path / "c" / "log.jsonl")]
    assert log_c[0] == {"resumed_at_epoch": 1, "step": 4, "skip_batches": 1}
    assert [r["loss"] for r in log_c if "loss" in r] == [r["loss"] for r in losses[4:]]
    a = torch.load(tmp_path / "a" / "epoch_2.pth", weights_only=True)
    c = torch.load(tmp_path / "c" / "epoch_2.pth", weights_only=True)
    assert a["meta"] == c["meta"]
    for k, v in a["state_dict"].items():
        torch.testing.assert_close(c["state_dict"][k], v, rtol=0, atol=0, msg=k)
    for pid, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(c["optimizer"]["state"][pid][k], v, rtol=0, atol=0)

    # the trained checkpoint serves through the predict CLI
    from PIL import Image

    (tmp_path / "img").mkdir()
    Image.fromarray(np.full((32, 32, 3), 90, np.uint8)).save(tmp_path / "img" / "a.png")
    port_predict.main(["--checkpoint", str(tmp_path / "a" / "epoch_2.pth"), "--image-dir", str(tmp_path / "img"),
                       "--out-dir", str(tmp_path / "out"), "--size", "32", "--batch", "1", "--fp32",
                       "--device", "cpu", "-o", "variant=tiny", "-o", "convnext_dims=[8,16,32,64]",
                       "-o", "convnext_depths=[1,1,1,1]", "-o", "channel=8", "-o", "latent_dim=8",
                       "-o", "grid=8", "-o", "refine_iters=2"])
    assert os.listdir(tmp_path / "out") == ["a_output.png"]


def test_train_cli_refuses_val_and_needs_a_card(monkeypatch, tmp_path):
    """``-m val`` and a recipe that validates inside max_epochs both reach
    the Runner (the val pass exists now); without a card the CLI raises."""
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    built = []

    class Stub:
        def __init__(self, cfg, mode, **kw):
            built.append((mode, cfg["train_cfg"]["val_interval"], cfg["train_cfg"]["max_epochs"]))

        def val(self, save_visualizations=False):
            return {"COD/MAE": 0.5, "visualizations": save_visualizations}

        def train(self):
            return {"steps": 0, "loop_s": 0.0}

    with monkeypatch.context() as m:
        m.setattr(cli, "Runner", Stub)
        assert cli.main([recipe, "-m", "val", "--device", "cpu", "-o", "save_visualizations=true"]) == {
            "COD/MAE": 0.5, "visualizations": True}
        assert cli.main([recipe, "--device", "cpu", "-o", f"work_dir={tmp_path}"])["steps"] == 0
    assert built == [("val", 100, 100), ("train", 100, 100)]
    # the real Runner gets as far as the recipe's val folder, which is not here
    with pytest.raises(FileNotFoundError, match="cod10k_test"):
        cli.main([recipe, "-m", "val", "--device", "cpu", "-o", f"work_dir={tmp_path}"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([recipe])


def test_python_m_entry_point_runs(tmp_path):
    """``python -m dgtd_tpu_torch.train`` is the CLI (one epoch, 3 steps)."""
    argv = _argv(tmp_path / "m", ["train_cfg.max_epochs=1"])
    out = subprocess.run([sys.executable, "-m", "dgtd_tpu_torch.train", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.path.exists(tmp_path / "m" / "epoch_1.pth")
