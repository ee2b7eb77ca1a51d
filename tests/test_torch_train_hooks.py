"""The port's ``ProfilerHook``, the preemption handler and the
``scripts/train.sh`` journey (CPU, fp32, tiny ``cod``; no JAX):
  * SIGTERM sent from a hook after step k saves ``preempt_step_k`` and ends
    the run through the same hooks; ``--resume`` of it reaches the
    uninterrupted run's weights exactly; the previous signal handlers are
    back when ``train()`` returns;
  * ``ProfilerHook`` writes a Chrome trace of its window, closes one that the
    preemption cuts (``truncated``) and logs a late start after a resume;
  * ``configs/sod.yml`` as ``scripts/train.sh`` runs it, through the train
    CLI on a SOD tree the test writes, with the recipe's ``num_workers: 8``
    in force: it trains, validates and writes ``log.jsonl``.
"""

import json
import os
import signal
import threading

import numpy as np
import torch
from PIL import Image

from dgtd_tpu_torch.core import config as PC
from dgtd_tpu_torch.train import cli
from dgtd_tpu_torch.train import loop as L
from dgtd_tpu_torch.train.hooks import Hook, ProfilerHook

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OVERRIDES = ["model.variant=tiny", "model.convnext_dims=[8,16,32,64]", "model.convnext_depths=[1,1,1,1]",
                  "model.channel=8", "model.latent_dim=8", "model.grid=8", "model.refine_iters=2"]


def _runner(work_dir):
    """synthetic_smoke at tiny width: 2 epochs of 3 steps at batch 2, 32²."""
    ovs = [f"work_dir={work_dir}", "train_cfg.val_interval=0", "train_cfg.max_epochs=2",
           "train_dataloader.batch_size=2", "train_dataloader.dataset.n=6", "train_dataloader.dataset.size=32",
           "default_hooks.checkpoint={'type': 'CheckpointHook', 'interval': 1}", *TINY_OVERRIDES]
    cfg = PC.load_config(os.path.join(ROOT, "configs", "synthetic_smoke.yml"), ovs)
    return L.Runner(cfg, work_dir=str(work_dir), seed=0, device=torch.device("cpu"), dtype=torch.float32)


def _log(work_dir):
    with open(os.path.join(work_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


class _SigtermAfter(Hook):
    """Sends this process SIGTERM after train step ``step``."""

    def __init__(self, step):
        self.step = step

    def after_train_iter(self, runner, metrics):
        if runner.host_step == self.step:
            assert threading.current_thread() is threading.main_thread()
            os.kill(os.getpid(), signal.SIGTERM)


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_sigterm_saves_preempt_checkpoint_and_resume_is_exact(tmp_path):
    previous = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))

    full = _runner(tmp_path / "a")
    full.hooks.append(ProfilerHook(start_step=1, num_steps=2))
    assert full.train()["steps"] == 6
    traced = [r for r in _log(tmp_path / "a") if "profile" in r]
    assert traced == [{"profile": str(tmp_path / "a" / "profile" / "trace_steps_1-3.json"), "step": 3}]
    assert any(e.get("name", "").startswith("aten::") for e in _trace_events(traced[0]["profile"]))

    cut = _runner(tmp_path / "b")
    cut.hooks += [_SigtermAfter(4), ProfilerHook(start_step=3, num_steps=5)]
    out = cut.train()
    ckpt = str(tmp_path / "b" / "preempt_step_4.pth")
    assert out["steps"] == 4 and out["preempted"] == ckpt and os.path.exists(ckpt)
    log_b = _log(tmp_path / "b")
    assert {"preempted": True, "checkpoint": ckpt} in log_b
    truncated = [r for r in log_b if "profile" in r]
    assert truncated == [{"profile": str(tmp_path / "b" / "profile" / "trace_steps_3-4.json"), "step": 4,
                          "truncated": True}]
    assert os.path.exists(truncated[0]["profile"])
    # the epoch that the signal cut saved no epoch checkpoint
    assert not os.path.exists(tmp_path / "b" / "epoch_2.pth")
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == previous

    resumed = _runner(tmp_path / "c")
    resumed.hooks.append(ProfilerHook(start_step=2, num_steps=1))
    resumed.resume(ckpt)
    assert resumed.train()["steps"] == 2
    log_c = _log(tmp_path / "c")
    assert log_c[0] == {"resumed_at_epoch": 1, "step": 4, "skip_batches": 1}
    assert {"profile_started_late": 5, "configured": 2} in log_c
    assert [r["loss"] for r in log_c if "loss" in r] == [r["loss"] for r in _log(tmp_path / "a") if "loss" in r][4:]
    a = torch.load(tmp_path / "a" / "epoch_2.pth", weights_only=True)
    c = torch.load(tmp_path / "c" / "epoch_2.pth", weights_only=True)
    assert a["meta"] == c["meta"]
    for k, v in a["state_dict"].items():
        torch.testing.assert_close(c["state_dict"][k], v, rtol=0, atol=0, msg=k)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == previous


def _write_sod_tree(root, n, size, seed):
    rng = np.random.RandomState(seed)
    for sub in ("RGB", "GT", "Depth"):
        os.makedirs(os.path.join(root, sub))
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        mask = ((xx - size / 2) ** 2 + (yy - size / 3 - i) ** 2) < (size / 4) ** 2
        img = np.clip(rng.rand(size, size, 3) * 120 + 80 * mask[..., None], 0, 255).astype(np.uint8)
        name = f"s{i}.png"
        Image.fromarray(img).save(os.path.join(root, "RGB", name))
        Image.fromarray((mask * 255).astype(np.uint8)).save(os.path.join(root, "GT", name))
        Image.fromarray((mask * 150 + rng.rand(size, size) * 60).astype(np.uint8)).save(os.path.join(root, "Depth", name))


def test_train_sh_journey_on_sod(tmp_path, monkeypatch):
    """``scripts/train.sh`` on the port: ``configs/sod.yml`` through the train
    CLI, on SOD_TRAIN and SOD_TEST trees, one epoch at batch 2 with the
    recipe's num_workers (8) on both loaders, then the val pass."""
    _write_sod_tree(str(tmp_path / "train"), 4, 40, 0)
    _write_sod_tree(str(tmp_path / "test"), 2, 40, 1)
    workers = []

    class Spy(L.DataLoader):
        def __init__(self, *a, **kw):
            workers.append(kw["num_workers"])
            super().__init__(*a, **kw)

    monkeypatch.setattr(L, "DataLoader", Spy)
    work = tmp_path / "sod_04"
    ovs = [f"work_dir={work}", "train_cfg.max_epochs=1", "train_cfg.val_interval=1", "train_dataloader.batch_size=2",
           f"train_dataloader.dataset.data_dir={tmp_path / 'train'}/", "train_dataloader.dataset.depth_dir=Depth",
           "train_dataloader.dataset.image_size=32", f"val_dataloader.dataset.data_dir={tmp_path / 'test'}/",
           "val_dataloader.dataset.depth_dir=Depth", "val_dataloader.dataset.image_size=32", *TINY_OVERRIDES]
    out = cli.main([os.path.join(ROOT, "configs", "sod.yml"), "--device", "cpu", "--fp32"]
                   + [a for o in ovs for a in ("-o", o)])
    assert out["steps"] == 2 and workers == [8, 8]
    records = _log(work)
    assert [r["step"] for r in records if "loss" in r] == [2]  # logger interval 5, the epoch's last step
    val = [r for r in records if "COD/Smeasure" in r]
    assert len(val) == 1 and all(np.isfinite(val[0][f"COD/{m}"]) for m in ("Emeasure", "Fmeasure", "Smeasure", "MAE"))
    assert os.path.exists(work / "epoch_1.pth")
