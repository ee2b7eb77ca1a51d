"""The port's val pass and folder datasets vs ``dgtd_tpu`` (CPU): the seven
folder datasets on a PNG tree the test writes, the three routes of
``Runner.val`` with a counted stand-in forward, a tiny-``cod`` val pass
through both Runners on the same weights, ``restore_checkpoint`` and
``our_init.val_ckpt``, training with validation through
``python -m dgtd_tpu_torch.train``, and the ``scripts/test.sh`` journey
through ``python -m dgtd_tpu_torch.test``.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from dgtd_tpu.data import datasets as JD
from dgtd_tpu.train.loop import Runner as JaxRunner
from dgtd_tpu_torch import test as port_test
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.core.config import load_config
from dgtd_tpu_torch.data import datasets as PD
from dgtd_tpu_torch.metrics import evaluators as PE
from dgtd_tpu_torch.train import cli
from dgtd_tpu_torch.train import loop as L
from dgtd_tpu_torch.train.hooks import Hook

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(variant="tiny", convnext_dims=[8, 16, 32, 64], convnext_depths=[1, 1, 1, 1],
            channel=8, latent_dim=8, grid=8, refine_iters=2)
TINY_OVERRIDES = ["model.variant=tiny", "model.convnext_dims=[8,16,32,64]", "model.convnext_depths=[1,1,1,1]",
                  "model.channel=8", "model.latent_dim=8", "model.grid=8"]
FOUR = ("Emeasure", "Fmeasure", "Smeasure", "MAE")
# a whole val pass, port vs JAX: the two compute the probability ~1e-7
# apart, which can move a pixel across a /255 bin edge; 1e-3 bounds what a
# few such pixels move a metric of 6 images
WHOLE_PASS_ATOL = 1e-3
ROUTE_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_metrics.py:221


def _argv(pairs):
    return [a for o in pairs for a in ("-o", o)]


# ---------------------------------------------------------------- folder datasets

#: (height, width) of the tree's images; item 2's GT is another size
SIZES = [(37, 23), (40, 52), (31, 31), (45, 29)]
MISMATCH = 2
SUBDIRS = ("Imgs", "Image", "RGB")


def _write_item(root, name, h, w, rng, gt_size=None):
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    gh, gw = gt_size or (h, w)
    gt = np.where(rng.rand(gh, gw) > 0.5, 255, 0).astype(np.uint8)
    dep = (rng.rand(h, w) * 255).astype(np.uint8)
    for sub in SUBDIRS:
        Image.fromarray(img).save(os.path.join(root, sub, name))
    Image.fromarray(gt).save(os.path.join(root, "GT", name))
    Image.fromarray(dep).save(os.path.join(root, "Depth", name))


def _make_tree(root, skip=0):
    """Images under Imgs/, Image/ and RGB/ (the seven classes' image dirs),
    GT/ and Depth/; the same tree again under train/ (NC4K). ``skip`` files
    of one tiny PNG (symlinks) sort ahead of the items (COD10K's partition)."""
    rng = np.random.RandomState(0)
    for base in (root, os.path.join(root, "train")):
        for sub in SUBDIRS + ("GT", "Depth"):
            os.makedirs(os.path.join(base, sub))
        for i, (h, w) in enumerate(SIZES):
            _write_item(base, f"item{i}.png", h, w, rng, gt_size=(h + 1, w) if i == MISMATCH else None)
        if skip:
            pad = os.path.join(root, "pad.png")
            if not os.path.exists(pad):
                Image.fromarray(np.zeros((4, 4), np.uint8)).save(pad)
            for sub in SUBDIRS + ("GT", "Depth"):
                for j in range(skip):
                    os.symlink(pad, os.path.join(base, sub, f"a{j:05d}.png"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    plain = str(tmp_path_factory.mktemp("tree"))
    _make_tree(plain)
    cod10k = str(tmp_path_factory.mktemp("cod10k"))
    _make_tree(cod10k, skip=PD.COD10K_TEST.skip_first)
    return {"plain": plain, "cod10k": cod10k}


FOLDER_NAMES = ["COD10K_CAMO_TRAIN", "COD10K_TEST", "COD_TEST", "CHAMELEON", "NC4K", "SOD_TRAIN", "SOD_TEST"]
CLASS_ATTRS = ("image_subdir", "gt_subdir", "size", "train_mode", "nested", "skip_first", "raw_as_path")


def _assert_items_equal(got, ref, label):
    assert sorted(got) == sorted(ref), label
    for k in ("input", "label", "depth", "raw"):
        if isinstance(ref[k], str):
            assert got[k] == ref[k], (label, k)
        else:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (label, k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{label} {k}")


@pytest.mark.parametrize("pipeline", ["pil", "native"])
@pytest.mark.parametrize("uint8_io", [False, True], ids=["float", "uint8_io"])
@pytest.mark.parametrize("name", FOLDER_NAMES)
def test_folder_dataset_matches_jax(trees, name, uint8_io, pipeline):
    port_cls, jax_cls = getattr(PD, name), getattr(JD, name)
    assert PD.DATASETS.get(name) is port_cls
    for attr in CLASS_ATTRS:
        assert getattr(port_cls, attr) == getattr(jax_cls, attr), attr
    root = trees["cod10k" if name == "COD10K_TEST" else "plain"]
    kw = dict(data_dir=root, depth_dir="Depth", split="train" if port_cls.train_mode else "val",
              image_size=None if uint8_io else 48, uint8_io=uint8_io, pipeline=pipeline)
    port, ref = port_cls(**kw), jax_cls(**kw)
    assert ref.pipeline == pipeline  # the JAX package did not fall back to PIL
    assert (port.images, port.gts, port.depths) == (ref.images, ref.gts, ref.depths)
    assert len(port) == len(SIZES) - 1 and not any(f"item{MISMATCH}" in p for p in port.images)
    assert port.size == ref.size
    for i in range(len(port)):
        for epoch in range(2):
            rng = lambda: np.random.default_rng((0, epoch, i)) if port_cls.train_mode else None
            _assert_items_equal(port.get(i, rng()), ref.get(i, rng()), f"{name} item {i} epoch {epoch}")
    if port_cls.train_mode:  # the flip stream flips some item of these draws
        flips = [np.random.default_rng((0, e, i)).random() < 0.5 for e in range(2) for i in range(len(port))]
        assert any(flips) and not all(flips)


def test_folder_dataset_refusals(trees, tmp_path):
    root = trees["plain"]
    with pytest.raises(ValueError, match="training split"):
        PD.SOD_TRAIN(root, "Depth", "val")
    with pytest.raises(ValueError, match="eval split"):
        PD.SOD_TEST(root, "Depth", "train")
    with pytest.raises(NotImplementedError, match="Unsupported split"):
        PD.SOD_TEST(root, "Depth", "holdout")
    with pytest.raises(ValueError, match="unknown pipeline"):
        PD.SOD_TEST(root, "Depth", "val", pipeline="opencv")
    # a depth directory that does not pair 1:1 raises, in both packages
    part = tmp_path / "partial"
    _make_tree(str(part))
    os.remove(part / "Depth" / "item0.png")
    with pytest.raises(ValueError, match="pair 1:1"):
        PD.SOD_TEST(str(part), "Depth", "val")
    with pytest.raises(ValueError, match="pair 1:1"):
        JD.SOD_TEST(str(part), "Depth", "val")
    # without the screen, the mismatched item stays
    assert len(PD.SOD_TEST(root, "Depth", "val", filter_size_mismatch=False)) == len(SIZES)


# ---------------------------------------------------------------- Runner.val routes


def _val_cfg(metrics, n=6, size=32, batch=4, **extra):
    return {
        "train_cfg": {"max_epochs": 1, "val_interval": 1},
        "model": {"type": "cod", **TINY},
        "val_dataloader": {"batch_size": batch, "sampler": {"shuffle": False},
                           "dataset": {"type": "SyntheticSODDataset", "n": n, "size": size, "seed": 1}},
        "val_evaluator": [{"type": m} for m in metrics],
        "optim_wrapper": {"optimizer": {"type": "AdamW", "lr": 5e-4, "weight_decay": 0.1}},
        **extra,
    }


@pytest.fixture
def counted(monkeypatch, tmp_path):
    """A val-mode Runner whose forward is a counted stand-in (the image's
    channel mean as the probability), with batch_statistics and the host
    copy of the map counted too."""
    calls = {"forward": 0, "stats": 0, "host": 0}
    stats_fn, host_fn = L.batch_statistics, L._host

    def stats(*a):
        calls["stats"] += 1
        return stats_fn(*a)

    def host(x):
        calls["host"] += 1
        return host_fn(x)

    monkeypatch.setattr(L, "batch_statistics", stats)
    monkeypatch.setattr(L, "_host", host)

    def make(metrics, **extra):
        r = L.Runner(_val_cfg(metrics, **extra), work_dir=str(tmp_path / f"w{len(os.listdir(tmp_path))}"),
                     device="cpu", dtype=torch.float32, mode="val")

        def forward(image, depth):
            calls["forward"] += 1
            image = image.float() / 255.0 if image.dtype == torch.uint8 else image
            return image.mean(dim=-1, keepdim=True).clamp(0, 1), {"texture": image.clamp(0, 1)}

        r._predict = forward
        for k in calls:
            calls[k] = 0
        return r

    return make, calls


def test_val_stats_only_route_forwards_once_and_copies_no_map(counted):
    make, calls = counted
    r = make(FOUR)
    out = r.val()
    assert calls == {"forward": 2, "stats": 2, "host": 0}
    assert all(np.isfinite(out[f"COD/{m}"]) for m in FOUR) and out["val_imgs_per_sec"] > 0


def test_val_mixed_route_forwards_once_and_equals_the_host_route(counted):
    make, calls = counted
    # host copies: the map and the label of each of the 2 batches
    mixed = make(("Smeasure", "MAE", "WeightedFmeasure")).val()
    assert calls == {"forward": 2, "stats": 2, "host": 4}
    host = make(("Smeasure", "MAE", "WeightedFmeasure"), device_metrics=False).val()
    assert calls == {"forward": 2, "stats": 0, "host": 4}
    for k in ("COD/Smeasure", "COD/MAE", "COD/WeightedFmeasure", "COD/Smeasure_strict"):
        np.testing.assert_allclose(mixed[k], host[k], **ROUTE_TOL, err_msg=k)


def test_val_visualizations_take_the_host_route(counted, tmp_path):
    make, calls = counted
    r = make(FOUR)
    r.val(save_visualizations=True)
    assert calls["forward"] == 2 and calls["stats"] == 0
    files = sorted(os.listdir(os.path.join(r.work_dir, "visualizations")))
    kinds = ("depth", "diffusion", "input", "label", "output")
    assert files == sorted(f"img{i}_{k}.png" for i in range(6) for k in kinds)
    with Image.open(os.path.join(r.work_dir, "visualizations", "img5_output.png")) as im:
        assert im.size == (32, 32) and im.mode == "L"


def test_val_record_and_hooks(counted):
    make, calls = counted
    r = make(FOUR)
    fired = []
    r.hooks.append(type("H", (Hook,), {"before_val": lambda self, runner: fired.append("before_val")})())
    r.epoch, r.host_step = 3, 12
    out = r.val()
    assert fired == ["before_val"]
    r.val(during_train=True)
    assert fired == ["before_val"]  # not during training
    records = [json.loads(line) for line in open(os.path.join(r.work_dir, "log.jsonl"))]
    assert records[0]["epoch"] == 3 and records[0]["step"] == 12
    assert records[0]["COD/Smeasure"] == round(out["COD/Smeasure"], 5)
    assert set(records[0]) == {"epoch", "step", "val_imgs_per_sec"} | {f"COD/{m}{s}" for m in FOUR for s in ("", "_strict")}


def test_val_uint8_labels_are_scaled_on_both_routes(counted):
    make, _ = counted
    a = make(FOUR)
    a.val_loader.dataset.uint8_io = True
    dev = a.val()
    b = make(FOUR, device_metrics=False)
    b.val_loader.dataset.uint8_io = True
    host = b.val()
    for m in FOUR:
        np.testing.assert_allclose(dev[f"COD/{m}"], host[f"COD/{m}"], **ROUTE_TOL, err_msg=m)


def test_val_logs_to_the_visualization_backends(counted):
    make, _ = counted
    r = make(FOUR, visualizer={"vis_backends": [{"type": "LocalVisBackend"}, {"type": "ClearMLVisBackend"}]})
    r.val()
    for b in r.vis_backends:
        rows = [json.loads(line) for line in open(os.path.join(b.save_dir, "scalars.jsonl"))]
        assert "COD/MAE" in rows[-1] and rows[-1]["step"] == 0
        b.add_image("probe", np.full((5, 7, 1), 0.5, np.float32), step=3)
        with Image.open(os.path.join(b.save_dir, "probe_3.png")) as im:
            assert im.size == (7, 5) and im.getpixel((0, 0)) == 127


# ---------------------------------------------------------------- whole pass vs JAX


@pytest.fixture(scope="module")
def both_runners(tmp_path_factory):
    """The JAX and the port Runner in val mode on one tiny-cod init: 6
    synthetic images at 64², batch 4, so the last batch is ragged."""
    tmp = tmp_path_factory.mktemp("val")
    cfg = _val_cfg(FOUR, n=6, size=64, batch=4, input_size=64)
    jr = JaxRunner(copy.deepcopy(cfg), work_dir=str(tmp / "jax"), dtype=jnp.float32, mode="val")
    variables = jax.device_get({"params": jr.state.params, "batch_stats": jr.state.batch_stats})
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables, sep="/").items()}
    pr = L.Runner(copy.deepcopy(cfg), work_dir=str(tmp / "port"), device="cpu", dtype=torch.float32, mode="val")
    result = pr.model.load_state_dict(state_dict_from_flax(flat), strict=False)
    assert not result.unexpected_keys and all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    return jr, pr, flat, tmp


def test_whole_val_pass_matches_jax(both_runners, capsys):
    jr, pr, _, _ = both_runners
    assert jr.train_loader is None and pr.train_loader is None
    ref, got = jr.val(), pr.val()
    assert sorted(got) == sorted(ref)
    keys = [k for k in ref if k != "val_imgs_per_sec"]
    diffs = {k: abs(got[k] - ref[k]) for k in keys}
    with capsys.disabled():
        print(f"\n  whole val pass, port vs JAX: largest |diff| {max(diffs.values()):.3e} "
              f"({max(diffs, key=diffs.get)})")
    for k in keys:
        assert diffs[k] <= WHOLE_PASS_ATOL, (k, got[k], ref[k])
    # the port's host route gives the device route's numbers on the same
    # batches (the synthetic set flips by the loader's epoch stream)
    pr.val_loader.epoch = 0
    pr.cfg["device_metrics"] = False
    try:
        host = pr.val()
    finally:
        pr.cfg.pop("device_metrics")
    for k in keys:
        np.testing.assert_allclose(host[k], got[k], **ROUTE_TOL, err_msg=k)


def test_restore_checkpoint_takes_npz_and_pth_and_refuses_what_does_not_pair(both_runners):
    _, pr, flat, tmp = both_runners
    want = {k: v.clone() for k, v in pr.model.state_dict().items()}
    with torch.no_grad():
        for p in pr.model.parameters():
            p.zero_()
    np.savez(tmp / "full.npz", **flat)
    pr.restore_checkpoint(str(tmp / "full.npz"))
    for k, v in pr.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    # a reference-style .pth with a dead module's keys beside the model's
    torch.save({"state_dict": {**want, "hitnet.ca.fc1.weight": torch.zeros(2)}}, tmp / "ref.pth")
    pr.restore_checkpoint(str(tmp / "ref.pth"))
    torch.save({"head.weight": torch.zeros(3)}, tmp / "other.pth")
    with pytest.raises(ValueError, match="no array"):
        pr.restore_checkpoint(str(tmp / "other.pth"))
    partial = {k: v for k, v in want.items() if "hitnet.backbone.block1" not in k}
    torch.save(partial, tmp / "partial.pth")
    with pytest.raises(ValueError, match="do not pair"):
        pr.restore_checkpoint(str(tmp / "partial.pth"))
    pr.restore_checkpoint(str(tmp / "full.npz"))


# ---------------------------------------------------------------- the CLIs


def _smoke_argv(work):
    ovs = [f"work_dir={work}", "train_cfg.max_epochs=2", "train_dataloader.batch_size=2",
           "train_dataloader.dataset.n=4", "train_dataloader.dataset.size=32", "val_dataloader.dataset.n=3",
           "val_dataloader.dataset.size=32", "val_dataloader.batch_size=2", *TINY_OVERRIDES,
           "default_hooks.checkpoint={'type': 'CheckpointHook', 'interval': 1}"]
    return [os.path.join(ROOT, "configs", "synthetic_smoke.yml"), "--device", "cpu", "--fp32"] + _argv(ovs)


def test_training_validates_and_val_ckpt_restores(tmp_path):
    """``python -m dgtd_tpu_torch.train`` on the smoke recipe writes the val
    record after epoch 2 (val_interval 2); ``-m val`` with our_init's
    val_ckpt on epoch_2.pth gives the same numbers, and a missing val_ckpt
    raises."""
    work = tmp_path / "run"
    out = subprocess.run([sys.executable, "-m", "dgtd_tpu_torch.train", *_smoke_argv(work)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    records = [json.loads(line) for line in open(work / "log.jsonl")]
    vals = [r for r in records if "COD/Smeasure" in r]
    assert len(vals) == 1 and vals[0]["epoch"] == 2 and vals[0]["step"] == 4
    assert all(np.isfinite(vals[0][f"COD/{m}"]) for m in FOUR)
    # the checkpoint is written before the val record
    assert records.index(vals[0]) == records.index({"checkpoint": str(work / "epoch_2.pth")}) + 1

    hook = f"custom_hooks=[{{'type': 'our_init', 'val_ckpt': '{work / 'epoch_2.pth'}'}}]"
    got = cli.main(_smoke_argv(tmp_path / "val") + ["-m", "val", "-o", hook])
    for m in FOUR:
        assert round(got[f"COD/{m}"], 5) == vals[0][f"COD/{m}"], m
    missing = f"custom_hooks=[{{'type': 'our_init', 'val_ckpt': '{tmp_path / 'nope.pth'}'}}]"
    with pytest.raises(FileNotFoundError, match="val_ckpt"):
        cli.main(_smoke_argv(tmp_path / "val2") + ["-m", "val", "-o", missing])


def test_validation_leaves_training_as_it_was(tmp_path):
    """A val pass after every epoch changes nothing of the training: the
    same losses, step count and final weights as without validation."""
    runs = {}
    for interval in (1, 0):
        work = tmp_path / f"v{interval}"
        cli.main(_smoke_argv(work) + ["-o", f"train_cfg.val_interval={interval}"])
        records = [json.loads(line) for line in open(work / "log.jsonl")]
        runs[interval] = ([r["loss"] for r in records if "loss" in r], sum("COD/MAE" in r for r in records),
                          torch.load(work / "epoch_2.pth", weights_only=True))
    assert runs[1][1] == 2 and runs[0][1] == 0
    assert runs[1][0] == runs[0][0]
    assert runs[1][2]["meta"] == runs[0][2]["meta"]
    for k, v in runs[0][2]["state_dict"].items():
        torch.testing.assert_close(runs[1][2]["state_dict"][k], v, rtol=0, atol=0, msg=k)


def _make_fixture(root, n=2, size=96):
    """tests/test_testsh_journey.py's SOD_TEST-layout tree."""
    rng = np.random.RandomState(0)
    for sub in ("RGB", "GT", "Depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        name = f"fix_{i}.png"
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        m = ((((xx - size // 2) ** 2 + (yy - size // 3 - 9 * i) ** 2) < (size // 5) ** 2)).astype(np.uint8) * 255
        d = (m * 0.7 + rng.rand(size, size) * 60).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "RGB", name))
        Image.fromarray(m).save(os.path.join(root, "GT", name))
        Image.fromarray(d).save(os.path.join(root, "Depth", name))


def test_testsh_journey_on_the_port(tmp_path, capsys):
    """``python -m dgtd_tpu_torch.test configs/sod.yml`` with
    tests/test_testsh_journey.py's overrides: one metrics line, five PNGs
    an image named from the files."""
    data = tmp_path / "njud"
    _make_fixture(str(data))
    work = tmp_path / "out"
    ovs = [f"work_dir={work}", "input_size=64", f"val_dataloader.dataset.data_dir={data}/",
           "val_dataloader.dataset.depth_dir=Depth", "val_dataloader.dataset.image_size=64",
           "val_dataloader.batch_size=2", *TINY_OVERRIDES, "model.refine_iters=1", "save_visualizations=true"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dgtd_tpu_torch.test", "configs/sod.yml", "--device", "cpu",
                           *_argv(ovs)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    with capsys.disabled():
        print(f"\n  python -m dgtd_tpu_torch.test journey: {seconds:.1f} s")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{") and "Smeasure" in line]
    assert len(lines) == 1, proc.stdout[-3000:]
    for key in ("COD/Emeasure", "COD/Fmeasure", "COD/Smeasure", "COD/MAE"):
        assert np.isfinite(lines[0][key]), lines[0]
    vis = work / "visualizations"
    assert sorted(os.listdir(vis)) == sorted(f"fix_{i}_{k}.png" for i in range(2)
                                             for k in ("input", "label", "output", "diffusion", "depth"))
    with Image.open(vis / "fix_0_output.png") as im:
        assert im.size == (64, 64)


def test_val_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recipe = os.path.join(ROOT, "configs", "sod.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test.main([recipe])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([recipe, "-m", "val"])


def test_val_only_runner_needs_no_train_data(tmp_path):
    cfg = load_config(os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
                      ["train_dataloader.dataset.type=COD10K_CAMO_TRAIN", *TINY_OVERRIDES])
    r = L.Runner(cfg, work_dir=str(tmp_path), device="cpu", dtype=torch.float32, mode="val")
    assert r.train_loader is None and len(r.val_loader) == 2
    assert [type(m) for m in r.metrics] == [PE.Emeasure, PE.Fmeasure, PE.Smeasure, PE.MAE]
    with pytest.raises(ValueError, match="no train loader"):
        r.train()
