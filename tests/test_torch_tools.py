"""The port's tools against ``dgtd_tpu``'s on the CPU, with no JAX compile:
``depth_gen --estimator sobel`` (gray and magma PNGs bit-equal) and its
refusals, ``eval_folder`` (both reductions), ``utils/vis_debug``,
``bench_table`` against the port's own ``Runner.val``,
``serving_check`` at a small grid, ``convert_ckpt`` round trips,
``metric_parity``'s folder loading and its refusal without the reference
(the runbook itself needs the reference checkout and is ``slow``), and a
fresh interpreter that imports every module of the slice and no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dgtd_tpu.tools import depth_gen as jax_depth_gen
from dgtd_tpu.tools import eval_folder as jax_eval_folder
from dgtd_tpu.tools.convert_ckpt import convert_state_dict
from dgtd_tpu.utils import vis_debug as jax_vis
from dgtd_tpu_torch.core.config import load_config
from dgtd_tpu_torch.models import dinov2 as port_dinov2
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.models.dpt import DPTHead
from dgtd_tpu_torch.tools import bench_table, convert_ckpt, depth_gen, eval_folder, metric_parity, serving_check
from dgtd_tpu_torch.tools.ref_oracle import reference_available
from dgtd_tpu_torch.train import loop as L
from dgtd_tpu_torch.utils import vis_debug

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=1)
TINY_OVERRIDES = ["model.variant=tiny", "model.convnext_dims=[8,16,32,64]", "model.convnext_depths=[1,1,1,1]",
                  "model.channel=8", "model.latent_dim=8", "model.grid=8", "model.refine_iters=1"]
TINY_ARCH = (32, 4, 2, "mlp")
EVAL_ATOL = 1e-6


def write_rgb(root, sizes, seed=0, names=None):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        name = names[i] if names else f"img{i}.png"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(os.path.join(root, name))


def read(path):
    with Image.open(path) as im:
        return np.asarray(im)


# ---------------------------------------------------------------- depth_gen


@pytest.mark.parametrize("long_side", [0, 40])
@pytest.mark.parametrize("render", ["gray", "magma"])
def test_depth_gen_sobel_is_bit_equal_to_the_jax_tool(tmp_path, render, long_side):
    write_rgb(tmp_path / "img", [(30, 44), (52, 36), (25, 25)], names=["b.png", "a.jpg", "c.png"])
    (tmp_path / "img" / "notes.txt").write_text("not an image")
    args = ["--image-dir", str(tmp_path / "img"), "--estimator", "sobel", "--render", render,
            "--long-side", str(long_side)]
    jax_depth_gen.main(args + ["--out-dir", str(tmp_path / "jax")])
    summary = depth_gen.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["a_depth.png", "b_depth.png", "c_depth.png"]
    assert summary["written"] == 3 and summary["images"] == 4
    for name in names:
        a, b = read(tmp_path / "jax" / name), read(tmp_path / "port" / name)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert a.ndim == (3 if render == "magma" else 2)
        np.testing.assert_array_equal(a, b)
    assert read(tmp_path / "port" / "a_depth.png").shape[:2] == (52, 36)


def test_depth_gen_needs_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_rgb(tmp_path / "img", [(20, 20)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        depth_gen.main(["--image-dir", str(tmp_path / "img"), "--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def tiny_depther_files(tmp_path_factory):
    """A tiny depther's two parts as official-key ``.pth`` files (the
    backbone as ``vits14``'s stand-in, with ``mask_token``)."""
    tmp = tmp_path_factory.mktemp("depther")
    torch.manual_seed(0)
    backbone = port_dinov2.DinoViT(*TINY_ARCH[:1], depth=TINY_ARCH[1], num_heads=TINY_ARCH[2]).state_dict()
    backbone["mask_token"] = torch.zeros(1, TINY_ARCH[0])
    head = DPTHead(TINY_ARCH[0], n_bins=16).state_dict()
    torch.save(backbone, tmp / "backbone.pth")
    torch.save({"state_dict": {f"decode_head.{k}": v for k, v in head.items()}}, tmp / "head.pth")
    return tmp


def test_depth_gen_dinov2_writes_maps(monkeypatch, tmp_path, tiny_depther_files):
    monkeypatch.setitem(port_dinov2.DINOV2_ARCHS, "vits14", TINY_ARCH)
    write_rgb(tmp_path / "img", [(30, 44), (52, 36)])
    summary = depth_gen.main(["--image-dir", str(tmp_path / "img"), "--out-dir", str(tmp_path / "out"),
                              "--estimator", "dinov2", "--arch", "vits14", "--long-side", "42", "--device", "cpu",
                              "--backbone-ckpt", str(tiny_depther_files / "backbone.pth"),
                              "--head-ckpt", str(tiny_depther_files / "head.pth")])
    assert summary["written"] == 2 and set(summary["parts_s"]) == {"decode", "backbone", "head", "write"}
    assert read(tmp_path / "out" / "img1_depth.png").shape == (52, 36)


@pytest.mark.parametrize("case", ["no_backbone", "missing_file", "wrong_arch", "head_for_backbone"])
def test_depth_gen_dinov2_raises_and_never_falls_back(monkeypatch, tmp_path, tiny_depther_files, case):
    monkeypatch.setitem(port_dinov2.DINOV2_ARCHS, "vits14", TINY_ARCH)
    write_rgb(tmp_path / "img", [(30, 44)])
    files = {"backbone": str(tiny_depther_files / "backbone.pth"), "head": str(tiny_depther_files / "head.pth")}
    arch = "vits14"
    if case == "missing_file":
        files["head"] = str(tmp_path / "absent.pth")
    elif case == "wrong_arch":
        arch = "vitb14"
    elif case == "head_for_backbone":
        files["backbone"] = files["head"]
    argv = ["--image-dir", str(tmp_path / "img"), "--out-dir", str(tmp_path / "out"), "--estimator", "dinov2",
            "--arch", arch, "--device", "cpu", "--head-ckpt", files["head"]]
    if case != "no_backbone":
        argv += ["--backbone-ckpt", files["backbone"]]
    with pytest.raises((FileNotFoundError, ValueError, RuntimeError)):
        depth_gen.main(argv)
    assert not (tmp_path / "out").exists() or not os.listdir(tmp_path / "out")


# ---------------------------------------------------------------- eval_folder


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """Prediction maps named as the val pass writes them (``_output``), some
    of another size than their GT; GTs of mixed sizes."""
    tmp = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(3)
    os.makedirs(tmp / "pred")
    os.makedirs(tmp / "gt")
    for i, (h, w) in enumerate([(40, 30), (33, 47), (50, 50), (21, 64), (36, 36)]):
        gt = np.zeros((h, w), np.uint8)
        gt[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 255
        ph, pw = (h, w) if i % 2 == 0 else (h + 7, w - 5)
        pred = np.clip(rng.rand(ph, pw) * 120 + (np.asarray(Image.fromarray(gt).resize((pw, ph))) > 0) * 120, 0, 255)
        Image.fromarray(gt).save(tmp / "gt" / f"im{i}.png")
        Image.fromarray(pred.astype(np.uint8)).save(tmp / "pred" / f"im{i}_output.png")
    return tmp


@pytest.mark.parametrize("metrics", [list(eval_folder.DEFAULT_METRICS), ["MAE", "Smeasure"]],
                         ids=["all", "two"])
def test_eval_folder_matches_the_jax_tool(eval_tree, metrics):
    ref, n_ref = jax_eval_folder.run_eval(str(eval_tree / "pred"), str(eval_tree / "gt"), metrics)
    got, n = eval_folder.run_eval(str(eval_tree / "pred"), str(eval_tree / "gt"), metrics)
    assert n == n_ref == 5 and sorted(got) == sorted(ref)
    assert any(k.endswith("_strict") for k in got) and any(not k.endswith("_strict") for k in got)
    for k in ref:
        assert abs(got[k] - ref[k]) <= EVAL_ATOL, (k, got[k], ref[k])


def test_eval_folder_pairing_and_cli(eval_tree, tmp_path, capsys):
    # sorted-order pairing: "im0_output" sorts as "im0" does here
    ref, _ = jax_eval_folder.run_eval(str(eval_tree / "pred"), str(eval_tree / "gt"), ["MAE"], strict_pairing=False)
    got = eval_folder.main(["--pred-dir", str(eval_tree / "pred"), "--gt-dir", str(eval_tree / "gt"),
                            "--metrics", "MAE", "--no-strict-pairing"])
    assert got == pytest.approx(ref, abs=EVAL_ATOL)
    assert '"n_images": 5' in capsys.readouterr().out.splitlines()[-1]
    os.makedirs(tmp_path / "gt")
    for i in range(5):
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "gt" / f"other{i}.png")
    with pytest.raises(SystemExit, match="no GT stem match"):
        eval_folder.run_eval(str(eval_tree / "pred"), str(tmp_path / "gt"))


# ---------------------------------------------------------------- vis_debug


def test_vis_debug_matches_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(4)
    x = rng.rand(2, 3, 9, 11).astype(np.float32)
    np.testing.assert_array_equal(vis_debug.activation_filter(x, 0.7), jax_vis.activation_filter(x, 0.7))
    fm = np.zeros((1, 1, 30, 40), np.float32)
    fm[0, 0, 3:9, 4:12] = 0.9  # 48 pixels
    fm[0, 0, 15:27, 20:31] = 0.8  # the largest blob
    fm[0, 0, 28, 2] = 0.55
    for thresh in (0.5, 0.85):
        np.testing.assert_array_equal(vis_debug.find_bbox(fm, thresh), jax_vis.find_bbox(fm, thresh))
    with pytest.raises(ValueError):
        vis_debug.find_bbox(fm, 0.95)
    fig, (a1, a2) = plt.subplots(1, 2)
    try:
        vis_debug.show_box([4, 3, 12, 9], a1)
        jax_vis.show_box([4, 3, 12, 9], a2)
        p1, p2 = a1.patches[0], a2.patches[0]
        assert (p1.get_xy(), p1.get_width(), p1.get_height()) == (p2.get_xy(), p2.get_width(), p2.get_height())
        mask = (rng.rand(1, 6, 7) > 0.5).astype(np.float32)
        for random_color in (False, True):
            np.random.seed(9)
            vis_debug.show_mask(mask, a1, random_color)
            np.random.seed(9)
            jax_vis.show_mask(mask, a2, random_color)
            np.testing.assert_array_equal(a1.images[-1].get_array(), a2.images[-1].get_array())
    finally:
        plt.close(fig)


# ---------------------------------------------------------------- bench_table


@pytest.fixture(scope="module")
def bench_trees(tmp_path_factory):
    """Two tiny COD_TEST / SOD_TEST trees (Imgs/, Image/, RGB/, GT/, Depth/)."""
    tmp = tmp_path_factory.mktemp("bench")
    rng = np.random.RandomState(5)
    for name, n in (("camo", 3), ("sod", 2)):
        for sub in ("Imgs", "Image", "RGB", "GT", "Depth"):
            os.makedirs(tmp / name / sub)
        for i in range(n):
            h, w = 40 + 3 * i, 50 - 4 * i
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            for sub in ("Imgs", "Image", "RGB"):
                Image.fromarray(img).save(tmp / name / sub / f"x{i}.png")
            Image.fromarray(np.where(rng.rand(h, w) > 0.5, 255, 0).astype(np.uint8)).save(tmp / name / "GT" / f"x{i}.png")
            Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(tmp / name / "Depth" / f"x{i}.png")
    return tmp


def test_bench_table_equals_the_runner_per_dataset(bench_trees, tmp_path, capsys):
    config = os.path.join(ROOT, "configs", "cod.yml")
    overrides = TINY_OVERRIDES + [f"work_dir={tmp_path / 'w'}"]
    ckpt = tmp_path / "w.pth"
    torch.save({"state_dict": cod(dtype=torch.float32, seed=7, **TINY).state_dict()}, ckpt)
    specs = [f"COD_TEST:{bench_trees / 'camo'}:Depth", f"SOD_TEST:{bench_trees / 'sod'}"]
    rows = bench_table.main(["--config", config, "--checkpoint", str(ckpt), "--depth-dir", "Depth",
                             "--image-size", "64", "--fp32", "--device", "cpu", "--batch-size", "2",
                             *[a for s in specs for a in ("--dataset", s)], *[a for o in overrides for a in ("-o", o)],
                             "--out", str(tmp_path / "table.md")])
    out = capsys.readouterr().out
    assert list(rows) == [f"COD_TEST:{bench_trees / 'camo'}", f"SOD_TEST:{bench_trees / 'sod'}"]
    assert '{"benchmark_table"' in out.splitlines()[-1]
    table = (tmp_path / "table.md").read_text().splitlines()
    assert table[0].startswith("| dataset | ") and len(table) == 4
    for (name, row), ds_type in zip(rows.items(), ("COD_TEST", "SOD_TEST")):
        cfg = load_config(config, overrides + [f"val_dataloader.dataset.type={ds_type}",
                                               f"val_dataloader.dataset.data_dir={name.split(':', 1)[1]}",
                                               "val_dataloader.dataset.depth_dir=Depth",
                                               "val_dataloader.dataset.image_size=64",
                                               "val_dataloader.batch_size=2", "val_dataloader.num_workers=0"])
        runner = L.Runner(cfg, work_dir=str(tmp_path / "r"), device="cpu", dtype=torch.float32, mode="val")
        runner.restore_checkpoint(str(ckpt))
        ref = runner.val()
        assert sorted(row) == sorted(ref)
        for k in ref:
            if k != "val_imgs_per_sec":
                assert row[k] == ref[k], (name, k)


# ---------------------------------------------------------------- serving_check


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_serving_check_diffusion_legs_agree_on_cpu(dtype):
    res = serving_check.check_diffusion(grid=20, c=3, kernel=7, steps=4, iters=2, device="cpu", dtype=dtype)
    assert res["ok"] and res["check"] == "diffusion_20sq_c3_k7_s4" and res["device"] == "cpu"
    assert set(res["max_abs_err"]) == {"nhwc_wrapper", "planes"}
    assert max(res["max_abs_err"].values()) <= res["tolerance"]["atol"]
    for k in ("plain_torch_ms", "nhwc_wrapper_ms", "planes_ms", "planes_vs_plain", "planes_vs_nhwc_wrapper"):
        assert isinstance(res[k], float) and res[k] > 0
    # the plain leg against diffusion_planes_plain on the same planes
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1, 9, 10, 2, generator=g).to(dtype)
    w = torch.rand(1, 9, 10, 2, 9, generator=g)
    w = (w / w.sum(-1, keepdim=True)).to(dtype)
    got = serving_check.diffusion_nhwc_plain(x, w, 3, 2)
    ref = serving_check.D.diffusion_planes_plain(x[0].permute(2, 0, 1).contiguous(),
                                                 w[0].permute(2, 3, 0, 1).contiguous(), 3, 2)
    torch.testing.assert_close(got[0].permute(2, 0, 1), ref, rtol=0, atol=serving_check.stencil_tolerance(dtype, 2)["atol"])


def test_serving_check_predict_and_cli_on_cpu(capsys):
    res = serving_check.check_predict(48, iters=2, device="cpu", model_args=TINY)
    assert res["ok"] and res["check"] == "predict_48sq_bs1" and res["ms_per_image"] > 0
    assert serving_check.main(["--skip-predict", "--grid", "16", "--device", "cpu"]) == 0
    assert '"diffusion_16sq_c24_k7_s4"' in capsys.readouterr().out


# ---------------------------------------------------------------- convert_ckpt


def _npz_of(state, kind, path, prefix=""):
    flat, skipped = convert_state_dict({k: v.numpy() for k, v in state.items()}, kind)
    np.savez(path, **{prefix + k: v for k, v in flat.items()})
    return skipped


@pytest.mark.parametrize("kind", ["full", "dinov2", "dpt_head"])
def test_convert_ckpt_round_trips(tmp_path, kind, capsys):
    """Port state dict -> the JAX converter's flat ``.npz`` -> the port's
    ``convert_ckpt`` -> the same state dict."""
    torch.manual_seed(2)
    if kind == "full":
        module = cod(dtype=torch.float32, seed=3, **TINY)
    elif kind == "dinov2":
        module = port_dinov2.DinoViT(*TINY_ARCH[:1], depth=TINY_ARCH[1], num_heads=TINY_ARCH[2])
    else:
        module = DPTHead(TINY_ARCH[0], channels=16, post_process_channels=(8, 16, 24, 32), n_bins=8)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    state = module.state_dict()
    skipped = _npz_of(state, kind, tmp_path / "in.npz", "decode_head/" if kind == "dpt_head" else "")
    assert all(k.endswith("num_batches_tracked") for k in skipped)
    assert convert_ckpt.main([kind, str(tmp_path / "in.npz"), str(tmp_path / "out.pth")]) == 0
    assert "converted" in capsys.readouterr().out
    got = torch.load(tmp_path / "out.pth", weights_only=True)
    want = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_convert_ckpt_refuses_unknown_kinds_and_leaves(tmp_path):
    assert convert_ckpt.main(["pvt", "a.npz", "b.pth"]) == 1
    np.savez(tmp_path / "x.npz", **{"blocks_0/unknown/kernel": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="no port key"):
        convert_ckpt.main(["dinov2", str(tmp_path / "x.npz"), str(tmp_path / "x.pth")])


# ---------------------------------------------------------------- no JAX


def test_the_slice_imports_no_jax():
    mods = ["dgtd_tpu_torch.models.dinov2", "dgtd_tpu_torch.models.dpt", "dgtd_tpu_torch.convert",
            "dgtd_tpu_torch.tools.depth_gen", "dgtd_tpu_torch.tools.convert_ckpt",
            "dgtd_tpu_torch.tools.eval_folder", "dgtd_tpu_torch.tools.bench_table",
            "dgtd_tpu_torch.tools.serving_check", "dgtd_tpu_torch.utils.vis_debug",
            "dgtd_tpu_torch.tools.export_serving", "dgtd_tpu_torch.tools.metric_parity",
            "dgtd_tpu_torch.tools.ref_oracle", "dgtd_tpu_torch.core.flags"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import dgtd_tpu_torch.tools.eval_folder as E, dgtd_tpu_torch.tools.bench_table as B\n"
            "from dgtd_tpu_torch.metrics import evaluators\n"
            "from dgtd_tpu_torch.train import loop\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dgtd_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _parity_tree(root, n=3, sizes=((64, 64), (50, 70), (48, 40))):
    """An RGB-D folder as tests/test_metric_parity.py writes it: JPEG images,
    blob masks, depth maps with their own names."""
    rng = np.random.RandomState(0)
    for sub in ("Imgs", "GT", "Depth"):
        os.makedirs(root / sub)
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx, r = rng.randint(16, h - 16), rng.randint(16, w - 16), rng.randint(8, 16)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "Imgs" / f"x{i}.jpg")
        Image.fromarray(((((yy - cy) ** 2 + (xx - cx) ** 2) < r * r) * 255).astype(np.uint8)).save(
            root / "GT" / f"x{i}.png")
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(root / "Depth" / f"x{i}_depth.png")


@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "no_depth"])
def test_metric_parity_load_folder_matches_the_jax_tool(tmp_path, with_depth):
    from dgtd_tpu.tools import metric_parity as jax_parity

    _parity_tree(tmp_path)
    args = (str(tmp_path / "Imgs"), str(tmp_path / "GT"), str(tmp_path / "Depth") if with_depth else None, 56)
    ours, ref = list(metric_parity.load_folder(*args)), list(jax_parity.load_folder(*args))
    assert len(ours) == len(ref) == 3
    for got, want in zip(ours, ref):
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_metric_parity_needs_the_reference(tmp_path, monkeypatch):
    """Without the reference checkout the tool raises FileNotFoundError
    naming the path it looked for; a JAX .npz is refused."""
    _parity_tree(tmp_path, n=1)
    missing = tmp_path / "no_reference"
    monkeypatch.setenv("DGTD_REFERENCE_ROOT", str(missing))
    with pytest.raises(FileNotFoundError, match="no_reference"):
        metric_parity.run_parity(str(tmp_path / "Imgs"), str(tmp_path / "GT"), None, None, state_dict={},
                                 device="cpu")
    with pytest.raises(SystemExit, match="reference .pth"):
        metric_parity.load_state_dict(str(tmp_path / "w.npz"))


@pytest.mark.slow
@pytest.mark.skipif(not reference_available(), reason="reference checkout not present")
def test_metric_parity_runbook_synthetic(tmp_path):
    """The reference model and the port on one random state dict, through
    predict and the metrics (tests/test_metric_parity.py's bars)."""
    from dgtd_tpu_torch.tools.ref_oracle import cpu_cuda_calls, load_reference_cod

    _parity_tree(tmp_path, n=5, sizes=((64, 64),))
    torch.manual_seed(0)
    with cpu_cuda_calls():
        state_dict = load_reference_cod().cod().state_dict()
    result = metric_parity.run_parity(str(tmp_path / "Imgs"), str(tmp_path / "GT"), str(tmp_path / "Depth"),
                                      checkpoint=None, size=384, state_dict=state_dict, device="cpu")
    assert result["n_images"] == 5
    assert result["pred_max_abs_delta"] < 5e-3, result
    for k, d in result["delta"].items():
        assert d < 2e-3, (k, d, result["reference"][k], result["ours"][k])
    assert 0.0 < result["ours"]["COD/MAE"] < 1.0
