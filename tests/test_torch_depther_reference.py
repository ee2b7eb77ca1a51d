"""The port's offline depther against the benchmark's plain reference
(``benchmark/reference/depther.py``: float32 PyTorch, no port module, no
JAX) on the CPU, on the reference's seeded weights at tiny widths:

  * ``DinoDPTDepther`` on a square input and on 389×518, padded to a 28×37
    patch grid (the bicubic position resize, the 14×19 → 28×38 and
    28×37 → 28×38 skip resizes), within 1e-5 of each map's range;
  * ``Dinov2Depther.batch`` against its per-image calls, and its refusal of
    a float image;
  * ``depth_gen --batch 3`` against ``--batch 1`` on one folder: the same
    files, shapes and grey levels, the images of one resized shape batched;
  * at the published widths on the meta device: the seeded state's keys and
    shapes are the port's, and the configuration's parameter and FLOP
    counts are the reference's;
  * the fp8 control moves the map far beyond the port's gap.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from benchmark.reference import depther as reference
from benchmark.reference.numerics import Numerics
from dgtd_tpu_torch.models import dinov2 as port_dinov2
from dgtd_tpu_torch.models.dpt import DinoDPTDepther, DPTHead
from dgtd_tpu_torch.tools import depth_gen
from dgtd_tpu_torch.tools.depth_gen import Dinov2Depther

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "depther-vitl14-518.json"
TINY = {"embed_dim": 32, "depth": 6, "num_heads": 2, "mlp_hidden": 128, "patch": 14, "pretrain_grid": 3,
        "pos_offset": 0.1, "layer_norm_eps": 1e-6, "out_indices": [1, 2, 4, 5],
        "post_process_channels": [8, 16, 32, 64], "channels": 16, "n_bins": 16, "min_depth": 0.001,
        "max_depth": 10.0}
#: float32 on both sides: the two differ in the order of their sums only
#: (measured: 1.2e-6 of the range at 389×518)
REL_TOL = 1e-5


def port_model(arch, state):
    """The port's depther of ``arch`` (a reference architecture block),
    registered for the build as ``tiny``, holding ``state``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_dinov2.DINOV2_ARCHS, "tiny", (arch["embed_dim"], arch["depth"], arch["num_heads"], "mlp"))
        model = DinoDPTDepther(arch="tiny", out_indices=arch["out_indices"], n_bins=arch["n_bins"],
                               channels=arch["channels"], post_process_channels=arch["post_process_channels"],
                               pretrain_grid=arch["pretrain_grid"])
    model.load_state_dict(state, strict=True)
    return model.eval()


def images(b, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)


def gap(got, ref):
    """The largest |d − d_ref| over each map's reference range."""
    span = (ref.amax(dim=(1, 2)) - ref.amin(dim=(1, 2)))[:, None, None]
    return float(((got - ref).abs() / span).max())


@pytest.fixture(scope="module")
def tiny():
    state = reference.make_state(TINY, 2 ** 31 + 3, "cpu")
    return state, Dinov2Depther(port_model(TINY, state), torch.device("cpu"))


@pytest.mark.parametrize("hw", [(56, 56), (389, 518)], ids=["square", "odd_grid"])
def test_port_matches_reference(tiny, hw):
    state, depther = tiny
    x = images(2, *hw, seed=hw[0])
    got = depther.batch(x)
    ref = reference.forward(TINY, state, x)
    assert got.shape == ref.shape == (2, *hw) and got.dtype == torch.float32
    assert float(ref.std()) > 0.05
    assert gap(got, ref) <= REL_TOL


def test_fp8_control_moves_the_map(tiny):
    state, _ = tiny
    x = images(2, 56, 56, seed=5)
    ref = reference.forward(TINY, state, x)
    assert gap(reference.forward(TINY, state, x, Numerics("fp8")), ref) > 100 * REL_TOL


def test_batched_call_matches_per_image_calls(tiny):
    _, depther = tiny
    x = images(3, 40, 54, seed=9)
    batched = depther.batch(x)
    single = torch.stack([torch.from_numpy(depther(x[i].numpy())) for i in range(3)])
    assert gap(batched, single) <= REL_TOL


def test_batch_refuses_a_float_image(tiny):
    _, depther = tiny
    with pytest.raises(ValueError, match="uint8"):
        depther.batch(images(1, 28, 28).float() / 255.0)


def test_depth_gen_batch_matches_batch_one(tmp_path, monkeypatch):
    # the release's two files of a tiny backbone (as ``vits14``) and a head of 16 bins
    monkeypatch.setitem(port_dinov2.DINOV2_ARCHS, "vits14", (32, 4, 2, "mlp"))
    torch.manual_seed(1)
    backbone = port_dinov2.DinoViT(32, depth=4, num_heads=2).state_dict()
    torch.save({**backbone, "mask_token": torch.zeros(1, 32)}, tmp_path / "backbone.pth")
    head = DPTHead(32, n_bins=16).state_dict()
    torch.save({"state_dict": {f"decode_head.{k}": v for k, v in head.items()}}, tmp_path / "head.pth")
    rng = np.random.RandomState(4)
    os.makedirs(tmp_path / "img")
    # at --long-side 42: 29×42, 29×42, 42×29, 29×42, 29×42
    for i, (h, w) in enumerate([(30, 44), (33, 48), (52, 36), (30, 44), (33, 48)]):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(tmp_path / "img" / f"im{i}.png")
    sizes = []
    real = Dinov2Depther.batch

    def counted(self, x):
        sizes.append(x.shape[0])
        return real(self, x)

    monkeypatch.setattr(Dinov2Depther, "batch", counted)
    argv = ["--image-dir", str(tmp_path / "img"), "--estimator", "dinov2", "--arch", "vits14", "--long-side", "42",
            "--device", "cpu", "--fp32", "--backbone-ckpt", str(tmp_path / "backbone.pth"),
            "--head-ckpt", str(tmp_path / "head.pth")]
    out = {}
    for n in (1, 3):
        sizes.clear()
        summary = depth_gen.main(argv + ["--out-dir", str(tmp_path / f"b{n}"), "--batch", str(n)])
        assert summary["written"] == 5 and set(summary["parts_s"]) == {"decode", "backbone", "head", "write"}
        assert sizes == ([1] * 5 if n == 1 else [2, 1, 2])
        out[n] = {f: np.asarray(Image.open(tmp_path / f"b{n}" / f), np.int16)
                  for f in sorted(os.listdir(tmp_path / f"b{n}"))}
    assert list(out[1]) == list(out[3]) == [f"im{i}_depth.png" for i in range(5)]
    for f in out[1]:
        assert out[1][f].shape == out[3][f].shape
        assert np.abs(out[1][f] - out[3][f]).max() <= 1


def test_seeded_state_and_counts_at_published_widths():
    cfg = json.loads(CONFIG.read_text())
    arch = cfg["architecture"]
    with torch.device("meta"):
        model = DinoDPTDepther(**cfg["program"]["model"])
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert shapes == {n: tuple(s) for n, s, _, _ in reference.spec(arch)}
    assert reference.n_parameters(arch) == sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    assert reference.count_flops(arch, 389, 518) == cfg["flops_per_image"]["389x518"]
