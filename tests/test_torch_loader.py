"""The port's loader: the decode pool and the prefetch thread give the serial
loader's batches bit for bit, release the producer when the consumer
leaves, and raise the producer's exceptions in the consumer; the Runner
builds its loaders with the recipe's ``num_workers``. Plain torch, no JAX.
"""

import threading
import time

import numpy as np
import pytest
import torch

from dgtd_tpu_torch.core.registry import DATASETS, MODELS
from dgtd_tpu_torch.data.loader import DataLoader
from dgtd_tpu_torch.train import loop as L


class _Flipping:
    """A train split of 11 seeded items that draws its flip from the
    loader's per-index stream and sleeps a little, so that the pool's
    threads finish out of order."""

    train_mode = True

    def __init__(self, n=11, size=6):
        rng = np.random.RandomState(0)
        self.items = [rng.rand(size, size + 1, 3).astype(np.float32) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def get(self, index, rng=None):
        time.sleep(0.001 * ((index * 7) % 3))
        img = self.items[index]
        if rng is not None and rng.random() < 0.5:
            img = img[:, ::-1].copy()
        return {"raw": f"item{index}", "input": img, "label": img[..., :1] * 2, "depth": img[..., 1:2]}


def _epochs(loader, n=2):
    return [[{k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v) for k, v in b.items()} for b in loader]
            for _ in range(n)]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("num_workers", [0, 3])
def test_pool_and_prefetch_give_the_serial_batches(num_workers, prefetch):
    """Two epochs of a shuffled train split with flips, at num_workers 0/3
    and prefetch 0/2, equal the serial loader's batches bit for bit."""
    make = lambda w, p: DataLoader(_Flipping(), 3, shuffle=True, seed=4, drop_last=True, device="cpu",
                                   num_workers=w, prefetch=p)
    ref, got = _epochs(make(0, 0)), _epochs(make(num_workers, prefetch))
    assert len(got) == 2 and all(len(e) == 3 for e in got)
    flips = 0
    for e, (ref_e, got_e) in enumerate(zip(ref, got)):
        for b, (rb, gb) in enumerate(zip(ref_e, got_e)):
            assert gb["raw"] == rb["raw"], (e, b)
            for k in ("input", "label", "depth"):
                np.testing.assert_array_equal(gb[k], rb[k], err_msg=f"epoch {e} batch {b} {k}")
            flips += sum(not np.array_equal(gb["input"][i], _Flipping().items[int(r[4:])])
                         for i, r in enumerate(gb["raw"]))
    assert 0 < flips < 18  # the streams flip some items and not others
    assert ref[0][0]["raw"] != ref[1][0]["raw"]  # each epoch reshuffles


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "dgtd-prefetch"]


def test_break_leaves_no_prefetch_thread():
    loader = DataLoader(_Flipping(n=40), 2, shuffle=True, num_workers=2, prefetch=2)
    before = len(_prefetch_threads())
    for _ in loader:
        break
    assert len(_prefetch_threads()) == before
    # an iterator closed explicitly releases its producer too
    it = iter(loader)
    next(it)
    it.close()
    assert len(_prefetch_threads()) == before


class _Broken(_Flipping):
    def get(self, index, rng=None):
        if index == 5:
            raise OSError("cannot decode item 5")
        return super().get(index, rng)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_an_exception_in_get_reaches_the_consumer(num_workers):
    loader = DataLoader(_Broken(), 2, num_workers=num_workers, prefetch=2)
    with pytest.raises(OSError, match="item 5"):
        for _ in loader:
            pass
    assert not _prefetch_threads()


@DATASETS.register
class _TinyLoaderDataset(_Flipping):
    def __init__(self):
        super().__init__(n=4)


@MODELS.register
class _TinyLoaderModel(torch.nn.Module):
    """A stand-in model: the test reads the loaders, not the forward."""

    frozen_param_prefixes = ()

    def __init__(self, dtype=None, seed=None):
        super().__init__()
        self.lin = torch.nn.Linear(2, 2)


def test_runner_builds_loaders_with_the_recipe_workers(monkeypatch, tmp_path):
    """Both loaders take the recipe block's num_workers and prefetch (2
    unless the block names another)."""
    built = []

    class Spy(DataLoader):
        def __init__(self, *a, **kw):
            built.append((kw["num_workers"], kw["prefetch"], kw["drop_last"]))
            super().__init__(*a, **kw)

    monkeypatch.setattr(L, "DataLoader", Spy)
    loader_cfg = {"batch_size": 2, "num_workers": 8, "dataset": {"type": "_TinyLoaderDataset"}}
    L._loader(loader_cfg, True, 0, torch.device("cpu"))
    L._loader({**loader_cfg, "num_workers": 0, "prefetch": 0}, False, 0, torch.device("cpu"))
    assert built == [(8, 2, True), (0, 0, False)]
    cfg = {"train_dataloader": loader_cfg, "val_dataloader": {**loader_cfg, "num_workers": 3},
           "train_cfg": {"max_epochs": 1, "val_interval": 1},
           "model": {"type": "_TinyLoaderModel"}}
    runner = L.Runner(cfg, work_dir=str(tmp_path), device="cpu", dtype=torch.float32)
    assert built[2:] == [(8, 2, True), (3, 2, False)]
    assert runner.train_loader._pool._max_workers == 8 and runner.val_loader._pool._max_workers == 3

