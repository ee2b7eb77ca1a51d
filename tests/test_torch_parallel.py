"""The port's data parallelism (``dgtd_tpu_torch/parallel/dist.py`` and the
Runner, loader, BatchNorm, DropPath and train step under a process group)
on 2 gloo ranks of CPU processes, against one process on the same global
batch:
  * tiny ``cod`` (grid 12, the recipe's drop-path rates 0.1 and 0.4), 3
    steps at a global batch of 4: the losses, every parameter and the
    BatchNorm running statistics at the tolerances of
    ``tests/test_torch_train.py::test_three_adamw_steps_track_the_jax_train_step``;
    the ranks' parameters bit-equal; also with ``remat``, and with
    ``use_prompts=false`` and ``baseline`` (parameters without a gradient);
  * ``len`` counts global batches, rank 0 alone writes files, the val pass
    is the ranks' mean; SIGTERM to one rank stops both at the same step
    with one ``preempt_step_N``, and ``--resume`` of it reaches the
    uninterrupted run's weights exactly;
  * each rank's rows against ``dgtd_tpu.data.loader.local_row_slices``; the
    loader's split; ``init_distributed``'s launch detection over the cases
    of ``tests/test_sharding.py::test_initialize_multihost_order_and_detection``;
    DQnet's ``-o dist.space=2`` refused; the CLI with ``dist.coordinator``.

Each rank is a process started by ``torch.multiprocessing.spawn``
(``tests/torch_dist_workers.py``, torch only); the one-process runs are in
this process.
"""

import json
import os
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dgtd_tpu.data.loader import local_row_slices
from dgtd_tpu.parallel.mesh import batch_sharding, make_mesh
from dgtd_tpu_torch.data.datasets import SyntheticSODDataset
from dgtd_tpu_torch.data.loader import DataLoader
from dgtd_tpu_torch.parallel import dist as pdist
from dgtd_tpu_torch.train import cli
from dgtd_tpu_torch.train.loop import Runner

import torch_dist_workers as W

LR = 5e-4  # configs/synthetic_smoke.yml's
LOSS_RTOL = 1e-4
BN_RTOL, BN_ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
#: Adam's first steps move a parameter by about lr·mult whatever its
#: gradient's size, so a near-zero gradient whose sign differs between two
#: summation orders moves the other way: such entries may differ by up to
#: 3·2·lr, and at most this share of the entries may lie outside the rtol/atol
FAR_SHARE = 1e-3
BN_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _single(work_dir, extra=()):
    """The tiny recipe in this process, one rank: (per-step losses, state
    after step 3, final state)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runner = Runner(W.recipe(str(work_dir), extra), work_dir=str(work_dir), seed=0, device=torch.device("cpu"),
                        dtype=torch.float32)
        rec = W._record_hook(3, str(work_dir), "single")
        runner.hooks.append(rec)
        runner.train()
    finally:
        torch.set_num_threads(threads)
    return rec.losses, torch.load(os.path.join(work_dir, "state_single_step3.pt")), runner.model.state_dict()


def _two_ranks(out, extra=(), sigterm=None, resume=None):
    """The tiny recipe on 2 spawned ranks: [rank 0's result, rank 1's], each
    with its state after step 3 (when it got there)."""
    os.makedirs(out, exist_ok=True)
    mp.spawn(W.train_rank, args=(2, os.path.join(out, "init"), str(out), tuple(extra), 3, sigterm, resume), nprocs=2)
    results = []
    for r in range(2):
        res = torch.load(os.path.join(out, f"result_{r}.pt"), weights_only=False)
        snap = os.path.join(out, f"state_{r}_step3.pt")
        res["step3"] = torch.load(snap) if os.path.exists(snap) else None
        results.append(res)
    return results


def _assert_tracks(got_losses, got_state, ref_losses, ref_state, steps=3):
    """Every loss term of each step (the SSIM term normalizes the texture by
    the global batch's min and max), then the parameters and statistics."""
    for i in range(steps):
        assert got_losses[i].keys() == ref_losses[i].keys()
        for k, v in ref_losses[i].items():
            np.testing.assert_allclose(got_losses[i][k], v, rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
    far, total = 0, 0
    for k, ref in ref_state.items():
        got = got_state[k]
        if k.endswith(BN_KEYS):
            torch.testing.assert_close(got, ref, rtol=BN_RTOL, atol=BN_ATOL, msg=k)
            continue
        diff = (got - ref).abs()
        assert float(diff.max()) <= 3 * 2 * LR, k
        far += int((diff > PARAM_ATOL + PARAM_RTOL * ref.abs()).sum())
        total += ref.numel()
    assert far <= FAR_SHARE * total, (far, total)


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny recipe (2 epochs of 3 steps, val after epoch 2) in one
    process and on 2 ranks."""
    root = tmp_path_factory.mktemp("dp")
    return {"single": _single(root / "single"), "two": _two_ranks(root / "two"), "root": root}


def test_two_ranks_track_one_process_for_three_steps(runs):
    losses, step3, _ = runs["single"]
    r0 = runs["two"][0]
    _assert_tracks(r0["losses"], r0["step3"], losses, step3)


def test_ranks_parameters_and_statistics_stay_bit_equal(runs):
    r0, r1 = runs["two"]
    _assert_bit_equal(r0["step3"], r1["step3"])
    _assert_bit_equal(r0["state"], r1["state"])
    # the logged loss terms are the global batch's on every rank
    assert r0["losses"] == r1["losses"]


def test_len_counts_global_batches(runs):
    assert [r["rows"] for r in runs["two"]] == [3, 3]
    assert [r["summary"]["steps"] for r in runs["two"]] == [6, 6]


def test_rank0_alone_writes_the_files(runs):
    root = runs["root"] / "two"
    assert os.listdir(root / "rank1") == []
    assert sorted(os.listdir(root / "rank0")) == ["epoch_1.pth", "epoch_2.pth", "log.jsonl", "vis"]
    with open(root / "rank0" / "log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[0] == {"dist": {"backend": "gloo", "world": 2}}
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4, 5, 6]
    # one process starts no group and logs no such record
    with open(runs["root"] / "single" / "log.jsonl") as f:
        assert not any("dist" in json.loads(line) for line in f)
    ckpt = torch.load(root / "rank0" / "epoch_2.pth", weights_only=True)
    _assert_bit_equal(ckpt["state_dict"], runs["two"][1]["state"])


def test_val_pass_is_the_ranks_mean(runs):
    """Each rank scores the whole val set; rank 0 logs the mean. The ranks'
    means of (rank, 1) are (0.5, 1); the metrics are those of one process
    with the same weights, to the weights' fp32 differences."""
    assert runs["two"][0]["means"] == runs["two"][1]["means"] == {"rank": 0.5, "one": 1.0}
    logs = {}
    for name, path in (("two", runs["root"] / "two" / "rank0"), ("single", runs["root"] / "single")):
        with open(path / "log.jsonl") as f:
            logs[name] = [r for r in map(json.loads, f) if "COD/MAE" in r]
    assert len(logs["two"]) == len(logs["single"]) == 1
    for k, v in logs["single"][0].items():
        if k.startswith("COD/"):
            assert abs(logs["two"][0][k] - v) <= 1e-3, k


def test_remat_under_two_ranks_tracks_one_process(runs, tmp_path):
    """``model.remat=true`` on 2 ranks: the recompute draws the global
    batch's DropPath masks again and runs no collective twice."""
    losses, step3, _ = runs["single"]
    r0, r1 = _two_ranks(tmp_path, ["model.remat=true"])
    _assert_tracks(r0["losses"], r0["step3"], losses, step3)
    _assert_bit_equal(r0["state"], r1["state"])


@pytest.mark.parametrize("extra", [["model.use_prompts=false"], ["model.type=baseline"]],
                         ids=["use_prompts_false", "baseline"])
def test_parameters_without_a_gradient_neither_hang_nor_move(tmp_path, extra):
    """``use_prompts=false`` builds no prompt modules; ``baseline`` builds
    them and never runs them (its frozen prefixes): their parameters have no
    gradient on any rank, the average leaves them out, and they stay as
    initialized."""
    losses, step3, _ = _single(tmp_path / "single", extra)
    r0, r1 = _two_ranks(tmp_path / "two", extra)
    _assert_tracks(r0["losses"], r0["step3"], losses, step3)
    _assert_bit_equal(r0["state"], r1["state"])
    model = Runner(W.recipe(str(tmp_path / "init"), extra), work_dir=str(tmp_path / "init"), seed=0,
                   device=torch.device("cpu"), dtype=torch.float32).model
    prefixes = model.frozen_param_prefixes
    frozen = [n for n, _ in model.named_parameters() if prefixes and n.startswith(prefixes)]
    assert bool(frozen) == (extra == ["model.type=baseline"])
    init = model.state_dict()
    assert all(torch.equal(r0["state"][n], init[n]) for n in frozen)


def test_sigterm_to_one_rank_stops_both_and_resume_is_exact(runs, tmp_path):
    cut = _two_ranks(tmp_path / "cut", sigterm=(4, 1))
    ckpt = str(tmp_path / "cut" / "rank0" / "preempt_step_4.pth")
    assert [r["summary"]["steps"] for r in cut] == [4, 4]
    assert [r["summary"].get("preempted") for r in cut] == [ckpt, str(tmp_path / "cut" / "rank1" /
                                                                      "preempt_step_4.pth")]
    assert os.path.exists(ckpt) and os.listdir(tmp_path / "cut" / "rank1") == []
    assert sorted(f for f in os.listdir(tmp_path / "cut" / "rank0") if f.endswith(".pth")) == [
        "epoch_1.pth", "preempt_step_4.pth"]
    resumed = _two_ranks(tmp_path / "resumed", resume=ckpt)
    assert [r["summary"]["steps"] for r in resumed] == [2, 2]
    assert resumed[0]["losses"] == runs["two"][0]["losses"][4:]
    for r in range(2):
        _assert_bit_equal(resumed[r]["state"], runs["two"][r]["state"])


@pytest.mark.parametrize("batch", [2, 10])
def test_row_slices_match_local_row_slices(batch):
    """Process r of 2 on a data axis of 2 devices, one a process: the rows
    ``local_row_slices`` gives it are the port's rank-r rows."""
    devices = jax.devices()[:2]
    sharding = batch_sharding(make_mesh(data=2, devices=devices))
    for r in range(2):
        rows, _ = local_row_slices(sharding, batch, addressable=lambda d, r=r: d == devices[r])
        assert rows == list(range(batch))[pdist.row_slice(batch, r, 2)]


def test_uneven_split_raises():
    with pytest.raises(ValueError, match="does not split evenly"):
        pdist.row_slice(10, 0, 4)
    ds = SyntheticSODDataset(n=8, size=8)
    with pytest.raises(ValueError, match="does not split evenly"):
        DataLoader(ds, 5, drop_last=True, rank=0, world=2)
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(ds, 4, drop_last=False, rank=0, world=2)


@pytest.mark.parametrize("num_workers,prefetch", [(0, 0), (2, 2)])
def test_loader_ranks_take_their_rows_of_each_global_batch(num_workers, prefetch):
    """Every rank shuffles the same order; rank r's batches are rows
    [2r, 2r + 2) of the one-process loader's, flips and ``raw`` included;
    both count the global batches."""
    ds = SyntheticSODDataset(n=13, size=8)

    def epochs(loader):
        return [[{k: v.copy() if isinstance(v, np.ndarray) else v for k, v in b.items()} for b in loader]
                for _ in range(2)]

    full = epochs(DataLoader(ds, 4, shuffle=True, seed=3, drop_last=True, num_workers=num_workers, prefetch=prefetch))
    for r in range(2):
        loader = DataLoader(ds, 4, shuffle=True, seed=3, drop_last=True, num_workers=num_workers, prefetch=prefetch,
                            rank=r, world=2)
        assert len(loader) == 3
        for e_full, e_rank in zip(full, epochs(loader)):
            assert len(e_rank) == len(e_full) == 3
            for b_full, b_rank in zip(e_full, e_rank):
                for k, v in b_full.items():
                    want = v[2 * r:2 * r + 2]
                    assert len(b_rank[k]) == len(want) == 2
                    for got_row, want_row in zip(b_rank[k], want):
                        np.testing.assert_array_equal(got_row, want_row)


MARKERS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_JOB_NUM_NODES", "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS",
           "SLURM_PROCID", "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
           "OMPI_COMM_WORLD_LOCAL_RANK")


def test_init_distributed_launch_detection(monkeypatch):
    """``initialize_multihost``'s cases: no marker starts nothing; an
    explicit coordinator a tcp:// group; SLURM and OMPI sizes only above 1
    (one node with 4 tasks is a launch); torchrun's markers always win."""
    calls = []
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append({"backend": backend, **kw}))
    monkeypatch.setattr(pdist, "side_group", lambda: None)
    for m in MARKERS:
        monkeypatch.delenv(m, raising=False)

    def launch(coordinator=None):
        return pdist.init_distributed(coordinator, "cpu")

    assert launch() == (torch.device("cpu"), False) and calls == []
    assert launch("host:1234") == (torch.device("cpu"), True)
    assert calls == [{"backend": "gloo", "init_method": "tcp://host:1234", "rank": 0, "world_size": 1}]
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    launch()
    assert len(calls) == 1
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "2")
    launch()
    assert len(calls) == 2 and calls[-1] == {"backend": "gloo", "init_method": "env://", "rank": 2, "world_size": 4}
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "4")
    launch()
    assert len(calls) == 3 and calls[-1]["world_size"] == 4
    monkeypatch.delenv("SLURM_JOB_NUM_NODES")
    monkeypatch.delenv("SLURM_PROCID")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    launch()
    assert len(calls) == 3
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "8")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "5")
    launch()
    assert len(calls) == 4 and calls[-1] == {"backend": "gloo", "init_method": "env://", "rank": 5, "world_size": 8}
    # torchrun's markers win, at any size, and set the rank of a coordinator launch
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    launch()
    assert len(calls) == 5 and calls[-1] == {"backend": "gloo", "init_method": "env://", "rank": 0, "world_size": 1}
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    launch("c:99")
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://c:99", "rank": 1, "world_size": 2}
    # a CUDA device without a card raises before any group starts
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdist.init_distributed(None, None)
        assert len(calls) == 6


def test_single_process_starts_no_group(monkeypatch):
    for m in MARKERS:
        monkeypatch.delenv(m, raising=False)
    assert pdist.init_distributed(None, "cpu") == (torch.device("cpu"), False)
    assert not dist.is_initialized()
    assert (pdist.rank(), pdist.world(), pdist.is_main(), pdist.data_group()) == (0, 1, True, None)
    assert pdist.any_rank(True) and not pdist.any_rank(False)
    assert pdist.all_mean({"a": 2.0}) == {"a": 2.0}


def test_dist_space_above_one_raises(tmp_path):
    """A model without a banded forward (DQnet, ROADMAP A13d) refuses
    ``-o dist.space=2`` before anything is started or written."""
    cfg = os.path.join(W.ROOT, "configs", "synthetic_smoke.yml")
    with pytest.raises(NotImplementedError, match="A13d"):
        cli.main([cfg, "--device", "cpu", "-o", f"work_dir={tmp_path}", "-o", "dist.space=2",
                  "-o", "model={'type': 'DQnet', 'variant': 'tiny'}"])
    assert not os.listdir(tmp_path)


def test_cli_coordinator_starts_and_destroys_a_group(tmp_path, monkeypatch):
    """``-o dist.coordinator=host:port`` on one rank: a gloo group for the
    run, destroyed when ``main`` returns."""
    for m in MARKERS:
        monkeypatch.delenv(m, raising=False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ovs = [f"work_dir={tmp_path}", "train_cfg.max_epochs=1", "train_cfg.val_interval=0",
           "train_dataloader.batch_size=2", "train_dataloader.dataset.n=2", "train_dataloader.dataset.size=32",
           f"dist.coordinator=localhost:{port}", *W.TINY_OVERRIDES]
    argv = [os.path.join(W.ROOT, "configs", "synthetic_smoke.yml"), "--device", "cpu", "--fp32"]
    out = cli.main(argv + [a for o in ovs for a in ("-o", o)])
    assert out["steps"] == 1 and not dist.is_initialized()
    with open(tmp_path / "log.jsonl") as f:
        assert [json.loads(line)["step"] for line in f if '"loss"' in line] == [1]
