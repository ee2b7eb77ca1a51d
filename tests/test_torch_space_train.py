"""The port's train step under the data×space layout
(``dgtd_tpu_torch/parallel/space.py``'s adjoints, ``models/layers.py``'s
BatchNorm over data×space, ``models/losses.py`` on bands,
``train/state.py``'s world average) on 2 and 4 gloo ranks of CPU
processes:
  * every collective's adjoint (``halo`` within and taller than a band,
    NCHW and NHWC; ``gather_rows``; ``spatial_mean``; the banded and the
    replicated ``Conv2d``; ``spatial_planes``; ``spatial_nhwc``) against
    autograd on the whole tensor, with a random cotangent on each rank;
  * 2 AdamW steps of tiny ``cod`` (``tests/test_sharding.py``'s b0 config,
    48², batch 4, drop-path on) at (data, space) = (1, 2), (2, 2), (1, 4)
    and at (1, 4) with grid 8 (the stencil on the replicated grid), and of
    tiny ``baseline`` (``cod``'s ``supports_space``) at (1, 2), against
    one process of the port (losses rtol 1e-4, each step-1 gradient
    within 1e-4 of its scale), and bit-equal across the ranks;
  * at (1, 2) the step-1 loss and every gradient against ``dgtd_tpu``'s
    ``jax.value_and_grad(model.loss)`` with DropPath off on both sides
    (``tests/test_torch_train.py``'s method and bars), ``train_step``'s
    backward on a fresh thread (which sees no layout, as a CUDA
    backward's thread);
  * ``remat`` under (1, 2) against no remat, its recompute's backward on a
    fresh thread;
  * a data-parallel (2, 1) checkpoint of the train CLI resumed under ``-o
    dist.space=2``: the parameters as saved, epoch 2 against one process
    resumed from the same checkpoint;
  * ``DQnet`` refused under the layout (ROADMAP A13d).

The weights come from the port's seeded init through
``dgtd_tpu.tools.convert_ckpt.convert_state_dict`` and back through
``convert.state_dict_from_flax`` (``tests/test_torch_space.py``'s way).
The ranks (``tests/torch_dist_workers.py::space_train_rank``, torch only)
run while this process computes one process's steps and the JAX
gradients (one ``jit``).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax.traverse_util import unflatten_dict

from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.tools.convert_ckpt import convert_state_dict
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.core.config import load_config
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.models.dqnet import DQnet
from dgtd_tpu_torch.parallel import space as S
from dgtd_tpu_torch.train import cli
from dgtd_tpu_torch.train.loop import Runner

import torch_dist_workers as W
from torch_jax_parity import _no_drop_path, flat_variables

#: tests/test_sharding.py::tiny_model's cod; the drop-path rates stay the
#: defaults (0.1, 0.4)
B0 = dict(variant="b0", channel=8, latent_dim=8, diffusion_steps=1, refine_iters=1, convnext_dims=(8, 16, 32, 64),
          convnext_depths=(1, 1, 1, 1))
NO_DROP = dict(drop_path_rate=0.0, convnext_drop_path_rate=0.0)
#: (leg, (data, space), model overrides, backward on a fresh thread) a world
LEGS = {2: [("steps_1x2", (1, 2), {}, False), ("nodrop_1x2", (1, 2), NO_DROP, True),
            ("remat_1x2", (1, 2), {"remat": True}, True), ("baseline_1x2", (1, 2), {"type": "baseline"}, False)],
        4: [("steps_2x2", (2, 2), {}, False), ("steps_1x4", (1, 4), {}, False),
            ("grid8_1x4", (1, 4), {"grid": 8}, False)]}
#: the 2-step legs against one process: (world, leg, one process's leg)
STEP_LEGS = [(2, "steps_1x2", "steps"), (4, "steps_2x2", "steps"), (4, "steps_1x4", "steps"),
             (4, "grid8_1x4", "grid8"), (2, "baseline_1x2", "baseline")]
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-4
# tests/test_torch_train.py's bars against the JAX package
JAX_LOSS_RTOL, JAX_GRAD_RTOL = 1e-5, 1e-4
# the adjoints: the same sums as autograd on the whole tensor in other orders
ADJ_RTOL, ADJ_ATOL = 1e-5, 1e-5
# tests/test_torch_parallel.py's bars for AdamW steps from one checkpoint
LR = 5e-4
BN_RTOL, BN_ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
FAR_SHARE = 1e-3
BN_KEYS = ("running_mean", "running_var", "num_batches_tracked")
#: a hang in a collective fails the module instead of eating the suite
JOIN_TIMEOUT_S = 300


def _batches():
    """Two global batches of 4 at 48², seeded."""
    out = []
    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        out.append({"input": rng.randn(4, 48, 48, 3).astype(np.float32),
                    "depth": rng.rand(4, 48, 48, 1).astype(np.float32),
                    "label": (rng.rand(4, 48, 48, 1) > 0.5).astype(np.float32)})
    return out


def _join(ctx):
    """Wait for a spawn context's ranks, failing after JOIN_TIMEOUT_S."""
    import time

    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > JOIN_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish within {JOIN_TIMEOUT_S} s")


def _single_resume(work_dir, ckpt):
    """One process of the tiny recipe resumed from ``ckpt`` to its end:
    (state just after the resume, epoch-2 loss terms, final state)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runner = Runner(W.recipe(str(work_dir)), work_dir=str(work_dir), seed=0, device=torch.device("cpu"),
                        dtype=torch.float32)
        runner.resume(ckpt)
        resumed = {k: v.clone() for k, v in runner.model.state_dict().items()}
        rec = W._record_hook(None, str(work_dir), "single")
        runner.hooks.append(rec)
        runner.train()
    finally:
        torch.set_num_threads(threads)
    return resumed, rec.losses, runner.model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{2: [rank results], 4: [...], "one": one process's legs, "jax": the
    JAX loss terms and gradients, "resume": one process resumed from the
    ranks' data-parallel checkpoint}: both worlds' ranks started at once."""
    root = tmp_path_factory.mktemp("space_train")
    pm = cod(dtype=torch.float32, seed=0, **B0)
    flat, _ = convert_state_dict({k: v.numpy() for k, v in pm.state_dict().items()}, "full")
    flat = {k if k.startswith("batch_stats/") else f"params/{k}": v for k, v in flat.items()}
    carried = state_dict_from_flax(flat)
    weights = str(root / "weights.pt")
    torch.save(carried, weights)
    batches = _batches()
    optim_cfg = load_config(os.path.join(W.ROOT, "configs", "cod.yml"))["optim_wrapper"]
    procs = {}
    for world in (2, 4):
        out = root / f"w{world}"
        out.mkdir()
        cli_root = str(root / "cli") if world == 2 else None
        procs[world] = (out, mp.start_processes(
            W.space_train_rank, args=(world, str(out / "init"), str(out), weights, B0, batches, optim_cfg,
                                      LEGS[world], cli_root),
            nprocs=world, join=False, start_method="spawn"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {name: W.space_train_leg(W.space_model(carried, B0, extra), optim_cfg, batches, None, on_a_thread)
               for name, extra, on_a_thread in (("steps", {}, False), ("grid8", {"grid": 8}, False),
                                                ("nodrop", NO_DROP, True), ("baseline", {"type": "baseline"}, False))}
    finally:
        torch.set_num_threads(threads)
    jm = JaxCod(dtype=jnp.float32, **B0)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})

    def loss_fn(params):
        return jm.loss({**variables, "params": params}, batches[0], rngs={"dropout": jax.random.PRNGKey(1)})

    with fnn.intercept_methods(_no_drop_path):
        (_, (aux, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    runs = {"one": one, "jax": {"aux": {k: float(v) for k, v in aux.items()},
                                "grads": state_dict_from_flax(flat_variables({"params": grads}))}}
    for world, (out, ctx) in procs.items():
        _join(ctx)
        runs[world] = [torch.load(out / f"space_train_{r}.pt", weights_only=False) for r in range(world)]
    ckpt = str(root / "cli" / "dp0" / "epoch_1.pth")
    runs["checkpoint"] = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    runs["resume"] = _single_resume(root / "single", ckpt)
    return runs


def _whole_output(i, inp, rank, world):
    """Case ``i``'s output on rank ``rank`` of a 1×world layout, computed
    from the whole inputs (what the forward tests of
    ``tests/test_torch_space.py`` hold the bands to)."""
    from dgtd_tpu_torch.ops.diffusion import diffusion_nhwc, diffusion_planes

    kind, arg = W.ADJOINT_CASES[i]
    x = inp["x"]

    def band(t, h, dim=-2):
        if h % world:
            return t
        hb = h // world
        return t.narrow(dim, rank * hb, hb)

    if kind in ("halo", "halo_nhwc"):
        top, bottom = arg
        dim = -2 if kind == "halo" else 1
        xm = x.movedim(dim, 0)
        padded = torch.cat([xm.new_zeros((top, *xm.shape[1:])), xm, xm.new_zeros((bottom, *xm.shape[1:]))])
        hb = 16 // world
        return padded[rank * hb:rank * hb + hb + top + bottom].movedim(0, dim)
    if kind == "gather":
        return x
    if kind == "mean":
        return x.mean(dim=(2, 3))
    if kind.startswith("conv"):
        m = inp["conv"]
        return band(torch.nn.Conv2d.forward(m, x), m.out_rows(inp["h"]))
    if kind == "planes":
        return band(diffusion_planes(x, inp["w"], W.ADJOINT_KERNEL, W.ADJOINT_STEPS), 16, 1)
    return band(diffusion_nhwc(x, inp["w"], W.ADJOINT_KERNEL, W.ADJOINT_STEPS), 16, 1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(len(W.ADJOINT_CASES)),
                         ids=lambda i: "{}-{}".format(*W.ADJOINT_CASES[i]).replace(", ", "_"))
def test_adjoint_matches_autograd_on_the_whole_tensor(runs, world, i):
    """The objective is the sum over the ranks of <cotangent, output>: a
    banded output's rank takes its band's cotangent, a whole output's
    (a gather, a spatial mean) each rank its own. Each rank's input
    gradient is its band of autograd's on the whole tensor (an input the
    ranks do not band, each rank's copy: their sum); a parameter's
    gradient summed over the ranks is the whole conv's."""
    inp = W.adjoint_inputs(i)
    leaves = [inp["x"].clone().requires_grad_()]
    if "w" in inp:
        leaves.append(inp["w"].clone().requires_grad_())
    whole = dict(inp, x=leaves[0], **({"w": leaves[1]} if "w" in inp else {}))
    total = 0
    for r in range(world):
        y = _whole_output(i, whole, r, world)
        assert tuple(y.shape) == runs[world][r]["adjoints"][i]["out_shape"]
        total = total + (y * W.adjoint_cotangent(i, r, y.shape)).sum()
    total.backward()
    kind = W.ADJOINT_CASES[i][0]
    dims = [-2] if kind in ("halo", "gather", "mean") or kind.startswith("conv") else [1, 2 if kind == "planes" else 1]
    for k, (leaf, dim) in enumerate(zip(leaves, dims)):
        got = [res["adjoints"][i]["grads"][k] for res in runs[world]]
        if leaf.shape[dim] % world:
            torch.testing.assert_close(sum(got), leaf.grad, rtol=ADJ_RTOL, atol=ADJ_ATOL * world)
            continue
        hb = leaf.shape[dim] // world
        for r, g in enumerate(got):
            torch.testing.assert_close(g, leaf.grad.narrow(dim, r * hb, hb), rtol=ADJ_RTOL, atol=ADJ_ATOL)
    if "conv" in inp:
        for n, p in inp["conv"].named_parameters():
            summed = sum(res["adjoints"][i]["params"][n] for res in runs[world])
            torch.testing.assert_close(summed, p.grad, rtol=ADJ_RTOL, atol=ADJ_ATOL * world, msg=n)


def _assert_grads_close(got, ref, rtol):
    """Every gradient within ``rtol`` of its largest entry (a floor of 1e-4
    of the largest anywhere, for gradients that are zero in exact
    arithmetic). A parameter the port's loss never reaches has no
    gradient; the JAX package's is zero (at one refinement iteration
    ``compress_out``, ``compress_out2`` and the weight-0 stage's
    ``out_CFM``)."""
    missing = set(ref) - set(got)
    assert set(got) <= set(ref) and all(not ref[n].any() for n in missing), sorted(missing)
    scale = max(float(v.abs().max()) for v in ref.values())
    for n, r in ref.items():
        if n in missing:
            continue
        limit = rtol * max(float(r.abs().max()), 1e-4 * scale)
        diff = float((got[n] - r).abs().max())
        assert diff <= limit, f"{n}: {diff:.3e} > {limit:.3e}"


def _assert_losses_close(got, ref, rtol):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.keys() == r.keys()
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, rtol=rtol, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("world,leg,ref", STEP_LEGS, ids=[leg for _, leg, _ in STEP_LEGS])
def test_train_steps_track_one_process(runs, world, leg, ref):
    """2 AdamW steps with drop-path on: every loss term of both steps (the
    global batch's, logged the same on every rank), every step-1 gradient
    averaged over the world."""
    one = runs["one"][ref]
    for res in runs[world]:
        _assert_losses_close(res[leg]["losses"], one["losses"], LOSS_RTOL)
        _assert_grads_close(res[leg]["grads"], one["grads"], GRAD_RTOL)


@pytest.mark.parametrize("world,leg,ref", STEP_LEGS, ids=[leg for _, leg, _ in STEP_LEGS])
def test_ranks_stay_bit_equal(runs, world, leg, ref):
    """Parameters and BatchNorm statistics after the steps, and the logged
    loss terms, are the same on every rank bit for bit; the step ran banded
    layers, exchanged halos and gathered, and sent gradients back."""
    first = runs[world][0][leg]
    for res in runs[world][1:]:
        assert res[leg]["state"].keys() == first["state"].keys()
        for k, v in first["state"].items():
            assert torch.equal(res[leg]["state"][k], v), k
        assert res[leg]["losses"] == first["losses"]
    c = first["counts"]
    assert c["banded"] > 0 and c["halos"] > 0 and c["gathers"] > 0 and c["grad_exchanges"] > 0, c


def test_grid8_runs_the_stencil_on_the_replicated_grid(runs):
    """At grid 8 a band of 4 ranks is 2 rows, under the stencil's 3-row
    halo: ``MessagePassing`` gathers the grid and runs it whole, so grid 8
    replicates one layer more than grid 12."""
    g8, g12 = runs[4][0]["grid8_1x4"]["counts"], runs[4][0]["steps_1x4"]["counts"]
    assert g8["replicated"] == g12["replicated"] + 1 and g8["banded"] == g12["banded"] - 1


def test_step_one_matches_jax_value_and_grad(runs):
    """At (1, 2), drop-path off on both sides: the loss terms and every
    gradient against ``jax.value_and_grad(model.loss)``, with the backward
    on a fresh thread."""
    ref = runs["jax"]
    for res in runs[2]:
        leg = res["nodrop_1x2"]
        for k, v in ref["aux"].items():
            np.testing.assert_allclose(leg["losses"][0][k], v, rtol=JAX_LOSS_RTOL, err_msg=k)
        _assert_grads_close(leg["grads"], ref["grads"], JAX_GRAD_RTOL)


def test_backward_on_a_fresh_thread_matches_one_process(runs):
    """A thread that starts with no layout runs the backward: every
    Function took its group and geometry at the forward."""
    one = runs["one"]["nodrop"]
    for res in runs[2]:
        _assert_losses_close(res["nodrop_1x2"]["losses"], one["losses"], LOSS_RTOL)
        _assert_grads_close(res["nodrop_1x2"]["grads"], one["grads"], GRAD_RTOL)


def test_remat_under_the_layout_matches_no_remat(runs):
    """``remat`` with drop-path on under (1, 2), its backward (and so the
    checkpointed blocks' recompute, with their halo exchanges and
    gathers) on a fresh thread: the loss and every gradient of no remat's
    first step."""
    for res in runs[2]:
        remat, plain = res["remat_1x2"], res["steps_1x2"]
        assert remat["losses"][0] == plain["losses"][0]
        _assert_grads_close(remat["grads"], plain["grads"], 1e-6)


def test_data_parallel_checkpoint_resumes_under_space_2(runs):
    """The train CLI data-parallel on 2 ranks (dist.space=1) saves
    epoch_1.pth; ``--resume`` under ``-o dist.space=2`` starts from its
    parameters and statistics bit for bit on both ranks."""
    for res in runs[2]:
        before = res["cli"]["space"]["before"]
        assert before.keys() == runs["checkpoint"].keys()
        for k, v in runs["checkpoint"].items():
            assert torch.equal(before[k], v), k
        assert res["cli"]["space"]["summary"]["steps"] == 3


def test_train_cli_under_space_2_tracks_one_process(runs):
    """Epoch 2 under ``-o dist.space=2`` against one process resumed from
    the same checkpoint: every loss term of its 3 steps, then the
    parameters and statistics (Adam's first steps may move a near-zero
    gradient's entry the other way: at most 3·2·lr, on few entries); the
    ranks bit-equal."""
    _, ref_losses, ref_state = runs["resume"]
    r0, r1 = (res["cli"]["space"] for res in runs[2])
    _assert_losses_close(r0["losses"], ref_losses, LOSS_RTOL)
    far = total = 0
    for k, ref in ref_state.items():
        got = r0["after"][k]
        assert torch.equal(got, r1["after"][k]), k
        if k.endswith(BN_KEYS):
            torch.testing.assert_close(got, ref, rtol=BN_RTOL, atol=BN_ATOL, msg=k)
            continue
        diff = (got - ref).abs()
        assert float(diff.max()) <= 3 * 2 * LR, k
        far += int((diff > PARAM_ATOL + PARAM_RTOL * ref.abs()).sum())
        total += ref.numel()
    assert far <= FAR_SHARE * total, (far, total)


def test_dqnet_is_refused_under_the_layout(tmp_path):
    """``DQnet`` has no banded forward (ROADMAP A13d): the CLI refuses
    ``-o dist.space=2`` before it starts a group or writes a file, and its
    ``loss`` and ``predict`` refuse an active layout."""
    argv = W.train_argv(str(tmp_path / "run"), ["dist.space=2", "model={'type': 'DQnet', 'variant': 'tiny'}"])
    with pytest.raises(NotImplementedError, match="A13d"):
        cli.main(argv)
    assert not (tmp_path / "run").exists()
    m = DQnet(dtype=torch.float32, seed=0, variant="tiny")
    x, d = torch.rand(1, 32, 32, 3), torch.rand(1, 32, 32, 1)
    with S.active_space(S.Space(1, 2, 0, 0, None, None)):
        with pytest.raises(NotImplementedError, match="A13d"):
            m.loss(x, d, d)
        with pytest.raises(NotImplementedError, match="A13d"):
            m.predict(x, d)
