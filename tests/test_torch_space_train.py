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
  * tiny ``DQnet`` (PVT ``tiny``, channel 8, drop-path on): 2 AdamW steps
    at (1, 2), (2, 2), (1, 4) and at (1, 4) with a ``cross_size`` of 22,
    which 4 does not divide, against one process and bit-equal across the
    ranks, each ``depth_generator{s}``'s gradients held apart (its prompt
    grid is whole on every rank: they must arrive once); step 1 at (1, 2)
    against ``jax.value_and_grad`` with the backward on a fresh thread;
    one step and the val pass through the train CLI under ``-o
    dist.space=2`` against one process;
  * ``WindowFusion`` (band rows a multiple of the window and not: 16 and
    20 rows at window 4), ``NewWindowFusion`` and the MPRNet blocks (encoder,
    decoder and cross-stage encoder, ORSNet, the resizers) on bands at (1,
    2) and (1, 4): the gathered outputs, every input and parameter
    gradient against the whole module of the port, the outputs against
    the JAX module on the same weights.

The weights come from the port's seeded init through
``dgtd_tpu.tools.convert_ckpt.convert_state_dict`` and back through
``convert.state_dict_from_flax`` (``tests/test_torch_space.py``'s way).
DQnet's JAX variables hold the port's seeded weights
(``torch_jax_parity.flax_from_port``). The ranks
(``tests/torch_dist_workers.py::space_train_rank``, torch only) run while
this process computes one process's steps, the whole fusion modules, the
JAX gradients (one ``jit`` a model) and the JAX fusion modules (eager).
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

from dgtd_tpu.core.registry import MODELS as JAX_MODELS
from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.models import mprnet as JM
from dgtd_tpu.models import window_fusion as JW
from dgtd_tpu.tools.convert_ckpt import convert_state_dict
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.core.config import load_config
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.models.dqnet import DQnet
from dgtd_tpu_torch.train.loop import Runner

import torch_dist_workers as W
from torch_jax_parity import _no_drop_path, flat_variables, flax_from_port, linear_key, mpr_key, nested

#: tests/test_sharding.py::tiny_model's cod; the drop-path rates stay the
#: defaults (0.1, 0.4)
B0 = dict(variant="b0", channel=8, latent_dim=8, diffusion_steps=1, refine_iters=1, convnext_dims=(8, 16, 32, 64),
          convnext_depths=(1, 1, 1, 1))
NO_DROP = dict(drop_path_rate=0.0, convnext_drop_path_rate=0.0)
#: (leg, (data, space), model overrides, backward on a fresh thread) a world
DQ = {"type": "DQnet"}
#: a cross_size that 4 ranks do not divide (and 2 do)
DQ22 = {"type": "DQnet", "cross_size": 22}
LEGS = {2: [("steps_1x2", (1, 2), {}, False), ("nodrop_1x2", (1, 2), NO_DROP, True),
            ("remat_1x2", (1, 2), {"remat": True}, True), ("baseline_1x2", (1, 2), {"type": "baseline"}, False),
            ("dq_steps_1x2", (1, 2), DQ, False), ("dq_nodrop_1x2", (1, 2), {**DQ, "no_drop": True}, True)],
        4: [("steps_2x2", (2, 2), {}, False), ("steps_1x4", (1, 4), {}, False),
            ("grid8_1x4", (1, 4), {"grid": 8}, False), ("dq_steps_2x2", (2, 2), DQ, False),
            ("dq_steps_1x4", (1, 4), DQ, False), ("dq_cross22_1x4", (1, 4), DQ22, False)]}
#: the 2-step legs against one process: (world, leg, one process's leg)
STEP_LEGS = [(2, "steps_1x2", "steps"), (4, "steps_2x2", "steps"), (4, "steps_1x4", "steps"),
             (4, "grid8_1x4", "grid8"), (2, "baseline_1x2", "baseline"), (2, "dq_steps_1x2", "dq_steps"),
             (4, "dq_steps_2x2", "dq_steps"), (4, "dq_steps_1x4", "dq_steps"), (4, "dq_cross22_1x4", "dq_cross22")]
#: one process's legs: (name, model overrides, backward on a fresh thread)
ONE_LEGS = [("steps", {}, False), ("grid8", {"grid": 8}, False), ("nodrop", NO_DROP, True),
            ("baseline", {"type": "baseline"}, False), ("dq_steps", DQ, False),
            ("dq_nodrop", {**DQ, "no_drop": True}, True), ("dq_cross22", DQ22, False)]
DQ_PREFIXES = [f"depth_generator{s}." for s in range(4)]
# the fusion modules on bands against the whole module: the same sums in
# other orders (tests/test_torch_dqnet.py's MODULE_TOL against JAX)
FUSION_TOL = 1e-5
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
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
    JAX loss terms and gradients (cod's; DQnet's under "dq_jax"),
    "resume": one process resumed from the ranks' data-parallel
    checkpoint, "cli_dqnet": one process's DQnet CLI run, "fusion": each
    fusion case's whole module and JAX outputs}: both worlds' ranks
    started at once."""
    root = tmp_path_factory.mktemp("space_train")
    pm = cod(dtype=torch.float32, seed=0, **B0)
    flat, _ = convert_state_dict({k: v.numpy() for k, v in pm.state_dict().items()}, "full")
    flat = {k if k.startswith("batch_stats/") else f"params/{k}": v for k, v in flat.items()}
    carried = state_dict_from_flax(flat)
    dq_state = DQnet(dtype=torch.float32, seed=0, **W.DQ).state_dict()
    weights = {"cod": str(root / "weights.pt"), "DQnet": str(root / "dqnet.pt")}
    torch.save(carried, weights["cod"])
    torch.save(dq_state, weights["DQnet"])
    settings = {"cod": B0, "DQnet": W.DQ}
    batches = _batches()
    optim_cfg = load_config(os.path.join(W.ROOT, "configs", "cod.yml"))["optim_wrapper"]
    dq_optim = {**optim_cfg, "paramwise_cfg": {**optim_cfg["paramwise_cfg"],
                                               "custom_keys": {"backbone": {"lr_mult": 0.2}}}}
    procs = {}
    for world in (2, 4):
        out = root / f"w{world}"
        out.mkdir()
        cli_root = str(root / "cli") if world == 2 else None
        procs[world] = (out, mp.start_processes(
            W.space_train_rank, args=(world, str(out / "init"), str(out), weights, settings, batches,
                                      {"cod": optim_cfg, "DQnet": dq_optim}, LEGS[world], cli_root),
            nprocs=world, join=False, start_method="spawn"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        family = {"cod": (carried, B0), "DQnet": (dq_state, W.DQ)}
        one = {name: W.space_train_leg(W.space_model(family, extra), dq_optim if name.startswith("dq") else optim_cfg,
                                       batches, None, on_a_thread)
               for name, extra, on_a_thread in ONE_LEGS}
        cli_dqnet = W.cli_run(W.train_argv(str(root / "dq_single"), W.ONE_STEP + W.DQ_CLI), str(root), "single")
        fusion = {i: _whole_fusion(i) for i in range(len(W.FUSION_CASES))}
    finally:
        torch.set_num_threads(threads)
    runs = {"one": one, "cli_dqnet": cli_dqnet, "fusion": fusion,
            "jax": _jax_value_and_grad(JaxCod(dtype=jnp.float32, **B0), flat, batches[0]),
            "dq_jax": _jax_value_and_grad(JAX_MODELS.get("DQnet")(dtype=jnp.float32, **W.DQ),
                                          flax_from_port(JAX_MODELS.get("DQnet")(dtype=jnp.float32, **W.DQ),
                                                         [(1, 48, 48, 3)], dq_state), batches[0])}
    for world, (out, ctx) in procs.items():
        _join(ctx)
        runs[world] = [torch.load(out / f"space_train_{r}.pt", weights_only=False) for r in range(world)]
    ckpt = str(root / "cli" / "dp0" / "epoch_1.pth")
    runs["checkpoint"] = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    runs["resume"] = _single_resume(root / "single", ckpt)
    return runs


def _jax_value_and_grad(jm, flat, b):
    """``jax.value_and_grad(jm.loss)`` at ``flat``'s variables on batch
    ``b``, DropPath off: the loss terms and the gradients as port keys."""
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})

    def loss_fn(params):
        return jm.loss({**variables, "params": params}, b, rngs={"dropout": jax.random.PRNGKey(1)})

    with fnn.intercept_methods(_no_drop_path):
        (_, (aux, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": state_dict_from_flax(flat_variables({"params": grads}))}


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _jax_fusion(i, mods, xs):
    """Case ``i``'s outputs (NCHW numpy) from the JAX modules holding the
    port modules' weights, run eagerly on the same inputs."""
    kind, _ = W.FUSION_CASES[i]
    x = [jnp.asarray(_nhwc(t)) for t in xs]

    def run(jm, state_of, key_of, *args):
        params = nested(flax_from_port(jm, args, state_of.state_dict(), key_of))["params"]
        return jm.apply({"params": params}, *args)

    if kind == "window":
        outs = run(JW.WindowFusion(window=W.FUSION_WIN, num_heads=W.FUSION_HEADS), mods["m"], linear_key, *x)
    elif kind == "new_window":
        outs = [run(JW.NewWindowFusion(num_heads=W.FUSION_HEADS), mods["m"], linear_key, *x)]
    elif kind == "encoder_decoder":
        unet = W.MPR_UNET
        enc = run(JM.Encoder(scale_unetfeats=unet), mods["enc"], mpr_key, x[0])
        dec = run(JM.Decoder(scale_unetfeats=unet), mods["dec"], mpr_key, enc)
        enc2 = run(JM.Encoder(scale_unetfeats=unet, use_bias=True, csff=True), mods["enc2"], mpr_key, x[0], enc, dec)
        outs = list(enc) + list(dec) + list(enc2)
    elif kind == "orsnet":
        outs = [run(JM.ORSNet(scale_unetfeats=W.MPR_UNET, num_cab=W.MPR_CABS, use_bias=True), mods["m"],
                    lambda p: mpr_key(p, W.MPR_CABS), x[0], x[1:4], x[4:7])]
    else:
        resizer = {"down": "down.1", "up": "up.1", "skip": "up.1"}
        outs = [run(jm, mods[name], lambda p, name=name: f"{resizer[name]}.weight", *args)
                for name, jm, args in (("down", JM.DownSample(s_factor=W.MPR_UNET), x[:1]),
                                       ("up", JM.UpSample(s_factor=W.MPR_UNET), x[1:2]),
                                       ("skip", JM.SkipUpSample(s_factor=W.MPR_UNET), x[1:3]))]
    return [np.transpose(np.asarray(o), (0, 3, 1, 2)) for o in outs]


def _whole_fusion(i):
    """Case ``i`` on the whole inputs with no layout, in float64 as the
    ranks run it: the outputs, the inputs' and the parameters' gradients
    of the sum over the outputs of <cotangent, output>; and the JAX
    modules' outputs (fp32)."""
    mods, inputs = W.fusion_case(i)
    jax_outs = _jax_fusion(i, mods, [x for x, _ in inputs])
    mods = mods.double()
    xs = [x.double().requires_grad_() for x, _ in inputs]
    outs = W.fusion_forward(i, mods, xs, inputs[0][1])
    sum((y * W.fusion_cotangent(i, k, y.shape).double()).sum() for k, (y, _) in enumerate(outs)).backward()
    return {"outs": [y.detach() for y, _ in outs], "heights": [h for _, h in inputs],
            "grads": [x.grad for x in xs], "params": {n: p.grad for n, p in mods.named_parameters()},
            "jax": jax_outs}


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
    _assert_states_track(r0["after"], r1["after"], ref_state, 3)


def _assert_states_track(got, other_rank, ref_state, steps):
    """Parameters and statistics after ``steps`` AdamW steps against one
    process's (Adam's first steps may move a near-zero gradient's entry the
    other way: at most steps·2·lr, on few entries); the ranks bit-equal."""
    far = total = 0
    for k, ref in ref_state.items():
        assert torch.equal(got[k], other_rank[k]), k
        if k.endswith(BN_KEYS):
            torch.testing.assert_close(got[k], ref, rtol=BN_RTOL, atol=BN_ATOL, msg=k)
            continue
        diff = (got[k] - ref).abs()
        assert float(diff.max()) <= steps * 2 * LR, k
        far += int((diff > PARAM_ATOL + PARAM_RTOL * ref.abs()).sum())
        total += ref.numel()
    assert far <= FAR_SHARE * total, (far, total)


@pytest.mark.parametrize("world,leg", [(2, "dq_steps_1x2"), (4, "dq_steps_2x2"), (4, "dq_steps_1x4")])
@pytest.mark.parametrize("prefix", DQ_PREFIXES)
def test_dqnet_prompt_gradients_arrive_once(runs, world, leg, prefix):
    """Every rank computes DQnet's prompt grid whole and keeps its band's
    rows of each resized prompt: each ``depth_generator{s}``'s step-1
    gradients, averaged over the world, are one process's (not ``space``
    times them)."""
    one = runs["one"]["dq_steps"]["grads"]
    ref = {n: g for n, g in one.items() if n.startswith(prefix)}
    assert ref
    scale = max(float(v.abs().max()) for v in one.values())
    for r, res in enumerate(runs[world]):
        got = res[leg]["grads"]
        for n, want in ref.items():
            limit = GRAD_RTOL * max(float(want.abs().max()), 1e-4 * scale)
            diff = float((got[n] - want).abs().max())
            assert diff <= limit, f"rank {r} {n}: {diff:.3e} > {limit:.3e}"


def test_dqnet_step_one_matches_jax_value_and_grad(runs):
    """Tiny DQnet at (1, 2), drop-path off on both sides: the loss terms and
    every gradient against ``jax.value_and_grad(DQnet.loss)`` on the same
    weights, with the backward on a fresh thread."""
    ref = runs["dq_jax"]
    for res in runs[2]:
        leg = res["dq_nodrop_1x2"]
        assert set(leg["losses"][0]) == set(ref["aux"])
        for k, v in ref["aux"].items():
            np.testing.assert_allclose(leg["losses"][0][k], v, rtol=JAX_LOSS_RTOL, err_msg=k)
        _assert_grads_close(leg["grads"], ref["grads"], JAX_GRAD_RTOL)


def test_dqnet_backward_on_a_fresh_thread_matches_one_process(runs):
    one = runs["one"]["dq_nodrop"]
    for res in runs[2]:
        _assert_losses_close(res["dq_nodrop_1x2"]["losses"], one["losses"], LOSS_RTOL)
        _assert_grads_close(res["dq_nodrop_1x2"]["grads"], one["grads"], GRAD_RTOL)


def test_dqnet_cross_size_the_space_does_not_divide_is_replicated(runs):
    """At cross_size 22 on 4 ranks the prompt grid (never banded) is
    computed whole all the same: the step counts as many layers as at 44."""
    assert 22 % 4 and 44 % 4 == 0
    c22, c44 = runs[4][0]["dq_cross22_1x4"]["counts"], runs[4][0]["dq_steps_1x4"]["counts"]
    for key in ("banded", "replicated", "full", "gathers", "halos"):
        assert c22[key] == c44[key], key


def test_dqnet_train_cli_under_space_2_tracks_one_process(runs):
    """One step of tiny DQnet (its own model block, the backbone's lr key,
    ``PretrainInitHook``) and the val pass through the train CLI under ``-o
    dist.space=2``: the loss terms, the val metrics and the parameters and
    statistics after the step against one process (as the cod resume's);
    the ranks bit-equal."""
    single = runs["cli_dqnet"]
    r0, r1 = (res["cli_dqnet"] for res in runs[2])
    assert r0["summary"]["steps"] == single["summary"]["steps"] == 1
    _assert_losses_close(r0["losses"], single["losses"], LOSS_RTOL)
    assert len(r0["vals"]) == len(single["vals"]) == 1
    for k, v in single["vals"][0].items():
        if k != "val_imgs_per_sec":
            np.testing.assert_allclose(r0["vals"][0][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_states_track(r0["after"], r1["after"], single["after"], 1)


FUSION_IDS = ["{}-{}".format(*c) for c in W.FUSION_CASES]


def _within_scale(got, want, what):
    limit = FUSION_TOL * max(float(want.abs().max()), 1e-6)
    diff = float((got.double() - want).abs().max())
    assert diff <= limit, f"{what}: {diff:.3e} > {limit:.3e}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(len(W.FUSION_CASES)), ids=FUSION_IDS)
def test_fusion_modules_on_bands_match_the_whole_module(runs, world, i):
    """Against the whole module, both in float64: each output gathered whole
    (1e-5 of its scale); each input's gradient, a band's rows of the whole
    module's (summed over the ranks where its level is not banded); each
    parameter's gradient summed over the ranks, the whole module's (1e-5
    of its scale). 20 rows at window 4 (bands of 10 and 5) is the case
    that gave 0.334 before the repair."""
    whole = runs["fusion"][i]
    for r, res in enumerate(runs[world]):
        got = res["fusion"][i]
        assert len(got["outs"]) == len(whole["outs"])
        for k, (g, w) in enumerate(zip(got["outs"], whole["outs"])):
            assert g.shape == w.shape
            _within_scale(g, w, f"rank {r} output {k}")
    for k, (want, h) in enumerate(zip(whole["grads"], whole["heights"])):
        got = [res["fusion"][i]["grads"][k] for res in runs[world]]
        if h % world:
            _within_scale(sum(got), want, f"input {k}")
            continue
        hb = h // world
        for r, g in enumerate(got):
            _within_scale(g, want[:, :, r * hb:(r + 1) * hb], f"rank {r} input {k}")
    for n, want in whole["params"].items():
        _within_scale(sum(res["fusion"][i]["params"][n] for res in runs[world]), want, n)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(len(W.FUSION_CASES)), ids=FUSION_IDS)
def test_fusion_modules_on_bands_match_jax(runs, world, i):
    """The gathered outputs against the JAX modules on the same weights and
    inputs (``tests/test_torch_dqnet.py``'s bar); ``WindowFusion`` gathers
    its maps whether or not its band holds whole windows."""
    ref = runs["fusion"][i]["jax"]
    for res in runs[world]:
        got = res["fusion"][i]
        for g, want in zip(got["outs"], ref):
            np.testing.assert_allclose(g.numpy(), want, **MODULE_TOL)
    if W.FUSION_CASES[i][0] == "window":
        c = runs[world][0]["fusion"][i]["counts"]
        assert (c["banded"], c["replicated"], c["gathers"] > 0) == (0, 1, True), c
