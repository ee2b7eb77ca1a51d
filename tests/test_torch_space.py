"""The port's data×space serving layout (``dgtd_tpu_torch/parallel/space.py``)
on 2 and 4 gloo ranks of CPU processes:
  * ``halo`` (within a band and taller than one, NCHW and NHWC) and
    ``gather_rows`` against slicing the whole tensor;
  * the banded ``Conv2d`` at every conv geometry of ``cod`` against
    ``nn.Conv2d`` on the whole tensor, and the layouts it must replicate;
  * tiny ``cod.predict`` (``tests/test_sharding.py``'s config: b0, channel
    8, one diffusion step, 48², batch 4) under (data, space) = (1, 2),
    (2, 2) and (1, 4), gathered whole, against ``dgtd_tpu``'s ``predict``
    on the same weights within ``test_sharding.py``'s rtol 2e-4 / atol
    2e-5, and against one process of the port; layers replicated at 48²
    are counted;
  * at 384² (PVT ``tiny``, ConvNeXt (8, 16, 32, 64), channel 8) no layer is
    replicated at 2 or 4 ranks (``test_sharding.py``'s "every pyramid level
    divides");
  * ``-m val -o dist.space=2`` on 2 ranks against one process (``PERF.md``
    §2's val bar, rtol 1e-4 / atol 1e-6);
  * tiny ``DQnet`` (``tests/test_torch_dqnet.py``'s) ``predict`` under the
    same layouts against ``dgtd_tpu``'s ``DQnet.predict`` on the same
    weights (the same bar) and against one process (1e-5); each prompt's
    resize to its stage adds one replicated layer and no exchange, the cue
    grid's one gather of the depth; its ``-m val -o dist.space=2``
    against one process.
The train step under the layout is ``tests/test_torch_space_train.py``'s.

The JAX weights come from the port's seeded init through
``dgtd_tpu.tools.convert_ckpt.convert_state_dict`` and back through
``convert.state_dict_from_flax``, which the ranks load (DQnet's through
``torch_jax_parity.flax_from_port``). The ranks
(``tests/torch_dist_workers.py::space_rank``, torch only) run while this
process computes the JAX reference: cod's eagerly, DQnet's jitted (a
3-second compile where its eager forward takes 30).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax.traverse_util import unflatten_dict

from dgtd_tpu.core.registry import MODELS as JAX_MODELS
from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.tools.convert_ckpt import convert_state_dict
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.models.dqnet import DQnet
from dgtd_tpu_torch.parallel import dist as pdist
from dgtd_tpu_torch.parallel import space as S
from dgtd_tpu_torch.train import cli

import torch_dist_workers as W
from torch_jax_parity import flax_from_port, nested

#: tests/test_sharding.py::tiny_model's cod
B0 = dict(variant="b0", channel=8, latent_dim=8, diffusion_steps=1, refine_iters=1, convnext_dims=(8, 16, 32, 64),
          convnext_depths=(1, 1, 1, 1))
#: tiny widths at the full 384² (two refinement iterations: compress_out runs)
TINY384 = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1), channel=8, latent_dim=8,
               refine_iters=2)
LAYOUTS = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
RTOL, ATOL = 2e-4, 2e-5  # tests/test_sharding.py:208
# the layout against one process: the same arithmetic but for the spatial
# means' order
ONE_TOL = dict(rtol=1e-5, atol=1e-5)
VAL_RTOL, VAL_ATOL = 1e-4, 1e-6


def _inputs():
    rng = np.random.RandomState(0)
    return rng.rand(4, 48, 48, 3).astype(np.float32), rng.rand(4, 48, 48, 1).astype(np.float32)


def _val_argv(work_dir, extra=()):
    argv = [os.path.join(W.ROOT, "configs", "synthetic_smoke.yml"), "-m", "val", "--device", "cpu", "--fp32"]
    for o in W.overrides(work_dir, extra):
        argv += ["-o", o]
    return argv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{2: [rank results], 4: [...], "jax": the JAX prob, "port": one
    process's prob, "val": one process's val metrics, and DQnet's
    "dqnet_jax", "dqnet_port", "val_dqnet"}: both worlds' ranks started at
    once, the JAX reference computed while they run."""
    root = tmp_path_factory.mktemp("space")
    pm = cod(dtype=torch.float32, seed=0, **B0)
    flat, skipped = convert_state_dict({k: v.numpy() for k, v in pm.state_dict().items()}, "full")
    assert all(k.endswith("num_batches_tracked") for k in skipped), skipped
    flat = {k if k.startswith("batch_stats/") else f"params/{k}": v for k, v in flat.items()}
    carried = state_dict_from_flax(flat)
    result = pm.load_state_dict(carried, strict=False)
    assert result.unexpected_keys == [] and all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    weights = str(root / "weights.pt")
    torch.save(carried, weights)
    dq = DQnet(dtype=torch.float32, seed=0, **W.DQ)
    dq_weights = str(root / "dqnet.pt")
    torch.save(dq.state_dict(), dq_weights)
    img, dep = _inputs()
    procs = {}
    for world in (2, 4):
        out = root / f"w{world}"
        out.mkdir()
        vals = {}
        if world == 2:
            vals = {"val": tuple(_val_argv(str(out / "val"), ["dist.space=2"])),
                    "val_dqnet": tuple(_val_argv(str(out / "val_dq"), W.DQ_CLI + ["dist.space=2"]))}
        procs[world] = (out, mp.start_processes(
            W.space_rank, args=(world, str(out / "init"), str(out), weights, B0, (img, dep), LAYOUTS[world],
                                (TINY384, 0), vals, (dq_weights, W.DQ)),
            nprocs=world, join=False, start_method="spawn"))
    jm = JaxCod(dtype=jnp.float32, **B0)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    with jax.disable_jit():
        jax_prob = np.asarray(jm.predict(variables, jnp.asarray(img), jnp.asarray(dep))[0])
    port_prob, port_extras = pm.predict(torch.from_numpy(img), torch.from_numpy(dep))
    val = cli.main(_val_argv(str(root / "val_single")))
    jdq = JAX_MODELS.get("DQnet")(dtype=jnp.float32, **W.DQ)
    dq_vars = nested(flax_from_port(jdq, [(1, *img.shape[1:])], dq.state_dict()))
    dq_jax = np.asarray(jax.jit(lambda v, i, d: jdq.predict(v, i, d))(dq_vars, img, dep)[0])
    runs = {"jax": jax_prob, "port": port_prob.numpy(), "texture": port_extras["texture"].numpy(), "val": val,
            "dqnet_jax": dq_jax, "dqnet_port": dq.predict(torch.from_numpy(img), torch.from_numpy(dep))[0].numpy(),
            "val_dqnet": cli.main(_val_argv(str(root / "val_dq_single"), W.DQ_CLI))}
    for world, (out, ctx) in procs.items():
        while not ctx.join():
            pass
        runs[world] = [torch.load(out / f"space_{r}.pt", weights_only=False) for r in range(world)]
    return runs


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_gather_rows_and_band_rows_give_back_the_whole_tensor(runs, world):
    x = torch.randn(2, 3, 16, 5, generator=torch.Generator().manual_seed(0))
    hb = 16 // world
    for r, res in enumerate(runs[world]):
        assert torch.equal(res["band"], x[:, :, r * hb:(r + 1) * hb])
        assert torch.equal(res["gather"], x)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("top,bottom", W.SPACE_HALOS)
def test_halo_equals_slicing_the_zero_padded_level(runs, world, top, bottom):
    """Within a band the ring neighbours send the rows; a halo taller than
    a band (7/6 at 4 ranks, 9/10 at both) comes from the gathered level."""
    x = torch.randn(2, 3, 16, 5, generator=torch.Generator().manual_seed(0))
    hb = 16 // world
    padded = torch.cat([x.new_zeros(2, 3, top, 5), x, x.new_zeros(2, 3, bottom, 5)], dim=2)
    for r, res in enumerate(runs[world]):
        assert torch.equal(res["halo"][(top, bottom)], padded[:, :, r * hb:r * hb + hb + top + bottom])


@pytest.mark.parametrize("world", WORLDS)
def test_halo_along_the_rows_of_an_nhwc_map(runs, world):
    x = torch.randn(2, 3, 16, 5, generator=torch.Generator().manual_seed(0)).permute(0, 2, 3, 1)
    hb = 16 // world
    padded = torch.cat([x.new_zeros(2, 2, 5, 3), x, x.new_zeros(2, 3, 5, 3)], dim=1)
    for r, res in enumerate(runs[world]):
        assert torch.equal(res["halo_nhwc"], padded[:, r * hb:r * hb + hb + 5])
    # one exchange a halo that fits a band; the taller ones gather
    fits = sum(t <= hb and b <= hb for t, b in W.SPACE_HALOS) + 1
    assert runs[world][0]["halo_counts"]["halos"] == fits


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("i", range(len(W.SPACE_CONVS)), ids=lambda i: "k{2}s{3}p{4}g{5}".format(*W.SPACE_CONVS[i]))
def test_banded_conv_matches_the_whole_conv(runs, world, i):
    """Each conv geometry of cod on a 64-row level (bands of 32 and 16):
    the halo geometry gives the whole conv's output; it runs on the band
    (a 1x1 conv is pointwise and counts as neither)."""
    for res in runs[world]:
        c = res["conv"][i]
        torch.testing.assert_close(c["got"], c["want"], rtol=1e-5, atol=1e-5)
        pointwise = c["case"][2] == 1 and c["case"][3] == 1
        assert (c["counts"]["banded"], c["counts"]["replicated"]) == ((0, 0) if pointwise else (1, 0))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("i", range(len(W.SPACE_REPLICATED)))
def test_conv_the_layout_replicates_matches_the_whole_conv(runs, world, i):
    """A band off the stride, a level the ranks do not divide, a halo
    taller than the band (at 4 ranks; banded at 2): gathered, computed
    whole, banded again where the output's level is banded."""
    for res in runs[world]:
        c = res["conv_replicated"][i]
        torch.testing.assert_close(c["got"], c["want"], rtol=1e-5, atol=1e-5)
        banded_at_2 = c["case"][2] == 7 and world == 2
        assert (c["counts"]["banded"], c["counts"]["replicated"]) == ((1, 0) if banded_at_2 else (0, 1))


def _layouts():
    return [(w, d, s) for w in WORLDS for d, s in LAYOUTS[w]]


@pytest.mark.parametrize("world,data,space", _layouts())
def test_tiny_cod_predict_under_the_layout_matches_jax(runs, world, data, space):
    """``tests/test_sharding.py::test_sharded_predict_matches_single_device``'s
    bar, against ``dgtd_tpu``'s ``predict`` on the carried weights."""
    for res in runs[world]:
        got = res[f"predict_{data}x{space}"]
        assert tuple(got["band"]) == (4 // data, 48 // space, 48, 1)
        np.testing.assert_allclose(got["prob"].numpy(), runs["jax"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world,data,space", _layouts())
def test_tiny_cod_predict_under_the_layout_matches_one_process(runs, world, data, space):
    """The same arithmetic as one process but for the spatial means'
    order: the probability and the texture (its FFT on the gathered
    image) within the same bar, the ranks' gathered maps equal."""
    first = runs[world][0][f"predict_{data}x{space}"]
    for res in runs[world]:
        got = res[f"predict_{data}x{space}"]
        np.testing.assert_allclose(got["prob"].numpy(), runs["port"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["texture"].numpy(), runs["texture"], rtol=RTOL, atol=ATOL)
        assert torch.equal(got["prob"], first["prob"])


@pytest.mark.parametrize("world,data,space", _layouts())
def test_layers_replicated_at_48_are_counted(runs, world, data, space):
    """At 48² b0's stages are 12, 6, 3 and 2 rows: the levels that the
    space ranks do not divide, and the convs whose band breaks the stride,
    run replicated, and the layout goes back to bands after them."""
    c = runs[world][0][f"predict_{data}x{space}"]["counts"]
    assert c["replicated"] > 0 and c["banded"] > 0
    assert c["gathers"] > 0 and c["halos"] > 0 and c["halo_bytes"] > 0 and c["full"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_every_layer_is_banded_at_384(runs, world):
    """At 384² every level of the tiny model (PVT 96/48/24/12, ConvNeXt
    the same, grid 12, the decoder's 48/24/12) divides 2 and 4 ranks and
    every band fits its halo and its stride: nothing is replicated. The
    gathered probability equals one process's."""
    for res in runs[world]:
        c = res["tiny384"]["counts"]
        assert c["replicated"] == 0 and c["banded"] > 0, c
    one = runs[world][0]["tiny384"]["one_process"]
    np.testing.assert_allclose(runs[world][0]["tiny384"]["prob"].numpy(), one.numpy(), rtol=RTOL, atol=ATOL)


def test_val_under_space_2_matches_one_process(runs):
    """``-m val -o dist.space=2`` on 2 ranks: the gathered maps scored on
    every rank give one process's metrics."""
    single = runs["val"]
    for res in runs[2]:
        val = res["val"]
        assert set(val) == set(single)
        for k, v in single.items():
            if k != "val_imgs_per_sec":
                np.testing.assert_allclose(val[k], v, rtol=VAL_RTOL, atol=VAL_ATOL, err_msg=k)


@pytest.mark.parametrize("world,data,space", _layouts())
def test_tiny_dqnet_predict_under_the_layout_matches_jax(runs, world, data, space):
    """``DQnet`` under the layout against ``dgtd_tpu``'s ``DQnet.predict``
    on the same weights, at ``test_sharding.py``'s bar."""
    for res in runs[world]:
        got = res[f"dqnet_{data}x{space}"]
        assert tuple(got["band"]) == (4 // data, 48 // space, 48, 1)
        np.testing.assert_allclose(got["prob"].numpy(), runs["dqnet_jax"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world,data,space", _layouts())
def test_tiny_dqnet_predict_under_the_layout_matches_one_process(runs, world, data, space):
    """The ranks' gathered maps equal each other and one process's within
    1e-5."""
    first = runs[world][0][f"dqnet_{data}x{space}"]
    for res in runs[world]:
        got = res[f"dqnet_{data}x{space}"]
        np.testing.assert_allclose(got["prob"].numpy(), runs["dqnet_port"], **ONE_TOL)
        assert torch.equal(got["prob"], first["prob"])


@pytest.mark.parametrize("world,data,space", _layouts())
def test_dqnet_prompts_come_from_the_whole_grid(runs, world, data, space):
    """The cue grid is computed whole on every rank from one gather of the
    1-channel depth (counted ``full``), and each block's prompt (4 in PVT
    ``tiny``) is resized to its stage from the whole prompt with no
    exchange: one replicated layer each, no ``full`` level, no gather."""
    rows = 4 // data
    for res in runs[world]:
        got = res[f"dqnet_{data}x{space}"]
        assert got["cues"] == [{"full": 1, "gathers": 1, "gather_bytes": rows * 48 * 48 * 4}]
        assert got["prompts"] == [{"replicated": 1}] * 4
        assert got["counts"]["banded"] > 0 and got["counts"]["halos"] > 0


def test_dqnet_val_under_space_2_matches_one_process(runs):
    """``-m val -o dist.space=2`` of tiny DQnet (its own model block) on 2
    ranks: one process's metrics."""
    single = runs["val_dqnet"]
    for res in runs[2]:
        val = res["val_dqnet"]
        assert set(val) == set(single)
        for k, v in single.items():
            if k != "val_imgs_per_sec":
                np.testing.assert_allclose(val[k], v, rtol=VAL_RTOL, atol=VAL_ATOL, err_msg=k)


def test_no_active_space_is_a_no_op():
    x = torch.randn(1, 2, 6, 3)
    assert S.current() is None and not S.split() and not S.banded(6)
    assert S.band_rows(x) is x and S.gather_rows(x, 6) is x and S.gather_map(x, 6) is x
    assert torch.equal(S.halo(x, 1, 2, 6), torch.cat([x.new_zeros(1, 2, 1, 3), x, x.new_zeros(1, 2, 2, 3)], 2))
    assert torch.equal(S.spatial_mean(x, None), x.mean(dim=(2, 3)))


def test_space_needs_a_world_of_data_times_space(tmp_path):
    """``-m val -o dist.space=2`` in one process: the world (1) is not a
    multiple of 2."""
    assert pdist.start_space(1) is None
    with pytest.raises(ValueError, match="dist.space=2 needs a world"):
        cli.main(_val_argv(str(tmp_path), ["dist.space=2"]))
