"""The port's spatially sharded diffusion (``dgtd_tpu_torch/parallel/spatial.py``)
on 2 and 4 gloo ranks of CPU processes, against
``dgtd_tpu.parallel.spatial.spatial_diffusion`` on a mesh of as many
devices: its jnp path (``use_pallas=False``) for k in {1, 3, 7} at
``tests/test_spatial_diffusion.py``'s shapes and tolerances, and its
interpret-mode Pallas path; the unsharded plain stencil; the two
refusals (H that the shards do not divide, a shard lower than the halo).

Each rank is a process started by ``torch.multiprocessing.spawn``
(``tests/torch_dist_workers.py``, torch only); the JAX references are
jitted once each in this process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from dgtd_tpu.models.diffusion import normalize_affinity
from dgtd_tpu.parallel.mesh import make_mesh
from dgtd_tpu.parallel.spatial import spatial_diffusion as jax_spatial_diffusion
from dgtd_tpu_torch.ops import diffusion as D

import torch_dist_workers as W

RTOL, ATOL = 1e-4, 1e-5  # tests/test_spatial_diffusion.py's


def _cases():
    """name -> (x, normalized w, kernel, steps, use_pallas): the shapes of
    tests/test_spatial_diffusion.py (B 2, 32x16, C 6 at k = 7 and 3; its
    pointwise (2, 16, 8, 3) at k = 1; its Pallas case (1, 32x16, 4) at
    k = 7), and two that no shard split of 2 or 4 takes: H = 31, and H = 4
    at k = 7 (shards of 2 and 1 rows, below the halo radius 3)."""
    rng = np.random.RandomState(0)

    def case(shape, k, steps, pallas=False, normalize=True):
        x = rng.randn(*shape).astype(np.float32)
        w = rng.rand(*shape, k * k).astype(np.float32)
        if normalize:
            w = np.array(normalize_affinity(jnp.asarray(w)))
        return x, w, k, steps, pallas

    return {
        "k7": case((2, 32, 16, 6), 7, 3),
        "k3": case((2, 32, 16, 6), 3, 6),
        "k1": case((2, 16, 8, 3), 1, 2, normalize=False),
        "pallas_k7": case((1, 32, 16, 4), 7, 2, pallas=True),
        "uneven_h": case((1, 31, 16, 2), 3, 1),
        "short_shard": case((1, 4, 16, 2), 7, 1),
    }


CASES = _cases()
MATCHED = ["k7", "k3", "k1"]
REFUSED = {"uneven_h": "must divide evenly", "short_shard": "< halo radius 3"}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def sharded(request, tmp_path_factory):
    """world -> {case name: the port's result (the shards joined) or the
    refusal's message}, from one spawn of ``world`` ranks."""
    world = request.param
    out = tmp_path_factory.mktemp(f"spatial{world}")
    names = list(CASES)
    cases = [CASES[n][:4] for n in names]
    mp.spawn(W.spatial_rank, args=(world, str(out / "init"), str(out), cases), nprocs=world)
    shards = [torch.load(os.path.join(out, f"spatial_{r}.pt")) for r in range(world)]
    results = {}
    for i, name in enumerate(names):
        parts = [s[i] for s in shards]
        results[name] = parts[0] if isinstance(parts[0], str) else torch.cat(parts, dim=1).numpy()
    return world, results


def _jax_reference(world, name):
    x, w, k, steps, pallas = CASES[name]
    mesh = make_mesh(data=1, space=world, devices=jax.devices()[:world])
    fn = jax.jit(lambda a, b: jax_spatial_diffusion(a, b, k, steps, mesh, use_pallas=pallas, interpret=pallas))
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))


def _plain_unsharded(name):
    x, w, k, steps, _ = CASES[name]
    b, h, wd, c = x.shape
    xp = torch.from_numpy(x).permute(0, 3, 1, 2).reshape(b * c, h, wd)
    wp = torch.from_numpy(w).permute(0, 3, 4, 1, 2).reshape(b * c, k * k, h, wd)
    return D.diffusion_planes_plain(xp, wp, k, steps).reshape(b, c, h, wd).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", MATCHED)
def test_spatial_diffusion_matches_jax_spatial_diffusion(sharded, name):
    world, results = sharded
    got = results[name]
    assert got.shape == CASES[name][0].shape
    np.testing.assert_allclose(got, _jax_reference(world, name), rtol=RTOL, atol=ATOL)


def test_spatial_diffusion_matches_the_interpret_mode_pallas_path(sharded):
    world, results = sharded
    np.testing.assert_allclose(results["pallas_k7"], _jax_reference(world, "pallas_k7"), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", MATCHED + ["pallas_k7"])
def test_spatial_diffusion_equals_the_unsharded_stencil(sharded, name):
    """The same arithmetic a pixel as the unsharded plain stencil: the halo
    rows are the neighbour's rows and the edge rows the zero padding."""
    _, results = sharded
    np.testing.assert_array_equal(results[name], _plain_unsharded(name))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_spatial_diffusion_refuses_what_the_jax_package_refuses(sharded, name):
    world, results = sharded
    assert isinstance(results[name], str) and REFUSED[name] in results[name]
    with pytest.raises(ValueError):
        _jax_reference(world, name)
