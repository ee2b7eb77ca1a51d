"""The port's weight schema at full width, and its isolation from JAX.

The full-width JAX tree comes from ``jax.eval_shape`` of the ``cod`` init (a
trace, no compile); the full-width port is built on the meta device (no
memory).
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from dgtd_tpu.core.registry import MODELS as JAX_MODELS
from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.tools.convert_ckpt import map_full_key
from dgtd_tpu_torch.convert import map_flax_key
from dgtd_tpu_torch.core.registry import MODELS
from dgtd_tpu_torch.models.cod import cod as PortCod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def full_width():
    m = JaxCod(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda r: m.net.init({"params": r}, jnp.zeros((1, 384, 384, 3)), jnp.zeros((1, 384, 384, 1)), train=False),
        jax.random.PRNGKey(0),
    )
    jax_leaves = {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
    with torch.device("meta"):
        port = PortCod(seed=None)
    return jax_leaves, port


def test_full_width_port_keys_are_the_mapped_jax_tree(full_width):
    jax_leaves, port = full_width
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    mapped = {}
    for key, shape in jax_leaves.items():
        coll, path = key.split("/", 1)
        hit = map_flax_key(path, coll)
        assert hit is not None, key
        port_key, tf = hit
        mapped[port_key] = tf(np.broadcast_to(np.float32(0), shape)).shape
        # the port's table and the JAX package's agree on the reference key
        ref = map_full_key(port_key, coll)
        assert ref is not None and _normalized(ref[0]) == path, (key, port_key, ref)
    assert set(mapped) == set(port_shapes)
    for k, shape in mapped.items():
        assert shape == port_shapes[k], k


def _normalized(path):
    """convert_ckpt's table form ``X_i/X_i`` -> the real ``X_i/X_0``."""
    return re.sub(r"(Dense|Conv|LayerNorm)_(\d+)/(Dense|Conv|LayerNorm)_(\d+)",
                  lambda m: f"{m.group(1)}_{m.group(2)}/{m.group(3)}_0", path)


def test_full_width_parameter_count(full_width):
    jax_leaves, port = full_width
    n_port = sum(p.numel() for p in port.parameters())
    n_jax = sum(int(np.prod(s)) for k, s in jax_leaves.items() if k.startswith("params/"))
    assert n_port == n_jax
    assert round(n_port / 1e6, 1) == 114.4


@pytest.mark.parametrize("name", ["baseline", "DQnet"])
def test_full_width_baseline_and_dqnet_keys_are_the_mapped_jax_tree(name):
    """``baseline`` on cod's table (its k = 3 weight regressor the one shape
    that differs from cod's), ``DQnet`` on the DQnet rules: every JAX leaf
    maps to a port key of the same shape, and every port key is reached."""
    m = JAX_MODELS.get(name)(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda r: m.net.init({"params": r}, jnp.zeros((1, 384, 384, 3)), jnp.zeros((1, 384, 384, 1)), train=False),
        jax.random.PRNGKey(0),
    )
    with torch.device("meta"):
        port = MODELS.get(name)(seed=None)
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    mapped = {}
    for key, v in flatten_dict(shapes, sep="/").items():
        coll, path = key.split("/", 1)
        hit = map_flax_key(path, coll)
        assert hit is not None, key
        mapped[hit[0]] = hit[1](np.broadcast_to(np.float32(0), v.shape)).shape
    assert mapped == port_shapes
    if name == "baseline":
        assert port_shapes["hitnet.backbone.prompt_encoder.propagation_weight_regressor.reg.weight"] == (24 * 9, 3, 1, 1)
        assert sum(p.numel() for p in port.parameters()) == 114413215 - 24 * 40 * 4


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_flax_or_dgtd_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dgtd_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = [
        (os.path.relpath(f, ROOT), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dgtd_tpu")
    ]
    assert bad == []
