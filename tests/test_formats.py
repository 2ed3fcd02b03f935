"""The in-repo replacements for flax: pytree dataclasses, the module layer,
and the checkpoint formats (safetensors bundles, npz trainer state)."""

import json
import struct as pystruct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metta_tpu.models import nn
from metta_tpu.rl.checkpoint import (CheckpointManager, _flat_to_params,
                                     _params_to_flat, load_safetensors,
                                     save_safetensors)
from metta_tpu.utils import struct


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray


def test_struct_dataclass_is_a_frozen_pytree():
    p = _Pair(a=jnp.arange(3), b=jnp.ones((2,)))
    leaves, tdef = jax.tree.flatten(p)
    assert len(leaves) == 2
    q = jax.tree.unflatten(tdef, [x * 2 for x in leaves])
    assert isinstance(q, _Pair) and np.array_equal(q.a, [0, 2, 4])
    r = jax.jit(lambda x: x.replace(b=x.b + 1))(p)
    assert np.array_equal(r.b, [2.0, 2.0]) and np.array_equal(r.a, p.a)
    with pytest.raises(Exception):
        p.a = jnp.zeros(3)


def test_safetensors_layout_round_trip(tmp_path):
    t = {"params/x/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
         "ids": np.array([1, -2], np.int32), "half": np.ones((2,), jnp.bfloat16),
         "flag": np.array(True), "empty": np.zeros((0, 4), np.uint8)}
    path = tmp_path / "w.safetensors"
    save_safetensors(t, path)
    raw = path.read_bytes()
    (n,) = pystruct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    assert n % 8 == 0 and 8 + n + header["params/x/kernel"]["data_offsets"][1] <= len(raw)
    assert header["half"]["dtype"] == "BF16" and header["flag"]["shape"] == []
    back = load_safetensors(path)
    assert set(back) == set(t)
    for k, v in t.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
    params = {"params": {"a": {"kernel": np.ones((2, 2), np.float32)}}}
    assert jax.tree.structure(_flat_to_params(_params_to_flat(params), like=params)) \
        == jax.tree.structure(params)
    with pytest.raises(ValueError):
        _flat_to_params({"params/b/kernel": np.ones(1)}, like=params)


def test_trainer_state_round_trip(tmp_path):
    cm = CheckpointManager("r", tmp_path)
    ts = _Pair(a={"w": jnp.arange(4.0), "h": jnp.ones((2,), jnp.bfloat16)},
               b=jnp.array(7, jnp.int32))
    cm.save_trainer_state(ts, epoch=3, extras={"agent_steps": 12})
    back, meta = cm.load_trainer_state(ts)
    assert meta == {"epoch": 3, "extras": {"agent_steps": 12}}
    for x, y in zip(jax.tree.leaves(ts), jax.tree.leaves(back)):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)
    other = _Pair(a={"w": jnp.arange(5.0), "h": jnp.ones((2,), jnp.bfloat16)}, b=ts.b)
    assert cm.load_trainer_state(other) == (None, None)   # shape mismatch: fresh start


class _Net(nn.Module):
    hidden: int = 4

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm(name="ln")(nn.Dense(self.hidden)(x))
        (c, h2), out = nn.OptimizedLSTMCell(self.hidden, name="lstm")(
            (jnp.zeros_like(h), h), h)
        self.sow("intermediates", "h", h)
        return nn.Embed(5, 3)(jnp.array([1, 2])).sum() + out


def test_module_layer_keeps_linen_parameter_layout():
    net = _Net()
    x = jnp.ones((2, 3))
    params = net.init(jax.random.PRNGKey(0), x)
    shapes = jax.tree.map(lambda a: a.shape, params)
    assert shapes["params"]["Dense_0"] == {"kernel": (3, 4), "bias": (4,)}
    assert shapes["params"]["ln"] == {"scale": (4,), "bias": (4,)}
    assert shapes["params"]["Embed_0"] == {"embedding": (5, 3)}
    lstm = shapes["params"]["lstm"]
    assert sorted(lstm) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert lstm["hi"] == {"kernel": (4, 4), "bias": (4,)} and lstm["ii"] == {"kernel": (4, 4)}
    y, inter = net.apply(params, x, mutable=["intermediates"])
    assert y.shape == (2, 4) and inter["intermediates"]["h"][0].shape == (2, 4)
    np.testing.assert_array_equal(net.apply(params, x), y)


def test_module_layer_apply_needs_every_parameter():
    net = _Net()
    params = net.init(jax.random.PRNGKey(0), jnp.ones((2, 3)))
    del params["params"]["ln"]["scale"]
    with pytest.raises(KeyError, match="ln/scale"):
        net.apply(params, jnp.ones((2, 3)))


def test_module_layer_scan_shares_parameters():
    cell = nn.scan(nn.OptimizedLSTMCell)(4, name="lstm")
    xs = jax.random.normal(jax.random.PRNGKey(1), (5, 2, 3))
    carry = (jnp.zeros((2, 4)), jnp.zeros((2, 4)))
    params = cell.init(jax.random.PRNGKey(0), carry, xs)
    (c, h), ys = cell.apply(params, carry, xs)
    step = nn.OptimizedLSTMCell(4)
    cs = carry
    for t in range(5):
        cs, y = step.apply(params, cs, xs[t])
        np.testing.assert_allclose(y, ys[t], rtol=1e-6, atol=1e-6)
