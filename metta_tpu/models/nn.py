"""A small module layer over explicit parameter pytrees.

Policies, recurrent cells and loss heads are classes whose ``@compact``
``__call__`` declares each parameter where it is used (``self.param``) and
builds submodules inline. The layer keeps ``flax.linen``'s parameter names,
shapes and numerics for the layers below, so policy bundles written with
linen load unchanged; it implements only the subset of linen this
repository uses.

- ``module.init(key, *args)`` runs the call once and returns the parameter
  pytree ``{"params": {...}}`` (nested dicts of arrays).
- ``module.apply(variables, *args)`` is a pure function of that pytree.
  ``mutable=["intermediates"]`` also returns what the call ``sow``-ed, as
  ``(out, {"intermediates": {name: (value,)}})``.

A submodule built inside a ``@compact`` call takes its parameters from the
sub-dict under its ``name`` (``ClassName_<n>`` when unnamed). A parameter
missing at ``apply`` is an error; at ``init`` it is drawn from a key folded
with the parameter's path.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
import zlib
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import (  # noqa: F401  (re-exported for model code)
    gelu,
    initializers,
    log_sigmoid,
    log_softmax,
    one_hot,
    relu,
    sigmoid,
    silu,
    softmax,
    softplus,
)

_default_kernel_init = initializers.lecun_normal()


# ---------------------------------------------------------------------------
# scopes: where a module's parameters live
# ---------------------------------------------------------------------------


class _Run:
    """State of one ``init`` or ``apply`` call."""

    def __init__(self, key, intermediates: Optional[dict]):
        self.key = key                      # None while applying
        self.intermediates = intermediates  # None unless collected


class _Scope:
    def __init__(self, run: _Run, params: dict, path: tuple):
        self.run, self.params, self.path = run, params, path

    def child(self, name: str) -> "_Scope":
        if self.run.key is not None:
            sub = self.params.setdefault(name, {})
        else:
            sub = self.params.get(name, {})
        return _Scope(self.run, sub, self.path + (name,))

    def param(self, name: str, init_fn: Callable, *args):
        if name in self.params:
            return self.params[name]
        path = "/".join(self.path + (name,))
        if self.run.key is None:
            raise KeyError(f"parameter {path!r} is missing")
        key = jax.random.fold_in(self.run.key, zlib.crc32(path.encode()) & 0x7FFFFFFF)
        value = init_fn(key, *args)
        self.params[name] = value
        return value

    def sow(self, name: str, value):
        if self.run.intermediates is None:
            return
        d = self.run.intermediates
        for p in self.path:
            d = d.setdefault(p, {})
        d[name] = d.get(name, ()) + (value,)


class _Frame:
    """One running ``@compact`` call: the scope that submodules built in it
    attach to, and the counters for their default names."""

    def __init__(self, scope: _Scope):
        self.scope = scope
        self.counts: dict[str, int] = {}

    def auto_name(self, cls_name: str) -> str:
        n = self.counts.get(cls_name, 0)
        self.counts[cls_name] = n + 1
        return f"{cls_name}_{n}"


_frames = threading.local()


def _stack() -> list:
    if not hasattr(_frames, "stack"):
        _frames.stack = []
    return _frames.stack


def compact(fn):
    """Mark the method that declares parameters and builds submodules."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is unbound: call it through init/apply "
                "or from a parent's @compact method")
        stack = _stack()
        stack.append(_Frame(self._scope))
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


def _prune(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


@dataclasses.dataclass(eq=False)
class Module:
    """Base class. Subclasses are dataclasses of their hyperparameters."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False)(cls)

    def __post_init__(self):
        scope = None
        stack = _stack()
        if stack:
            frame = stack[-1]
            if self.name is None:
                self.name = frame.auto_name(type(self).__name__)
            scope = frame.scope.child(self.name)
        object.__setattr__(self, "_scope", scope)

    def param(self, name: str, init_fn: Callable, *args):
        return self._scope.param(name, init_fn, *args)

    def sow(self, collection: str, name: str, value):
        assert collection == "intermediates", collection
        self._scope.sow(name, value)

    def _run_bound(self, run: _Run, params: dict, args, kwargs):
        saved = self._scope
        object.__setattr__(self, "_scope", _Scope(run, params, ()))
        try:
            return self(*args, **kwargs)
        finally:
            object.__setattr__(self, "_scope", saved)

    def init(self, key, *args, **kwargs):
        params: dict = {}
        self._run_bound(_Run(key, None), params, args, kwargs)
        return {"params": _prune(params)}

    def apply(self, variables, *args, mutable: Sequence[str] = (), **kwargs):
        collect = "intermediates" in mutable
        run = _Run(None, {} if collect else None)
        out = self._run_bound(run, variables.get("params", {}), args, kwargs)
        if collect:
            return out, {"intermediates": run.intermediates}
        return out


# ---------------------------------------------------------------------------
# dtype promotion (linen's promote_dtype)
# ---------------------------------------------------------------------------


def _promote(*args, dtype=None, inexact: bool = True):
    if dtype is None:
        dtype = jnp.result_type(*[jnp.asarray(a) for a in args if a is not None])
        if inexact and not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return tuple(None if a is None else jnp.asarray(a, dtype) for a in args)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,), self.param_dtype)
                if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())),
                            precision=self.precision)
        return y if bias is None else y + bias


class _DenseGeneral(Module):
    """Dense over several input or output axes (attention projections)."""

    features: tuple
    in_axes: int = 1
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        n = self.in_axes
        in_shape = x.shape[x.ndim - n:]

        def kernel_init(key, shape, dtype):
            flat = (math.prod(in_shape), math.prod(self.features))
            return self.kernel_init(key, flat, dtype).reshape(shape)

        kernel = self.param("kernel", kernel_init, in_shape + self.features,
                            self.param_dtype)
        bias = self.param("bias", self.bias_init, self.features, self.param_dtype)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        dims = tuple(range(x.ndim - n, x.ndim))
        y = lax.dot_general(x, kernel, ((dims, tuple(range(n))), ((), ())))
        return y + bias


def _stats(x, use_mean: bool):
    dtype = jnp.promote_types(jnp.result_type(x), jnp.float32)
    x = x.astype(dtype)
    if use_mean:
        mu = x.mean(-1)
        var = jnp.maximum(0.0, (x * x).mean(-1) - mu * mu)
    else:
        var = (x * x).mean(-1)
        mu = jnp.zeros_like(var)
    return mu, var


def _normalize(mdl, x, mean, var, epsilon, use_bias, use_scale):
    F = x.shape[-1]
    fshape = (1,) * (x.ndim - 1) + (F,)
    y = x - mean[..., None]
    mul = lax.rsqrt(var[..., None] + epsilon)
    args = [x]
    if use_scale:
        scale = mdl.param("scale", initializers.ones, (F,), mdl.param_dtype).reshape(fshape)
        mul = mul * scale
        args.append(scale)
    y = y * mul
    if use_bias:
        bias = mdl.param("bias", initializers.zeros, (F,), mdl.param_dtype).reshape(fshape)
        y = y + bias
        args.append(bias)
    dtype = mdl.dtype or jnp.result_type(*args)
    return jnp.asarray(y, dtype)


class LayerNorm(Module):
    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True

    @compact
    def __call__(self, x):
        mean, var = _stats(x, use_mean=True)
        return _normalize(self, x, mean, var, self.epsilon, self.use_bias, self.use_scale)


class RMSNorm(Module):
    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_scale: bool = True

    @compact
    def __call__(self, x):
        mean, var = _stats(x, use_mean=False)
        return _normalize(self, x, mean, var, self.epsilon, False, self.use_scale)


class Embed(Module):
    num_embeddings: int
    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    @compact
    def __call__(self, inputs):
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features), self.param_dtype)
        (table,) = _promote(table, dtype=self.dtype, inexact=False)
        return jnp.take(table, inputs, axis=0)


class Conv(Module):
    """2-D convolution over NHWC inputs with an HWIO kernel."""

    features: int
    kernel_size: tuple
    strides: tuple = (1, 1)
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            tuple(self.kernel_size) + (x.shape[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,), self.param_dtype)
                if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.conv_general_dilated(
            x, kernel, tuple(self.strides), self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y if bias is None else y + bias


def dot_product_attention(query, key, value, mask=None, dtype=None):
    """softmax(q·k / sqrt(d)) · v over ``[..., len, heads, d]`` operands."""
    query, key, value = _promote(query, key, value, dtype=dtype)
    dtype = query.dtype
    query = query / jnp.sqrt(query.shape[-1]).astype(dtype)
    w = jnp.einsum("...qhd,...khd->...hqk", query, key)
    if mask is not None:
        w = jnp.where(mask, w, jnp.finfo(dtype).min)
    w = jax.nn.softmax(w).astype(dtype)
    return jnp.einsum("...hqk,...khd->...qhd", w, value)


class MultiHeadDotProductAttention(Module):
    num_heads: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    qkv_features: Optional[int] = None
    out_features: Optional[int] = None

    @compact
    def __call__(self, inputs_q, inputs_k=None, inputs_v=None, *, mask=None):
        if inputs_k is None:
            inputs_k = inputs_q
        if inputs_v is None:
            inputs_v = inputs_k
        features = self.out_features or inputs_q.shape[-1]
        qkv = self.qkv_features or inputs_q.shape[-1]
        head = (self.num_heads, qkv // self.num_heads)
        proj = functools.partial(_DenseGeneral, features=head, dtype=self.dtype,
                                 param_dtype=self.param_dtype)
        q = proj(name="query")(inputs_q)
        k = proj(name="key")(inputs_k)
        v = proj(name="value")(inputs_v)
        x = dot_product_attention(q, k, v, mask=mask, dtype=self.dtype)
        return _DenseGeneral(features=(features,), in_axes=2, dtype=self.dtype,
                             param_dtype=self.param_dtype, name="out")(x)


class _DenseParams(Module):
    features: int
    use_bias: bool
    kernel_init: Callable
    param_dtype: Any = jnp.float32

    @compact
    def __call__(self, x):
        k = self.param("kernel", self.kernel_init, (x.shape[-1], self.features),
                       self.param_dtype)
        b = (self.param("bias", initializers.zeros, (self.features,), self.param_dtype)
             if self.use_bias else None)
        return k, b


class OptimizedLSTMCell(Module):
    """LSTM step ``((c, h), x) -> ((c', h'), h')`` with the per-gate kernels
    of linen's ``LSTMCell`` (``i{gate}`` on the input, ``h{gate}`` with bias
    on the state) concatenated into one product each."""

    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = _default_kernel_init
    recurrent_kernel_init: Callable = initializers.orthogonal()

    @compact
    def __call__(self, carry, inputs):
        c, h = carry
        H = h.shape[-1]
        gates = "ifgo"
        pi = [_DenseParams(H, False, self.kernel_init, self.param_dtype,
                           name=f"i{g}")(inputs) for g in gates]
        ph = [_DenseParams(H, True, self.recurrent_kernel_init, self.param_dtype,
                           name=f"h{g}")(h) for g in gates]

        def cat_dense(x, params, use_bias):
            kernel = jnp.concatenate([k for k, _ in params], axis=-1)
            bias = jnp.concatenate([b for _, b in params], axis=-1) if use_bias else None
            x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
            y = jnp.dot(x, kernel)
            if use_bias:
                y = y + bias
            return jnp.split(y, 4, axis=-1)

        dh = cat_dense(h, ph, True)
        di = cat_dense(inputs, pi, False)
        i = sigmoid(dh[0] + di[0])
        f = sigmoid(dh[1] + di[1])
        g = jnp.tanh(dh[2] + di[2])
        o = sigmoid(dh[3] + di[3])
        new_c = f * c + i * g
        new_h = o * jnp.tanh(new_c)
        return (new_c, new_h), new_h


# ---------------------------------------------------------------------------
# scan over time with shared parameters
# ---------------------------------------------------------------------------


def _scan_call(fn, module: Module, carry, xs):
    """``lax.scan`` of ``fn(module, carry, x) -> (carry, y)`` over the leading
    axis of ``xs``; every step reads the same parameters. At ``init`` the
    parameters are drawn from the first step's input first."""
    run = module._scope.run
    if run.key is not None:
        fn(module, carry, jax.tree.map(lambda a: a[0], xs))
    saved, run.key = run.key, None
    try:
        return lax.scan(lambda c, x: fn(module, c, x), carry, xs)
    finally:
        run.key = saved


def scan(target, variable_broadcast="params", split_rngs=None, in_axes=0, out_axes=0):
    """Lift a cell over time, as linen's ``nn.scan`` with broadcast params.

    ``target`` is a Module class (returns a class whose call is
    ``(carry, xs) -> (carry, ys)``) or a function ``fn(module, carry, x)``
    (returns ``run(module, carry, xs)``). Only the broadcast-parameter,
    axis-0 form is supported.
    """
    assert variable_broadcast == "params" and in_axes == 0 and out_axes == 0
    if isinstance(target, type):
        step = target.__call__

        class Scanned(target):
            def __call__(self, carry, xs):
                return _scan_call(step, self, carry, xs)

        Scanned.__name__ = target.__name__
        return Scanned
    return lambda module, carry, xs: _scan_call(target, module, carry, xs)
