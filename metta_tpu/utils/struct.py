"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass whose fields are all pytree
children, registered with ``jax.tree_util.register_dataclass``, and gives it
``.replace(**changes)``. It is the subset of ``flax.struct`` this repository
uses.
"""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = dataclasses.replace
    return cls
