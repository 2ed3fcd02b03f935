"""Device-side view of a CompiledConfig.

``Tables`` mirrors every field of :class:`CompiledConfig`, with numpy arrays
converted to ``jnp`` device arrays. Static Python ints/bools stay plain so
they drive trace-time specialization (whole subsystems vanish from the HLO
when a config doesn't use them).

``Tables`` is a registered pytree: the arrays are leaves, everything static
is aux data. That means a ``Tables`` can be passed as a *runtime argument*
to a jitted function — two tasks whose configs share shapes and static
gates (same map size, agent count, subsystem usage) reuse one compiled
program with different table values. This is what lets curriculum task
swaps happen without recompiles (reference ``CurriculumEnv`` swaps tasks
per env per episode: ``cogworks/curriculum/curriculum_env.py``), and what
lets a whole task *set* be stacked along a leading axis and indexed per
env (see ``engine/taskset.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from metta_tpu.engine.compiler import CompiledConfig
from metta_tpu.engine import compiler as _C


def _freeze(v):
    """Host metadata → hashable aux representation."""
    if isinstance(v, dict):
        return ("__dict__",) + tuple(sorted(v.items()))
    if isinstance(v, list):
        return ("__list__",) + tuple(v)
    return v


def _thaw(v):
    if isinstance(v, tuple) and v and v[0] == "__dict__":
        return dict(v[1:])
    if isinstance(v, tuple) and v and v[0] == "__list__":
        return list(v[1:])
    return v


class Tables:
    """CompiledConfig with arrays on device. Attribute-compatible.

    ``track_stats=False`` drops the gained/lost/chest stat accumulators from
    the hot loop when no compiled stat reward reads them — they are reporting-
    only then (training envs turn them off; eval envs keep them).
    """

    def __init__(self, cfg: CompiledConfig, track_stats: bool = True):
        self._cfg = cfg

        used_srcs = set(np.unique(cfg.stat_src))
        self.track_gained = track_stats or bool(
            used_srcs & {_C.SRC_GAINED, _C.SRC_LOST}
        )
        self.track_chest_stats = track_stats or bool(
            used_srcs & {
                _C.SRC_CHEST_DEPOSITED, _C.SRC_CHEST_WITHDRAWN,
                _C.SRC_CHEST_DEPOSITED_BY_AGENT, _C.SRC_ASM_CREATED,
            }
        )
        array_names = []
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, np.ndarray):
                v = jnp.asarray(v)
                array_names.append(f.name)
            setattr(self, f.name, v)
        # [C, R]: is resource r a limit modifier for any group of class c?
        self.inv_is_modifier = jnp.asarray((cfg.inv_group_mod != 0).any(axis=1))
        array_names.append("inv_is_modifier")
        self._array_names = tuple(array_names)

        # --- trace-time statics (compile-gate whole subsystems) ---
        self.has_assemblers = bool(np.any(cfg.type_kind == 3))
        self.has_chests = bool(np.any(cfg.type_kind == 4))
        self.has_attack = bool(cfg.attack_vibe_mask.any())
        self.has_transfer = bool(cfg.transfer_vibe_mask.any())
        self.has_damage = bool(cfg.agent_damage_enabled.any())
        self.has_regen = cfg.inventory_regen_interval > 0 and bool(
            cfg.agent_has_regen.any()
        )
        self.has_mods = bool(cfg.inv_class_has_mods.any())
        self.has_swap = self.has_attack or bool(
            (cfg.agent_freeze_duration != 0).any()
        )
        self.loot_ids = tuple(int(r) for r in cfg.attack_loot_ids)
        self.any_attack_delta = bool(
            (cfg.attack_actor_delta != 0).any() or (cfg.attack_target_delta != 0).any()
        )
        self.any_attack_consumed = bool((cfg.attack_consumed != 0).any())
        self.any_action_consumed = bool((cfg.action_consumed != 0).any())
        self.any_allow_partial = bool(cfg.type_allow_partial.any())
        self.any_stat_aligned = bool((cfg.stat_src == _C.SRC_ALIGNED).any())
        self.has_aoe = bool(cfg.aoe_valid.any())
        self.has_bump_handlers = bool(len(cfg.on_bump_handlers))
        # resources any assembler protocol touches — the batched assembler
        # phase restricts its [K, 8, R] shared-update machinery to these
        used_r = (
            (np.abs(cfg.proto_in).sum(0) + np.abs(cfg.proto_out).sum(0)
             + np.abs(cfg.uproto_in).sum(0) + np.abs(cfg.uproto_out).sum(0)) > 0
        )
        self.proto_res = tuple(int(i) for i in np.flatnonzero(used_r)) or (0,)

        # Fast-path gate: multi-resource inventory updates are exactly
        # order-independent when every limit group is a single resource and
        # there are no limit modifiers. (Shared groups / modifiers couple
        # resources, so those configs use the sequential per-item path.)
        singleton = True
        for c in range(cfg.inv_res_group.shape[0]):
            groups, counts = np.unique(cfg.inv_res_group[c], return_counts=True)
            if (counts > 1).any():
                singleton = False
        self.inv_vector_ok = singleton and not bool(cfg.inv_group_mod.any())

    # ------------------------------------------------------------------
    # pytree protocol: arrays = children, statics = aux
    # ------------------------------------------------------------------

    _STATIC_NAMES = (
        "track_gained", "track_chest_stats",
        "has_assemblers", "has_chests", "has_attack", "has_transfer",
        "has_damage", "has_regen", "has_mods", "has_swap",
        "loot_ids", "any_attack_delta", "any_attack_consumed",
        "any_action_consumed", "any_allow_partial", "any_stat_aligned",
        "inv_vector_ok", "proto_res", "has_aoe", "has_bump_handlers",
    )

    def tree_flatten(self):
        children = tuple(getattr(self, n) for n in self._array_names)
        statics = tuple(
            (f.name, _freeze(getattr(self, f.name)))
            for f in dataclasses.fields(CompiledConfig)
            if f.name not in self._array_names
        )
        derived = tuple((n, getattr(self, n)) for n in self._STATIC_NAMES)
        return children, (self._array_names, statics, derived)

    @classmethod
    def tree_unflatten(cls, aux, children):
        array_names, statics, derived = aux
        obj = object.__new__(cls)
        obj._cfg = None  # host-side config not carried through traces
        obj._array_names = array_names
        for n, v in zip(array_names, children):
            setattr(obj, n, v)
        for n, v in statics:
            setattr(obj, n, _thaw(v))
        for n, v in derived:
            setattr(obj, n, v)
        return obj

    @property
    def inv_tables(self):
        """(res_group, group_base, group_mod) triple for inventory ops."""
        return (self.inv_res_group, self.inv_group_base, self.inv_group_mod)


jax.tree_util.register_pytree_node(
    Tables,
    lambda t: t.tree_flatten(),
    Tables.tree_unflatten,
)
