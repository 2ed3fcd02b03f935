"""Activation-handler framework + AOE system (array-native).

Array re-design of the reference's config-driven interaction engine:

- ``ActivationHandler`` = filter chain + mutation chain applied to an
  (actor, target) pair (``cpp/include/mettagrid/actions/activation_handler.hpp``,
  ``actions/filters/filter.hpp:14-140``, ``actions/mutations/mutation.hpp:14-197``).
- ``AOEGrid`` = cell-registered area-of-effect sources with tag/alignment
  filters applied per tick to objects in Chebyshev range
  (``core/aoe_helper.hpp:14-80``, ``core/aoe_config.hpp:10-31``).

Instead of virtual Filter/Mutation objects walking a pointer graph, entities
live in a dense **EntityView** — a dict of arrays over N entities — and each
handler is a pure function ``view -> (view', applied)`` masked by the filter
outcome. Handlers vmap over (actor, target) index arrays, so a whole batch of
activations resolves in one fused program.

Entity view keys (all leading dim N):
  inv        [N, R] int32   inventories
  vibe       [N]    int32
  tags       [N, T] int32   (-1 padding)
  collective [N]    int32   (-1 = unaligned)
  frozen     [N]    int32   (remaining frozen ticks)
  pos        [N, 2] int32   (row, col) — used by AOE
"""

from __future__ import annotations

from typing import List, Literal, Optional, Union

import jax
import jax.numpy as jnp
from pydantic import Field

from metta_tpu.config.base import Config

EntityRef = Literal["actor", "target"]

CLEAR_ALL = 255  # sentinel resource id: clear the whole inventory


# ---------------------------------------------------------------------------
# Filter configs (parity: activation_handler_config.hpp:38-59)
# ---------------------------------------------------------------------------


class VibeFilter(Config):
    type: Literal["vibe"] = "vibe"
    entity: EntityRef = "target"
    vibe_id: int = 0


class ResourceFilter(Config):
    type: Literal["resource"] = "resource"
    entity: EntityRef = "target"
    resource_id: int = 0
    min_amount: int = 1


class AlignmentFilter(Config):
    type: Literal["alignment"] = "alignment"
    condition: Literal["aligned", "unaligned", "same_collective",
                       "different_collective"] = "same_collective"


class TagFilter(Config):
    type: Literal["tag"] = "tag"
    entity: EntityRef = "target"
    required_tag_ids: List[int] = Field(default_factory=list)


FilterConfig = Union[VibeFilter, ResourceFilter, AlignmentFilter, TagFilter]


# ---------------------------------------------------------------------------
# Mutation configs (parity: activation_handler_config.hpp:63-103)
# ---------------------------------------------------------------------------


class ResourceDeltaMutation(Config):
    type: Literal["resource_delta"] = "resource_delta"
    entity: EntityRef = "target"
    resource_id: int = 0
    delta: int = 0


class ResourceTransferMutation(Config):
    type: Literal["resource_transfer"] = "resource_transfer"
    source: EntityRef = "actor"
    destination: EntityRef = "target"
    resource_id: int = 0
    amount: int = -1  # -1 = transfer all available


class AlignmentMutation(Config):
    type: Literal["alignment"] = "alignment"
    align_to: Literal["actor_collective", "none"] = "actor_collective"


class FreezeMutation(Config):
    type: Literal["freeze"] = "freeze"
    duration: int = 1


class ClearInventoryMutation(Config):
    type: Literal["clear_inventory"] = "clear_inventory"
    entity: EntityRef = "target"
    resource_id: int = CLEAR_ALL


class AttackMutation(Config):
    type: Literal["attack"] = "attack"
    weapon_resource: int = 0
    armor_resource: int = 0
    health_resource: int = 0
    damage_multiplier: float = 1.0


MutationConfig = Union[
    ResourceDeltaMutation, ResourceTransferMutation, AlignmentMutation,
    FreezeMutation, ClearInventoryMutation, AttackMutation,
]


class ActivationHandlerConfig(Config):
    """All filters must pass; mutations apply sequentially if they do
    (parity: activation_handler.hpp:25-50)."""

    name: str = ""
    filters: List[FilterConfig] = Field(default_factory=list)
    mutations: List[MutationConfig] = Field(default_factory=list)


# ---------------------------------------------------------------------------
# Entity view helpers
# ---------------------------------------------------------------------------


def make_view(n: int, n_resources: int, max_tags: int = 4) -> dict:
    return {
        "inv": jnp.zeros((n, n_resources), jnp.int32),
        "vibe": jnp.zeros((n,), jnp.int32),
        "tags": jnp.full((n, max_tags), -1, jnp.int32),
        "collective": jnp.full((n,), -1, jnp.int32),
        "frozen": jnp.zeros((n,), jnp.int32),
        "pos": jnp.zeros((n, 2), jnp.int32),
    }


def _resolve(view, actor, target, ref: str):
    return actor if ref == "actor" else target


def _inv_update(view, idx, resource, delta, inv_max: int = 255):
    """Clamped inventory update (parity: inventory.cpp:37-92 clamp to
    [0, limit]); returns (view', applied_delta)."""
    cur = view["inv"][idx, resource]
    new = jnp.clip(cur + delta, 0, inv_max)
    view = dict(view)
    view["inv"] = view["inv"].at[idx, resource].set(new)
    return view, new - cur


# ---------------------------------------------------------------------------
# Compiled handler
# ---------------------------------------------------------------------------


class ActivationHandler:
    """Pure-function activation handler over an entity view.

    ``try_apply(view, actor, target) -> (view', applied)`` with scalar int
    indices (vmap-able). ``check_filters`` evaluates the chain alone.
    """

    def __init__(self, cfg: ActivationHandlerConfig, inv_max: int = 255):
        self.cfg = cfg
        self.inv_max = inv_max
        self.name = cfg.name

    # -- filters --

    def check_filters(self, view, actor, target):
        ok = jnp.bool_(True)
        for f in self.cfg.filters:
            if f.type == "vibe":
                e = _resolve(view, actor, target, f.entity)
                ok = ok & (view["vibe"][e] == f.vibe_id)
            elif f.type == "resource":
                e = _resolve(view, actor, target, f.entity)
                ok = ok & (view["inv"][e, f.resource_id] >= f.min_amount)
            elif f.type == "alignment":
                a = view["collective"][actor]
                t = view["collective"][target]
                if f.condition == "aligned":
                    ok = ok & (a >= 0) & (t >= 0)
                elif f.condition == "unaligned":
                    ok = ok & ((a < 0) | (t < 0))
                elif f.condition == "same_collective":
                    ok = ok & (a >= 0) & (a == t)
                else:  # different_collective
                    ok = ok & (a >= 0) & (t >= 0) & (a != t)
            elif f.type == "tag":
                if f.required_tag_ids:
                    e = _resolve(view, actor, target, f.entity)
                    tags = view["tags"][e]
                    req = jnp.asarray(f.required_tag_ids, jnp.int32)
                    ok = ok & jnp.any(tags[:, None] == req[None, :])
        return ok

    # -- mutations --

    def _apply_mutations(self, view, actor, target):
        for m in self.cfg.mutations:
            if m.type == "resource_delta":
                e = _resolve(view, actor, target, m.entity)
                view, _ = _inv_update(view, e, m.resource_id, m.delta, self.inv_max)
            elif m.type == "resource_transfer":
                s = _resolve(view, actor, target, m.source)
                d = _resolve(view, actor, target, m.destination)
                avail = view["inv"][s, m.resource_id]
                want = avail if m.amount < 0 else jnp.minimum(
                    jnp.int32(m.amount), avail)
                # capped by destination headroom (transfer_resources,
                # has_inventory.cpp:76+, destroy=false)
                room = self.inv_max - view["inv"][d, m.resource_id]
                moved = jnp.minimum(want, room)
                view = dict(view)
                view["inv"] = (view["inv"]
                               .at[s, m.resource_id].add(-moved)
                               .at[d, m.resource_id].add(moved))
            elif m.type == "alignment":
                view = dict(view)
                if m.align_to == "actor_collective":
                    a_coll = view["collective"][actor]
                    new = jnp.where(a_coll >= 0, a_coll,
                                    view["collective"][target])
                    view["collective"] = view["collective"].at[target].set(new)
                else:
                    view["collective"] = view["collective"].at[target].set(-1)
            elif m.type == "freeze":
                view = dict(view)
                view["frozen"] = view["frozen"].at[target].set(m.duration)
            elif m.type == "clear_inventory":
                e = _resolve(view, actor, target, m.entity)
                view = dict(view)
                if m.resource_id == CLEAR_ALL:
                    view["inv"] = view["inv"].at[e].set(0)
                else:
                    view["inv"] = view["inv"].at[e, m.resource_id].set(0)
            elif m.type == "attack":
                weapon = view["inv"][actor, m.weapon_resource].astype(jnp.float32)
                armor = view["inv"][target, m.armor_resource].astype(jnp.float32)
                damage = jnp.maximum(0.0, weapon * m.damage_multiplier - armor)
                view, _ = _inv_update(view, target, m.health_resource,
                                      -damage.astype(jnp.int32), self.inv_max)
        return view

    def try_apply(self, view, actor, target):
        """Returns (view', applied). Mutations are computed then masked by the
        filter outcome, keeping the function jit/vmap-safe."""
        actor = jnp.asarray(actor, jnp.int32)
        target = jnp.asarray(target, jnp.int32)
        ok = self.check_filters(view, actor, target)
        mutated = self._apply_mutations(view, actor, target)
        merged = jax.tree.map(
            lambda new, old: jnp.where(ok, new, old) if new.dtype != jnp.bool_
            else jnp.where(ok, new, old),
            mutated, view)
        return merged, ok


# ---------------------------------------------------------------------------
# AOE (parity: core/aoe_helper.hpp + core/aoe_config.hpp)
# ---------------------------------------------------------------------------


class AOEResourceDelta(Config):
    resource_id: int = 0
    delta: int = 0


class AOEConfig(Config):
    radius: int = 0  # Chebyshev (L-inf) distance
    deltas: List[AOEResourceDelta] = Field(default_factory=list)
    target_tag_ids: List[int] = Field(default_factory=list)
    alignment_filter: Literal["any", "same_collective",
                              "different_collective"] = "any"


class AOEGrid:
    """Dense AOE source table: effects applied per tick to every entity within
    each source's Chebyshev radius, filtered by tags/alignment.

    The reference registers effects into per-cell hash maps
    (``aoe_helper.hpp:36-78``); with array state the [N, S] distance test is
    the natural (and O(1)-dispatch) equivalent.
    """

    def __init__(self, n_resources: int, max_tags: int = 4, inv_max: int = 255):
        self.n_resources = n_resources
        self.max_tags = max_tags
        self.inv_max = inv_max
        self._pos: List = []       # source positions (entity index binding)
        self._cfgs: List[AOEConfig] = []

    def register_source(self, source_entity: int, cfg: AOEConfig):
        self._pos.append(source_entity)
        self._cfgs.append(cfg)

    def unregister_source(self, source_entity: int):
        for i, e in enumerate(self._pos):
            if e == source_entity:
                del self._pos[i]
                del self._cfgs[i]
                return

    def compile(self):
        """Bake sources into dense arrays: returns a dict of tables."""
        S = len(self._cfgs)
        R, T = self.n_resources, self.max_tags
        import numpy as np

        tab = {
            "src": np.asarray(self._pos or [0], np.int32)[:max(S, 1)],
            "radius": np.zeros((max(S, 1),), np.int32),
            "deltas": np.zeros((max(S, 1), R), np.int32),
            "tags": np.full((max(S, 1), T), -1, np.int32),
            "align": np.zeros((max(S, 1),), np.int32),  # 0 any, 1 same, 2 diff
            "n": S,
        }
        for i, cfg in enumerate(self._cfgs):
            tab["radius"][i] = cfg.radius
            for d in cfg.deltas:
                tab["deltas"][i, d.resource_id] += d.delta
            for j, t in enumerate(cfg.target_tag_ids[:T]):
                tab["tags"][i, j] = t
            tab["align"][i] = {"any": 0, "same_collective": 1,
                               "different_collective": 2}[cfg.alignment_filter]
        return {k: (jnp.asarray(v) if k != "n" else v) for k, v in tab.items()}

    def apply_effects(self, view, tables=None):
        """One tick: apply every source's deltas to every in-range, filtered
        entity (parity: apply_effects_at called per object per tick). Sources
        do not affect themselves (the reference skips the source object)."""
        tab = tables if tables is not None else self.compile()
        if tab["n"] == 0:
            return view
        src = tab["src"]                                 # [S]
        src_pos = view["pos"][src]                       # [S, 2]
        d = jnp.max(jnp.abs(view["pos"][:, None, :] - src_pos[None, :, :]),
                    axis=-1)                             # [N, S]
        in_range = d <= tab["radius"][None, :]
        n = view["pos"].shape[0]
        not_self = jnp.arange(n)[:, None] != src[None, :]

        # tag filter: empty (all -1) passes everything
        has_req = jnp.any(tab["tags"] >= 0, axis=-1)     # [S]
        eq = (view["tags"][:, None, :, None] == tab["tags"][None, :, None, :])
        eq = eq & (tab["tags"][None, :, None, :] >= 0)   # ignore -1 padding
        tag_match = jnp.any(eq, axis=(-1, -2))           # [N, S]
        tag_ok = jnp.where(has_req[None, :], tag_match, True)

        # alignment filter
        src_coll = view["collective"][src]               # [S]
        tgt_coll = view["collective"][:, None]           # [N, 1]
        same = (src_coll[None, :] >= 0) & (tgt_coll == src_coll[None, :])
        diff = (src_coll[None, :] >= 0) & (tgt_coll >= 0) & (tgt_coll != src_coll[None, :])
        align_ok = jnp.where(tab["align"][None, :] == 0, True,
                             jnp.where(tab["align"][None, :] == 1, same, diff))

        mask = (in_range & not_self & tag_ok & align_ok).astype(jnp.int32)
        total = mask @ tab["deltas"]                     # [N, R]
        view = dict(view)
        view["inv"] = jnp.clip(view["inv"] + total, 0, self.inv_max)
        return view
