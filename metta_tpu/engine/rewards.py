"""Stat-based rewards, damage, and inventory regeneration.

Parity:
- stat rewards: ``objects/agent.cpp:104-135`` — reward level = Σ stat×weight
  (capped per-stat); the *delta* vs the previous level is added to the step
  reward. Stat keys are compiled to (source, index) pairs by the compiler.
- damage: ``objects/agent.cpp:137-183`` — when every threshold resource is at
  its threshold, thresholds are deducted and one removable resource is
  destroyed, chosen with probability ∝ (amount − minimum).
- regen: ``bindings/mettagrid_c.cpp:625-640`` — every
  ``inventory_regen_interval`` steps, vibe-keyed amounts (with vibe-0
  fallback, baked into the compiled table) are applied.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metta_tpu.engine.compiler import (
    SRC_ALIGNED,
    SRC_ASM_CREATED,
    SRC_COLL_DEPOSITED,
    SRC_COLL_WITHDRAWN,
    SRC_CHEST_AMOUNT,
    SRC_CHEST_DEPOSITED,
    SRC_CHEST_DEPOSITED_BY_AGENT,
    SRC_CHEST_WITHDRAWN,
    SRC_GAINED,
    SRC_INV_AMOUNT,
    SRC_LOST,
)
from metta_tpu.engine.inventory import inv_update


def compute_stat_rewards(state, tables):
    """Add stat-reward deltas to the per-step reward; returns new state.

    The (source, resource) stat-slot lookups are static tables, expanded to
    one-hot masks so the whole computation is a masked reduction.
    """
    A = tables.num_agents
    R = tables.num_resources

    chest_amount = jnp.sum(
        jnp.where(state.chest_valid[:, None], state.chest_inv, 0), axis=0
    )  # [R]

    src = tables.stat_src      # [A, S]
    idx = tables.stat_idx      # [A, S]
    S = src.shape[1]

    table = jnp.stack([
        jnp.zeros_like(state.agent_inv),               # SRC_ZERO
        state.agent_inv,                                # SRC_INV_AMOUNT
        state.agent_gained,                             # SRC_GAINED
        state.agent_lost,                               # SRC_LOST
        jnp.broadcast_to(chest_amount, (A, R)),         # SRC_CHEST_AMOUNT
        jnp.broadcast_to(state.game_chest_deposited, (A, R)),  # SRC_CHEST_DEPOSITED
        jnp.broadcast_to(state.game_chest_withdrawn, (A, R)),  # SRC_CHEST_WITHDRAWN
        state.agent_chest_deposited,                    # SRC_CHEST_DEPOSITED_BY_AGENT
        jnp.broadcast_to(state.game_asm_created, (A, R)),      # SRC_ASM_CREATED
    ], axis=1)                                          # [A, 9, R]

    # collective stats read live via the agent's (runtime) membership
    # (agent.cpp:116: stat_value += collective->stats.get(key)); agents with
    # no collective read zeros via the one-hot miss
    NL = tables.n_collectives
    colloh = state.agent_coll[:, None] == jnp.arange(NL)[None, :]  # [A, NL]
    my_dep = jnp.sum(jnp.where(colloh[:, :, None], state.coll_deposited[None], 0), axis=1)
    my_wd = jnp.sum(jnp.where(colloh[:, :, None], state.coll_withdrawn[None], 0), axis=1)
    table = jnp.concatenate([
        table, my_dep[:, None], my_wd[:, None]
    ], axis=1)                                          # [A, 11, R] (9,10 = dep,wd)
    src_r = jnp.where(src == SRC_COLL_DEPOSITED, 9,
                      jnp.where(src == SRC_COLL_WITHDRAWN, 10, src))
    src_r = jnp.where(src == SRC_ALIGNED, 0, src_r)     # aligned handled below

    srcoh = src_r[:, :, None] == jnp.arange(11)[None, None, :]     # [A, S, 11]
    idxoh = idx[:, :, None] == jnp.arange(R)[None, None, :]        # [A, S, R]
    picked = jnp.sum(jnp.where(srcoh[:, :, :, None], table[:, None], 0), axis=2)  # [A, S, R]
    vals = jnp.sum(jnp.where(idxoh, picked, 0), axis=2).astype(jnp.float32)       # [A, S]

    # aligned.<type>: idx indexes the TYPE axis of the live member counts
    import numpy as _np

    if tables.any_stat_aligned:
        NT = tables.n_object_types
        my_aligned = jnp.sum(
            jnp.where(colloh[:, :, None], state.coll_aligned[None], 0), axis=1
        )                                               # [A, NT]
        toh = idx[:, :, None] == jnp.arange(NT)[None, None, :]     # [A, S, NT]
        aligned_vals = jnp.sum(
            jnp.where(toh, my_aligned[:, None], 0), axis=2
        ).astype(jnp.float32)
        vals = jnp.where(src == SRC_ALIGNED, aligned_vals, vals)

    contrib = jnp.minimum(vals * tables.stat_w, tables.stat_max)
    new_level = jnp.sum(contrib, axis=1)                # [A]
    delta = new_level - state.agent_current_stat_reward
    return state.replace(
        reward=state.reward + delta,
        agent_current_stat_reward=new_level,
    )


def agents_update_vec(state, tables, r, deltas, do):
    """Vectorized per-agent inventory update of resource r (independent agents)."""
    def upd(a, inv, delta, d):
        cls = tables.agent_inv_class[a]
        new_inv, actual = inv_update(tables.inv_tables, cls, inv, r, delta)
        actual = jnp.where(d, actual, 0)
        new_inv = jnp.where(d, new_inv, inv)
        return new_inv, actual

    new_invs, actuals = jax.vmap(upd)(
        jnp.arange(tables.num_agents), state.agent_inv, deltas, do
    )
    state = state.replace(agent_inv=new_invs)
    if tables.track_gained:
        gained = jnp.where(actuals > 0, actuals, 0)
        lost = jnp.where(actuals < 0, -actuals, 0)
        state = state.replace(
            agent_gained=state.agent_gained.at[:, r].add(gained),
            agent_lost=state.agent_lost.at[:, r].add(lost),
        )
    return state, actuals


def apply_regen(state, tables):
    """Vibe-keyed inventory regeneration on the configured interval."""
    interval = tables.inventory_regen_interval
    tick = (state.step % interval) == 0
    vibes = jnp.clip(state.agent_vibe, 0, tables.num_vibes - 1)
    voh = vibes[:, None] == jnp.arange(tables.num_vibes)[None, :]       # [A, V]
    amounts = jnp.sum(
        jnp.where(voh[:, :, None], tables.agent_regen, 0), axis=1
    )  # [A, R] — one-hot LUT
    do = tick & tables.agent_has_regen

    if tables.inv_vector_ok:
        from metta_tpu.engine.inventory_vec import all_agents_update_multi

        state, _ = all_agents_update_multi(
            state, tables, amounts, do[:, None] & (amounts != 0)
        )
        return state

    def body(r, st):
        st, _ = agents_update_vec(st, tables, r, amounts[:, r], do & (amounts[:, r] != 0))
        return st

    return jax.lax.fori_loop(0, tables.num_resources, body, state)


def apply_damage(state, tables, key):
    """Threshold-triggered weighted-random resource destruction (per agent)."""
    A = tables.num_agents
    R = tables.num_resources

    thr = tables.agent_damage_threshold
    thr_mask = tables.agent_damage_thresh_mask
    triggered = tables.agent_damage_enabled & jnp.all(
        ~thr_mask | (state.agent_inv >= thr), axis=1
    )  # [A]

    # subtract thresholds (sequential over r to respect shared limits)
    if tables.inv_vector_ok:
        from metta_tpu.engine.inventory_vec import all_agents_update_multi

        deltas = jnp.broadcast_to(-thr, (A, R))
        do = triggered[:, None] & thr_mask & (thr > 0)
        state, _ = all_agents_update_multi(state, tables, deltas, do)
    else:
        def sub_body(r, st):
            st, _ = agents_update_vec(
                st, tables, r, -thr[:, r], triggered & thr_mask[:, r] & (thr[:, r] > 0)
            )
            return st

        state = jax.lax.fori_loop(0, R, sub_body, state)

    # weighted pick of one removable resource per triggered agent
    removable = jnp.where(
        tables.agent_damage_res_mask,
        state.agent_inv - tables.agent_damage_res_min,
        0,
    )
    removable = jnp.maximum(removable, 0)  # [A, R]
    has_any = jnp.any(removable > 0, axis=1) & triggered
    logw = jnp.where(removable > 0, jnp.log(removable.astype(jnp.float32)), -jnp.inf)
    gumbel = jax.random.gumbel(key, (A, R))
    pick = jnp.argmax(logw + gumbel, axis=1)  # [A]

    if tables.inv_vector_ok:
        onehot = jax.nn.one_hot(pick, R, dtype=jnp.int32)  # [A, R]
        from metta_tpu.engine.inventory_vec import all_agents_update_multi

        state, _ = all_agents_update_multi(
            state, tables, -onehot, has_any[:, None] & (onehot > 0)
        )
        return state

    def destroy_body(a, st):
        r = pick[a]
        do = has_any[a]
        inv = st.agent_inv[a]
        cls = tables.agent_inv_class[a]
        new_inv, actual = inv_update(tables.inv_tables, cls, inv, r, -1)
        new_inv = jnp.where(do, new_inv, inv)
        lost = jnp.where(do & (actual < 0), -actual, 0)
        return st.replace(
            agent_inv=st.agent_inv.at[a].set(new_inv),
            agent_lost=st.agent_lost.at[a, r].add(lost),
        )

    state = jax.lax.fori_loop(0, A, destroy_body, state)
    return state
