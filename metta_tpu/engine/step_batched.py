"""Batched (vectorized-over-agents) environment step — the performance path.

The reference (and our default ``step_env``) processes agents strictly
sequentially in a per-step random order (``mettagrid_c.cpp:591-622``); under
SIMD that costs A sequential iterations of masked vector ops. This module
resolves all agents simultaneously with rank-based conflict arbitration:
the per-step random permutation becomes a priority *rank*, and every conflict
(contested cell, contested attack target, contested station) is won by the
lowest-rank agent — the same agent that would have acted first sequentially.

Exactness notes (vs the sequential step; all divergences are confined to
multi-agent conflicts within a single step, whose resolution the reference
itself randomizes per step):
- chained moves (A into a cell B vacates) resolve over up to 4 arbitration
  rounds, honoring rank order (a mover blocked by a *later*-rank occupant
  fails, as it would sequentially);
- vibe changes apply before interactions (sequentially, earlier movers would
  see some targets' old vibes);
- attacks/transfers/swaps/station-uses are evaluated against pre-step
  positions and frozen flags; at most one winner per target/station (with
  cooldown > 0 stations this matches the sequential outcome exactly);
  losers and invalid attempts fall through to the next interaction exactly
  as the reference's move handler does (move.hpp:103-139: failed try_attack/
  try_transfer → swap-with-frozen → onUse), with the swap seeing post-attack
  freeze flags — the outcome a sequential order with attackers first produces
  (tests/test_batched_parity_enum.py pins the envelope property);
- simultaneous station uses consume from pre-step inventories; if two stations
  share a contributor the scatter-add result is clamped at zero (rare).

Requires ``tables.inv_vector_ok`` (singleton limit groups — true for
arena/combat/cogames configs); falls back to the sequential step otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metta_tpu.engine.clipper import clipper_step
from metta_tpu.engine.compiler import ACT_CHANGE_VIBE, ACT_MOVE, ACT_NOOP
from metta_tpu.engine.inventory import trunc_div
from metta_tpu.engine.obs import render_observations
from metta_tpu.engine.rewards import apply_damage, apply_regen, compute_stat_rewards
from metta_tpu.engine.state import KIND_ASSEMBLER, KIND_CHEST
from metta_tpu.engine.protocols import select_protocol, select_unclip_protocol

_NEIGHBOR_OFFS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _row_limits_all(tables):
    """[A, R] per-resource limits for every agent (singleton groups)."""
    res_group, group_base, _ = tables.inv_tables
    cls = tables.agent_inv_class                       # [A]
    return jnp.clip(
        jnp.take_along_axis(group_base[cls], res_group[cls], axis=1), 0, 65535
    )


def _track_agent_inv(state, tables, old_inv):
    """Accumulate gained/lost from the net inventory change since ``old_inv``.

    The sequential path counts every individual clamped update
    (``refs.py:agent_inv_write``; reference ``agent.cpp:70-83``); the batched
    phases apply one combined delta per phase, so gained/lost here are the
    per-phase net. The two differ only when a single phase both adds and
    removes the same (agent, resource) — e.g. an attacker stealing the same
    resource its attack consumes — which nets out; all reward-driving flows
    (crafting output, chest deposits, loot, regen) are single-signed per phase.
    """
    if not tables.track_gained:
        return state
    d = state.agent_inv - old_inv
    return state.replace(
        agent_gained=state.agent_gained + jnp.maximum(d, 0),
        agent_lost=state.agent_lost + jnp.maximum(-d, 0),
    )


def step_env_batched_sim(state, actions, tables):
    """Simulation-only batched step (no observation render); obs is a [1,1,3]
    placeholder. Used by profiling tools to decompose step cost."""
    return step_env_batched(state, actions, tables, render=False)


def _ohdot(oh, x):
    """Exact integer one-hot contraction ``oh @ x`` as one matmul.

    f32 accumulation is exact for the magnitudes here (< 2^24); under vmap
    this stays one batched GEMM, while the equivalent where+sum materializes
    a [..., N, M] intermediate per env (HBM-bound at E=4096).
    """
    out = jax.lax.dot_general(
        oh.astype(jnp.float32), x.astype(jnp.float32),
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out.astype(x.dtype)


def _lut(table, idx, n):
    """Gather-free lookup ``table[idx]`` via one-hot matmul (idx [A], n rows).

    For the small decode/config tables here (actions, vibes, types) a
    one-hot GEMM is branch-free vector code.
    """
    oh = idx[:, None] == jnp.arange(n)[None, :]
    if table.ndim == 1:
        return _ohdot(oh, table[:, None])[:, 0]
    return _ohdot(oh, table)


def _lut_bool(table, idx, n):
    oh = idx[:, None] == jnp.arange(n)[None, :]
    return jnp.any(oh & table[None, :], axis=1)


def _read_cells(plane_hw, r, c):
    """Gather-free grid read ``plane_hw[r, c]`` for index vectors r, c.

    One-hot row matmul + masked column reduce; exact for integer planes
    (values < 2^24 accumulate exactly in f32).
    """
    H, W = plane_hw.shape
    roh = (r[:, None] == jnp.arange(H)[None, :]).astype(jnp.float32)
    coh = c[:, None] == jnp.arange(W)[None, :]
    tmp = jax.lax.dot_general(
        roh, plane_hw.astype(jnp.float32),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
    )                                                   # [N, W]
    return jnp.sum(jnp.where(coh, tmp, 0.0), axis=1).astype(plane_hw.dtype)


from metta_tpu.engine.xprec import exact_matmuls


@exact_matmuls
def step_env_batched(state, actions, tables, render=True, perm=None):
    """One batched-arbitration step. Same signature/returns as step_env.

    ``perm`` (optional [A] int32) overrides the per-step random agent order —
    the rank-arbitration priority — for differential tests against the
    sequential step run with the same injected order."""
    A = tables.num_agents
    R = tables.num_resources
    H, W = tables.height, tables.width

    key, k_perm, k_damage, k_clip = jax.random.split(state.key, 4)
    state = state.replace(
        key=key,
        step=state.step + 1,
        reward=jnp.zeros_like(state.reward),
    )

    if perm is None:
        perm = jax.random.permutation(k_perm, A)
    rank = jnp.argsort(perm)                            # rank[a] = position in order

    # ---------- decode (one-hot LUTs; see _lut) ----------
    act_ok = (actions >= 0) & (actions < tables.n_actions)
    act = jnp.clip(actions, 0, tables.n_actions - 1)
    NACT = tables.n_actions
    kind = _lut(tables.action_kind, act, NACT)
    arg = _lut(tables.action_arg, act, NACT)
    frozen = state.agent_frozen
    is_frozen = frozen != 0
    state = state.replace(
        agent_frozen=jnp.where(act_ok & is_frozen & (frozen > 0), frozen - 1, frozen)
    )
    has_required = jnp.all(
        state.agent_inv >= _lut(tables.action_required, act, NACT), axis=1
    )
    attempt = act_ok & ~is_frozen & has_required

    success = attempt & (kind == ACT_NOOP)

    # ---------- change_vibe (conflict-free) ----------
    cv = attempt & (kind == ACT_CHANGE_VIBE)
    state = state.replace(agent_vibe=jnp.where(cv, arg, state.agent_vibe))
    success = success | cv

    # ---------- movement proposals ----------
    movers = attempt & (kind == ACT_MOVE)
    delta = _lut(tables.move_deltas, jnp.clip(arg, 0, 7), 8)  # [A, 2]
    r0, c0 = state.agent_r, state.agent_c
    r1 = r0 + delta[:, 0]
    c1 = c0 + delta[:, 1]
    in_b = (r1 >= 0) & (r1 < H) & (c1 >= 0) & (c1 < W)
    movers = movers & in_b
    rs, cs = jnp.clip(r1, 0, H - 1), jnp.clip(c1, 0, W - 1)
    # pack (kind, idx) into one plane so the one-hot grid read runs once
    packed = state.static_kind.astype(jnp.int32) * 65536 + state.static_idx
    pk = _read_cells(packed, rs, cs)
    skind = jnp.where(movers, pk // 65536, 0)
    sidx = pk % 65536

    # pre-step occupancy: target agent (if any)
    tgt_match = (r1[:, None] == r0[None, :]) & (c1[:, None] == c0[None, :])  # [A, A]
    tgt_match = tgt_match & movers[:, None]
    has_tgt_agent = jnp.any(tgt_match, axis=1)
    tgt_agent = jnp.argmax(tgt_match, axis=1)           # valid where has_tgt_agent

    vibe = jnp.clip(state.agent_vibe, 0, tables.num_vibes - 1)
    lims = _row_limits_all(tables)                      # [A, R]

    # a → target one-hot [A(actor), A(target)]; the basis for every per-target
    # reduction below. (All target-indexed ops are expressed as masked
    # [A, A] reductions or one-hot sums instead of scatters/gathers — see
    # `_sum_to_targets`.)
    tgt_oh = (tgt_agent[:, None] == jnp.arange(A)[None, :]) & has_tgt_agent[:, None]

    def from_targets(x):
        """x[t] per-target → value at each actor's target (one-hot GEMM;
        avoids the [A, A, R] where+sum intermediate, which HBM-binds at
        E=4096)."""
        if x.ndim == 1:
            return _ohdot(tgt_oh, x[:, None])[:, 0]
        return _ohdot(tgt_oh, x)

    def sum_to_targets(vals, mask):
        """Σ over actors a with mask[a] of vals[a] into their target slot."""
        moh = (tgt_oh & mask[:, None]).T                   # [A(target), A(actor)]
        if vals.ndim == 1:
            return _ohdot(moh, vals[:, None])[:, 0]
        return _ohdot(moh, vals)

    def winner_per_target(cands):
        """cands [A] bool, target = tgt_agent; lowest rank per target wins."""
        score = jnp.where(cands, rank, A + 1)
        same_tgt = (tgt_agent[:, None] == tgt_agent[None, :])
        best = jnp.min(
            jnp.where(same_tgt & cands[None, :], score[None, :], A + 1), axis=1
        )
        return cands & (score == best)

    # ---------- vibe-triggered attacks ----------
    if tables.has_attack:
        wants_attack = (
            movers & _lut_bool(tables.attack_vibe_mask, vibe, tables.num_vibes)
            & has_tgt_agent
        )
        afford = jnp.all(state.agent_inv >= tables.attack_consumed, axis=1)
        valid = wants_attack & (from_targets(state.agent_frozen) <= 0) & afford
        valid = winner_per_target(valid)

        weapon = state.agent_inv @ tables.attack_weapon_w               # [A]
        t_vibe = from_targets(vibe)
        voh_t = t_vibe[:, None] == jnp.arange(tables.num_vibes)[None, :]  # [A, V]
        vibing = _ohdot(voh_t, tables.vibe_matches_resource)             # [A, R]
        vibe_bonus = _ohdot(voh_t, tables.attack_vibe_bonus[:, None])[:, 0]
        inv_t = from_targets(state.agent_inv)                            # [A, R]
        armor_amounts = inv_t + jnp.where(vibing, vibe_bonus[:, None], 0)
        armor = jnp.sum(armor_amounts * tables.attack_armor_w, axis=1)
        bonus = jnp.maximum(weapon - armor, 0)

        if tables.attack_defense_any:
            required = tables.attack_defense[None, :] + bonus[:, None]  # [A, R]
            can_defend = jnp.all(
                ~tables.attack_defense_mask | (inv_t >= required), axis=1
            )
            blocked = valid & can_defend
            pay = jnp.where(tables.attack_defense_mask, -required, 0)
            d_target = sum_to_targets(pay.astype(jnp.int32), blocked)
            old_inv = state.agent_inv
            new_inv = jnp.clip(old_inv + d_target, 0, lims)
            state = state.replace(agent_inv=new_inv)
            if tables.track_gained:
                state = state.replace(
                    agent_lost=state.agent_lost + jnp.maximum(old_inv - new_inv, 0)
                )
        else:
            blocked = jnp.zeros((A,), bool)

        hit = valid & ~blocked
        if tables.attack_freeze > 0:
            state = state.replace(
                agent_frozen=state.agent_frozen + sum_to_targets(
                    jnp.full((A,), jnp.int32(tables.attack_freeze)), hit
                )
            )
        # actor/target deltas + loot + consume, one-hot sums with final clamp
        d = jnp.where(hit[:, None], tables.attack_actor_delta[None, :], 0)
        d = d + sum_to_targets(
            jnp.broadcast_to(tables.attack_target_delta[None, :], (A, R)), hit
        )
        inv_t_now = from_targets(state.agent_inv)
        for r_loot in tables.loot_ids:
            amount = inv_t_now[:, r_loot]
            space = jnp.maximum(lims[:, r_loot] - state.agent_inv[:, r_loot], 0)
            stolen = jnp.where(hit, jnp.minimum(amount, space), 0)
            r_oh = jnp.arange(R)[None, :] == r_loot
            d = d + jnp.where(r_oh, stolen[:, None], 0)
            d = d - jnp.where(r_oh, sum_to_targets(stolen, hit)[:, None], 0)
        d = d - jnp.where(valid[:, None], tables.attack_consumed[None, :], 0)
        old_inv = state.agent_inv
        state = state.replace(agent_inv=jnp.clip(old_inv + d, 0, lims))
        state = _track_agent_inv(state, tables, old_inv)
        success = success | valid
        # only RESOLVED attacks (winner, affordable, unfrozen target) handle
        # the move; failed try_attack falls through to swap/onUse, as in the
        # reference (move.hpp:103-139: try_attack false → later branches)
        handled_attack = valid
    else:
        handled_attack = jnp.zeros((A,), bool)

    # ---------- vibe-triggered transfers ----------
    if tables.has_transfer:
        wants_tr = (
            movers & ~handled_attack
            & _lut_bool(tables.transfer_vibe_mask, vibe, tables.num_vibes)
            & has_tgt_agent
        )
        voh = vibe[:, None] == jnp.arange(tables.num_vibes)[None, :]     # [A, V]
        d_actor = _ohdot(voh, tables.transfer_actor_delta)               # [A, R]
        d_target = _ohdot(voh, tables.transfer_target_delta)
        req_ok = jnp.all(state.agent_inv >= tables.transfer_required, axis=1)
        valid = wants_tr & (from_targets(state.agent_frozen) <= 0) & req_ok
        valid = winner_per_target(valid)
        free_a = jnp.maximum(lims - state.agent_inv, 0)
        free_t = from_targets(free_a)
        inv_t = from_targets(state.agent_inv)
        ok = valid
        ok = ok & jnp.all((d_actor >= 0) | (state.agent_inv >= -d_actor), axis=1)
        ok = ok & jnp.all((d_target >= 0) | (inv_t >= -d_target), axis=1)
        ok = ok & jnp.all((d_actor <= 0) | (d_actor <= free_a), axis=1)
        ok = ok & jnp.all((d_target <= 0) | (d_target <= free_t), axis=1)
        d = jnp.where(ok[:, None], d_actor, 0)
        d = d + sum_to_targets(d_target, ok)
        old_inv = state.agent_inv
        state = state.replace(agent_inv=jnp.clip(old_inv + d, 0, lims))
        state = _track_agent_inv(state, tables, old_inv)
        success = success | ok
        # failed try_transfer falls through like a failed try_attack
        handled_tr = ok
    else:
        handled_tr = jnp.zeros((A,), bool)

    # ---------- config-driven bump handlers (before the frozen swap, so a
    # handler targeting frozen agents wins — engine/activation_wiring.py) ----
    if tables.has_bump_handlers:
        from metta_tpu.engine.activation_wiring import bump_handlers_batched

        cand_bh = movers & ~handled_attack & ~handled_tr & has_tgt_agent
        handled_bh, bh_success, state = bump_handlers_batched(
            state, tables, cand_bh, tgt_agent, tgt_oh, rank, lims
        )
        success = success | bh_success
    else:
        handled_bh = jnp.zeros((A,), bool)

    # ---------- swaps with frozen agents ----------
    handled_station = jnp.zeros((A,), bool)
    if tables.has_swap:
        wants_swap = (
            movers & ~handled_attack & ~handled_tr & ~handled_bh & has_tgt_agent
            & (from_targets(state.agent_frozen) > 0)
        )
        swap_ok = winner_per_target(wants_swap)
        # positions exchange (disjoint pairs: each winner targets a distinct
        # frozen agent; a frozen agent never moves itself this step)
        swapped_in = jnp.any(tgt_oh & swap_ok[:, None], axis=0)   # [A] targets
        new_r = jnp.where(swap_ok, from_targets(state.agent_r), state.agent_r)
        new_c = jnp.where(swap_ok, from_targets(state.agent_c), state.agent_c)
        new_r = jnp.where(swapped_in, sum_to_targets(r0, swap_ok), new_r)
        new_c = jnp.where(swapped_in, sum_to_targets(c0, swap_ok), new_c)
        state = state.replace(agent_r=new_r, agent_c=new_c)
        success = success | swap_ok
        handled_station = handled_station | wants_swap

    interacted = handled_attack | handled_tr | handled_bh | handled_station

    # ---------- plain moves: rank-arbitrated rounds ----------
    # (movers whose pre-step target held an agent participate too: the rounds
    # let them follow an earlier-rank agent out of the cell, as sequentially)
    plain = movers & ~interacted & (skind == 0)
    unresolved = plain
    moved = jnp.zeros((A,), bool)
    cell = rs * W + cs
    same_cell = cell[:, None] == cell[None, :]          # [A, A] target contention
    for _round in range(4):
        # occupancy from current positions (masked [A, A] reductions in
        # place of a per-cell scatter-min)
        occ = (r1[:, None] == state.agent_r[None, :]) & (c1[:, None] == state.agent_c[None, :])
        occ = occ & (jnp.arange(A)[:, None] != jnp.arange(A)[None, :])
        occ_any = jnp.any(occ, axis=1)
        # fail if blocked by a later-rank agent or by one that already resolved
        blocker_later = jnp.any(occ & (rank[None, :] > rank[:, None]), axis=1)
        blocker_stuck = jnp.any(occ & ~unresolved[None, :] & ~moved[None, :], axis=1)
        fail_now = unresolved & (blocker_later | blocker_stuck)
        unresolved = unresolved & ~fail_now
        # contention: lowest rank per target cell among unresolved movers
        score = jnp.where(unresolved, rank, A + 1)
        best = jnp.min(
            jnp.where(same_cell & unresolved[None, :], score[None, :], A + 1), axis=1
        )
        wins = unresolved & (score == best) & ~occ_any
        state = state.replace(
            agent_r=jnp.where(wins, r1, state.agent_r),
            agent_c=jnp.where(wins, c1, state.agent_c),
        )
        moved = moved | wins
        unresolved = unresolved & ~wins
    success = success | moved

    # ---------- station bumps: winner per station ([A, A] same-station min) ----------
    def station_winner(bump):
        score = jnp.where(bump, rank, A + 1)
        same_st = sidx[:, None] == sidx[None, :]
        best = jnp.min(
            jnp.where(same_st & bump[None, :], score[None, :], A + 1), axis=1
        )
        return bump & (score == best)

    if tables.has_assemblers:
        bump_asm = movers & ~interacted & (skind == KIND_ASSEMBLER)
        is_winner = station_winner(bump_asm)
        state, asm_success = _assembler_phase(state, tables, is_winner, sidx, lims)
        success = success | asm_success
    if tables.has_chests:
        bump_chest = movers & ~interacted & (skind == KIND_CHEST)
        is_winner_c = station_winner(bump_chest)
        state, chest_success = _chest_phase(state, tables, is_winner_c, sidx, lims)
        success = success | chest_success

    # ---------- action resource consumption + motion stats ----------
    if tables.any_action_consumed:
        consumed = jnp.where(
            success[:, None], _lut(tables.action_consumed, act, NACT), 0
        )
        old_inv = state.agent_inv
        state = state.replace(
            agent_inv=jnp.clip(old_inv - consumed, 0, lims)
        )
        state = _track_agent_inv(state, tables, old_inv)
    ran = act_ok & ~is_frozen
    moved_any = (state.agent_r != state.agent_prev_r) | (state.agent_c != state.agent_prev_c)
    swm = jnp.where(moved_any, 0, state.agent_steps_without_motion + 1)
    state = state.replace(
        agent_steps_without_motion=jnp.where(ran, swm, state.agent_steps_without_motion),
        agent_prev_r=jnp.where(ran, state.agent_r, state.agent_prev_r),
        agent_prev_c=jnp.where(ran, state.agent_c, state.agent_prev_c),
        action_success=success,
        executed_action=jnp.where(success, act, 0),
    )

    # ---------- world systems, obs, rewards (shared with the sequential step) ----------
    if tables.has_regen:
        state = apply_regen(state, tables)
    if tables.has_damage:
        state = apply_damage(state, tables, k_damage)
    if tables.has_aoe:
        from metta_tpu.engine.activation_wiring import apply_aoe

        state = apply_aoe(state, tables)
    if tables.clipper_enabled and tables.clip_period > 0:
        state = clipper_step(state, tables, k_clip)

    # rebuild the agent grid as a one-hot matmul (agents occupy distinct
    # cells, so the position outer-products never collide)
    roh = (state.agent_r[:, None] == jnp.arange(H)[None, :]).astype(jnp.float32)
    coh = (state.agent_c[:, None] == jnp.arange(W)[None, :]).astype(jnp.float32)
    ids = (jnp.arange(A) + 1).astype(jnp.float32)
    grid = jax.lax.dot_general(
        roh * ids[:, None], coh, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
    ).astype(state.agent_grid.dtype)
    state = state.replace(agent_grid=grid)

    if render:
        # observations see action-phase rewards but not stat rewards
        # (mettagrid_c.cpp:653 obs before :656 stat rewards)
        obs = render_observations(state, tables, state.executed_action, state.reward)
    else:
        obs = jnp.zeros((1, 1, 3), jnp.uint8)
    state = compute_stat_rewards(state, tables)
    state = state.replace(episode_reward=state.episode_reward + state.reward)

    if tables.max_steps > 0:
        ended = state.step >= tables.max_steps
        if tables.episode_truncates:
            state = state.replace(truncated=ended)
        else:
            state = state.replace(done=ended)
    return state, obs


# ---------------------------------------------------------------------------
# stations, vectorized over the station axis
# ---------------------------------------------------------------------------


def _cumsum_small(x, axis: int = 0):
    """Inclusive cumsum over a tiny static axis as log2(n) shifted adds.

    XLA lowers ``jnp.cumsum`` through reduce-window, a fusion breaker that
    forces the [E, K, 8, R] intermediates of the assembler phase through HBM;
    pad+slice+add chains stay inside one fusion."""
    n = x.shape[axis]
    shift = 1
    while shift < n:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (shift, 0)
        shifted = jnp.pad(x, pad)
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, n)
        x = x + shifted[tuple(idx)]
        shift *= 2
    return x


def _local_shared_consume(rows, lims, valid, delta, passes: int = 3):
    """shared_update on local copies: distribute delta[R] (+/-) over rows [L, R].

    Pure function of the gathered inventories; returns per-slot deltas [L, R].
    """
    L = rows.shape[0]
    applied = jnp.zeros_like(rows)
    active = valid[:, None] & (delta != 0)[None, :]
    delta_rem = delta
    n_rem = jnp.sum(active.astype(jnp.int32), axis=0)
    cur = rows
    free = jnp.maximum(lims - rows, 0)
    for _ in range(passes):
        per = jnp.where(n_rem > 0, trunc_div(delta_rem, jnp.maximum(n_rem, 1)), 0)
        kick = active & jnp.where(delta_rem[None, :] > 0,
                                  (free - applied) <= per[None, :],
                                  (cur + applied) <= -per[None, :])
        take = jnp.clip(jnp.where(kick, per[None, :], 0),
                        -(cur + applied), free - applied)
        applied = applied + take
        delta_rem = delta_rem - jnp.sum(take, axis=0)
        n_rem = n_rem - jnp.sum(kick.astype(jnp.int32), axis=0)
        active = active & ~kick
    # final distribution: base + sign-surplus to earliest actives
    rank_l = _cumsum_small(active.astype(jnp.int32), axis=0) - 1
    base = jnp.where(n_rem > 0, trunc_div(delta_rem, jnp.maximum(n_rem, 1)), 0)
    surplus = delta_rem - base * n_rem
    extra = jnp.where(rank_l < jnp.abs(surplus)[None, :], jnp.sign(surplus)[None, :], 0)
    final = jnp.where(active, base[None, :] + extra, 0)
    final = jnp.clip(final, -(cur + applied), jnp.maximum(lims - rows, 0) - applied)
    return applied + final


def _scatter_rows(idx, valid, deltas, A, R):
    """Σ over rows i with valid[i] of deltas[i] into agent slot idx[i].

    idx [L] or [NA, 8], deltas [..., R] → [A, R]; one-hot matmul (f32 HIGHEST
    is exact for the integer magnitudes here) in place of a scatter-add.
    """
    idx_f = idx.reshape(-1)
    val_f = valid.reshape(-1)
    d_f = deltas.reshape(-1, R)
    oh = ((idx_f[:, None] == jnp.arange(A)[None, :]) & val_f[:, None])
    return jax.lax.dot_general(
        oh.astype(jnp.float32).T, d_f.astype(jnp.float32),
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)


def _gather_rows(idx, valid, rows, A):
    """rows[idx] with invalid slots zeroed — one-hot matmul row gather.

    idx [...], rows [A, R] → [..., R].
    """
    R = rows.shape[-1]
    idx_f = idx.reshape(-1)
    oh = (idx_f[:, None] == jnp.arange(A)[None, :]) & valid.reshape(-1)[:, None]
    out = jax.lax.dot_general(
        oh.astype(jnp.float32), rows.astype(jnp.float32),
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(rows.dtype)
    return out.reshape(idx.shape + (R,))


def _assembler_phase(state, tables, is_winner, sidx, lims):
    """All claimed assemblers fire simultaneously (vectorized over stations).

    Gather/scatter-free: the claim, neighbor resolution, protocol lookup,
    inventory reads, and delta write-back are one-hot reductions and matmuls.
    Since at most A agents can claim a station per step, the station axis is
    first *compacted* from NA slots to K = min(A, NA) claimed slots (one-hot
    compaction matmuls — rank-of-claimed, no data-dependent gathers), so the
    heavy per-station machinery (neighbor windows, shared_update passes —
    the [E, K, 8, R] intermediates) runs over K rows instead of NA.
    """
    A = tables.num_agents
    R = tables.num_resources
    NA = tables.n_assembler_slots
    NP = tables.n_protocols
    NUP = tables.n_unclip_protocols
    V = tables.num_vibes

    # claimant agent per assembler via one-hot max (≤1 winner per station)
    soh = (sidx[:, None] == jnp.arange(NA)[None, :]) & is_winner[:, None]  # [A, NA]
    claim = jnp.max(jnp.where(soh, jnp.arange(A)[:, None], -1), axis=0)    # [NA]
    claimed = claim >= 0

    # ---- compact claimed stations: NA slots -> K = min(A, NA) rows ----
    K = min(A, NA)
    crank = jnp.cumsum(claimed.astype(jnp.int32)) - 1                      # [NA]
    # coh[k, s] = station s is the k-th claimed station
    coh = (crank[None, :] == jnp.arange(K)[:, None]) & claimed[None, :]    # [K, NA]

    # one packed compaction GEMM for every per-station field (each previously
    # its own [K, NA] x [NA, 1] one-hot matmul — 10 fusion-breaking batched
    # GEMMs per step at E=4096)
    fields_na = jnp.stack([
        state.asm_type, state.asm_r, state.asm_c, state.asm_uses,
        state.asm_cooldown_end, state.asm_cooldown_duration,
        state.asm_clipped.astype(jnp.int32), state.asm_unclip_proto,
        claim, state.asm_valid.astype(jnp.int32),
    ], axis=1)                                                             # [NA, 10]
    cfields = _ohdot(coh, fields_na)                                       # [K, 10]
    c_type = cfields[:, 0]
    c_asm_r, c_asm_c = cfields[:, 1], cfields[:, 2]
    c_uses, c_cd_end, c_cd_dur = cfields[:, 3], cfields[:, 4], cfields[:, 5]
    c_clipped = cfields[:, 6] != 0
    c_uproto = cfields[:, 7]
    c_claim = cfields[:, 8]
    c_valid = cfields[:, 9] != 0
    c_rowvalid = jnp.any(coh, axis=1)                                      # [K]

    # per-station type properties (one-hot LUT over the NT types)
    NT = int(tables.type_max_uses.shape[0])
    max_uses = _lut(tables.type_max_uses, c_type, NT)
    allow_partial = _lut_bool(tables.type_allow_partial, c_type, NT)

    # actor position per claimed station (compose the two one-hots:
    # agent -> station -> compact row; one GEMM for both coordinates)
    aoh = jax.lax.dot_general(
        coh.astype(jnp.float32), soh.T.astype(jnp.float32),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
    ) > 0.5                                                                # [K, A]
    arc = _ohdot(aoh, jnp.stack([state.agent_r, state.agent_c], axis=1))
    actor_r, actor_c = arc[:, 0], arc[:, 1]

    offs = jnp.array(_NEIGHBOR_OFFS, jnp.int32)

    # ---- protocol-resource subset: all inventory work in this phase only
    # touches the resources some protocol reads/writes (Rp <= R) ----
    import numpy as _np
    PR = tables.proto_res
    Rp = len(PR)
    pr_idx = jnp.asarray(_np.array(PR, _np.int32))
    inv_p = state.agent_inv[:, pr_idx]                 # [A, Rp]
    lims_p = lims[:, pr_idx]
    proto_in_p = tables.proto_in[:, pr_idx]
    proto_out_p = tables.proto_out[:, pr_idx]
    uproto_in_p = tables.uproto_in[:, pr_idx]
    uproto_out_p = tables.uproto_out[:, pr_idx]
    expand_m = _np.zeros((Rp, R), _np.float32)
    expand_m[_np.arange(Rp), _np.array(PR)] = 1.0
    expand_m = jnp.asarray(expand_m)

    def per_station_pre(claim_i, claimed_i, valid_i, t_i, ar_, ac_, uses_i,
                        cd_end_i, cd_dur_i, clipped, uproto_i, max_uses_i,
                        allow_partial_i, actor_r_i, actor_c_i):
        """Gather-free per-station work: protocol selection, neighbor ranks,
        amounts. The inventory-row lookups and shared_update run hoisted
        across all K stations afterwards (single one-hot GEMMs)."""
        do = claimed_i & valid_i

        ok = do & ((max_uses_i == 0) | (uses_i < max_uses_i))
        remaining = jnp.maximum(cd_end_i - state.step, 0)
        ok = ok & ((remaining == 0) | allow_partial_i)

        rr = ar_ + offs[:, 0]
        cc = ac_ + offs[:, 1]
        inb = (rr >= 0) & (rr < tables.height) & (cc >= 0) & (cc < tables.width)
        match = (state.agent_r[None, :] == rr[:, None]) & (state.agent_c[None, :] == cc[:, None])
        nb_is_agent = inb & jnp.any(match, axis=1)
        # ≤1 match per cell → masked sums replace argmax+gather
        nb_idx = jnp.sum(jnp.where(match, jnp.arange(A)[None, :], 0), axis=1)
        vibes = jnp.sum(jnp.where(match, state.agent_vibe[None, :], 0), axis=1)
        vibes = jnp.where(nb_is_agent, vibes, 0)
        # sorted vibe key via counting sort (values < V): sorted[j] = #{v :
        # cum(v) <= j} — two whole-array ops instead of an XLA sort of tiny
        # segments (the lowered per-station jnp.sort dominated this phase)
        cnt_v = jnp.sum(
            (vibes[:, None] == jnp.arange(V)[None, :]).astype(jnp.int32), axis=0
        )                                                  # [V]
        cum_v = _cumsum_small(cnt_v, axis=0)
        key_vec = jnp.sum(
            (cum_v[None, :] <= jnp.arange(8)[:, None]).astype(vibes.dtype),
            axis=1,
        )
        n_agents = jnp.sum(nb_is_agent.astype(jnp.int32))

        p_norm = select_protocol(tables, t_i, key_vec, n_agents)
        p_un = select_unclip_protocol(tables, uproto_i, key_vec, n_agents)
        p_idx = jnp.where(clipped, p_un, p_norm)
        ok = ok & (p_idx >= 0)
        pn_oh = jnp.clip(p_idx, 0, NP - 1) == jnp.arange(NP)
        pu_oh = jnp.clip(p_idx, 0, NUP - 1) == jnp.arange(NUP)

        def gth(norm, un):
            if norm.ndim == 1:
                n = jnp.sum(jnp.where(pn_oh, norm, 0))
                u = jnp.sum(jnp.where(pu_oh, un, 0))
            else:
                n = jnp.sum(jnp.where(pn_oh[:, None], norm, 0), axis=0)
                u = jnp.sum(jnp.where(pu_oh[:, None], un, 0), axis=0)
            return jnp.where(clipped, u, n)

        inputs = gth(proto_in_p, uproto_in_p)
        outputs = gth(proto_out_p, uproto_out_p)
        cooldown = gth(tables.proto_cooldown, tables.uproto_cooldown)
        nvibes = gth(tables.proto_nvibes, tables.uproto_nvibes)
        vibe_counts = gth(tables.proto_vibe_counts, tables.uproto_vibe_counts)
        orig_has_output = jnp.any(outputs > 0)

        if tables.any_allow_partial:
            duration = jnp.maximum(cd_dur_i, 1)
            elapsed = cd_dur_i - remaining
            do_scale = (remaining > 0) & allow_partial_i
            inputs = jnp.where(do_scale, (inputs * elapsed + duration - 1) // duration, inputs)
            outputs = jnp.where(do_scale, (outputs * elapsed) // duration, outputs)
            wasteful = do_scale & ~jnp.any(outputs > 0) & orig_has_output & ~clipped
            ok = ok & ~wasteful

        # rotated neighbor order from the actor's slot; ranks computed by
        # counting (no argsort/gather): agents ordered by rotation index,
        # non-agents after, both stable in slot order
        inb_i32 = inb.astype(jnp.int32)
        rank_inb = _cumsum_small(inb_i32, axis=0) - 1
        n_inb = jnp.sum(inb_i32)
        is_actor_slot = (offs[:, 0] == (actor_r_i - ar_)) & (offs[:, 1] == (actor_c_i - ac_))
        start_rank = jnp.sum(jnp.where(is_actor_slot, rank_inb, 0))
        rot = jnp.mod(rank_inb - start_rank, jnp.maximum(n_inb, 1))
        order_key = jnp.where(nb_is_agent, rot, 1000 + jnp.arange(8))
        # rank of slot j = #slots with smaller key + #earlier slots with equal key
        lt = order_key[None, :] < order_key[:, None]
        eq_before = (order_key[None, :] == order_key[:, None]) & (
            jnp.arange(8)[None, :] < jnp.arange(8)[:, None]
        )
        slot_rank = jnp.sum((lt | eq_before).astype(jnp.int32), axis=1)   # [8]
        # position→slot one-hot: poh[p, j] = (slot_rank[j] == p)
        poh = slot_rank[None, :] == jnp.arange(8)[:, None]                # [8, 8]
        ref_idx = jnp.sum(jnp.where(poh, nb_idx[None, :], 0), axis=1)
        ref_valid = jnp.any(poh & nb_is_agent[None, :], axis=1)
        v8 = jnp.sum(jnp.where(poh, vibes[None, :], 0), axis=1)

        # output selection: occurrence-index trick replaces the sequential loop
        v8c = jnp.clip(v8, 0, V - 1)
        voh8 = v8c[:, None] == jnp.arange(V)[None, :]                     # [8, V]
        same_before = _cumsum_small(voh8.astype(jnp.int32), axis=0) - voh8.astype(jnp.int32)
        occ_idx = jnp.sum(jnp.where(voh8, same_before, 0), axis=1)
        count_v = jnp.sum(jnp.where(voh8, vibe_counts[None, :], 0), axis=1)
        sel = ref_valid & (v8 != 0) & (occ_idx < count_v)
        use_multi = (nvibes > 1) & jnp.any(sel)
        out_valid = jnp.where(use_multi, sel, jnp.arange(8) == 0)
        actor = jnp.clip(claim_i, 0, A - 1)
        out_idx = jnp.where(use_multi, ref_idx, jnp.full((8,), actor))
        return (ok, clipped, inputs, outputs, cooldown,
                ref_idx, ref_valid, out_idx, out_valid)

    (ok_v, clipped_v, inputs_v, outputs_v, cooldown_v,
     in_idx, in_val, out_idx, out_val) = jax.vmap(per_station_pre)(
        c_claim, c_rowvalid, c_valid,
        c_type, c_asm_r, c_asm_c,
        c_uses, c_cd_end,
        c_cd_dur, c_clipped,
        c_uproto, max_uses, allow_partial,
        actor_r, actor_c,
    )

    # ---- hoisted inventory lookups: ONE [2K*8, A] one-hot + ONE GEMM over a
    # concatenated (inventory | limits) table serves all four per-station
    # row sets (the materialized one-hots were the phase's HBM hot spot) ----
    table = jnp.concatenate([inv_p, lims_p], axis=1)                   # [A, 2Rp]
    idx_all = jnp.concatenate([in_idx, out_idx], axis=0)               # [2K, 8]
    val_all = jnp.concatenate([in_val, out_val], axis=0)
    g = _gather_rows(idx_all, val_all, table, A)                       # [2K, 8, 2Rp]
    rows_k, lim_rows_k = g[:K, :, :Rp], g[:K, :, Rp:]
    out_rows_k, out_lims_k = g[K:, :, :Rp], g[K:, :, Rp:]

    def per_station_fin(ok, clipped, inputs, outputs, ref_valid, rows,
                        lim_rows, out_valid, out_rows, out_lims):
        totals = jnp.sum(jnp.where(ref_valid[:, None], rows, 0), axis=0)
        ok = ok & jnp.all((inputs == 0) | (totals >= inputs))
        total_free = jnp.sum(
            jnp.where(out_valid[:, None], jnp.maximum(out_lims - out_rows, 0), 0),
            axis=0,
        )
        has_output = jnp.any(outputs > 0)
        can_absorb = jnp.any((outputs > 0) & (total_free >= 1))
        ok = ok & (~has_output | can_absorb | clipped)

        in_deltas = _local_shared_consume(
            rows, lim_rows, ref_valid, jnp.where(ok, -inputs, 0)
        )
        out_deltas = _local_shared_consume(
            out_rows, out_lims, out_valid, jnp.where(ok, outputs, 0)
        )
        return ok, in_deltas, out_deltas

    ok_v, in_d, out_d = jax.vmap(per_station_fin)(
        ok_v, clipped_v, inputs_v, outputs_v, in_val, rows_k, lim_rows_k,
        out_val, out_rows_k, out_lims_k,
    )

    # write back all deltas via one one-hot matmul, expanded from the
    # protocol-resource subset to full R with a constant one-hot (clamped at
    # 0/limit afterwards — see module docstring)
    d_p = _scatter_rows(in_idx, in_val, in_d, A, Rp) + _scatter_rows(
        out_idx, out_val, out_d, A, Rp
    )
    d = jax.lax.dot_general(
        d_p.astype(jnp.float32), expand_m, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)                                                    # [A, R]
    old_inv = state.agent_inv
    state = state.replace(agent_inv=jnp.clip(old_inv + d, 0, lims))
    state = _track_agent_inv(state, tables, old_inv)
    if tables.track_chest_stats:
        # assembler.<r>.created game stat (parity: assembler onUse output
        # distribution accounting, assembler.py:197/:235 sequential path).
        created_p = jnp.sum(jnp.maximum(out_d, 0), axis=(0, 1))
        created = jax.lax.dot_general(
            created_p.astype(jnp.float32)[None], expand_m,
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )[0].astype(jnp.int32)
        state = state.replace(game_asm_created=state.game_asm_created + created)

    # scatter compacted per-station results back to the full NA axis
    def cscatter(v_k):
        return _ohdot(coh.T, v_k[:, None])[:, 0]

    ok_na = jnp.any(coh & ok_v[:, None], axis=0)                           # [NA]
    cooldown_na = cscatter(cooldown_v)
    unclip_now = ok_na & state.asm_clipped
    state = state.replace(
        asm_cooldown_duration=jnp.where(ok_na, cooldown_na, state.asm_cooldown_duration),
        asm_cooldown_end=jnp.where(ok_na, state.step + cooldown_na, state.asm_cooldown_end),
        asm_uses=state.asm_uses + jnp.where(ok_na & ~state.asm_clipped, 1, 0),
        asm_clipped=jnp.where(unclip_now, False, state.asm_clipped),
        asm_unclip_proto=jnp.where(unclip_now, -1, state.asm_unclip_proto),
    )
    # per-agent success: their claimed station fired (one-hot over stations)
    agent_success = is_winner & jnp.any(soh & ok_na[None, :], axis=1)
    return state, agent_success


def _chest_phase(state, tables, is_winner, sidx, lims):
    """Claimed chests process their winner's vibe transfer simultaneously.

    Gather/scatter-free: claim + actor fields via one-hot reductions, delta
    write-back via one-hot matmul (see _assembler_phase).
    """
    A = tables.num_agents
    R = tables.num_resources
    NC = tables.n_chest_slots
    V = tables.num_vibes
    NTC = int(tables.chest_type_inv_class.shape[0])

    coh = (sidx[:, None] == jnp.arange(NC)[None, :]) & is_winner[:, None]  # [A, NC]
    claim = jnp.max(jnp.where(coh, jnp.arange(A)[:, None], -1), axis=0)    # [NC]
    claimed = claim >= 0

    # per-chest actor fields (one-hot over agents; zero when unclaimed)
    a_vibe = jnp.sum(jnp.where(coh, state.agent_vibe[:, None], 0), axis=0)
    a_inv = _gather_rows(jnp.clip(claim, 0, A - 1), claimed, state.agent_inv, A)
    a_lim = _gather_rows(jnp.clip(claim, 0, A - 1), claimed, lims, A)

    # per-chest-type tables (one-hot over chest types, then vibes)
    toh = state.chest_type[:, None] == jnp.arange(NTC)[None, :]            # [NC, NTC]
    voh = jnp.clip(a_vibe, 0, V - 1)[:, None] == jnp.arange(V)[None, :]    # [NC, V]
    tv = toh[:, :, None] & voh[:, None, :]                                  # [NC, NTC, V]
    has = jnp.any(tv & tables.chest_vibe_has[None], axis=(1, 2))
    deltas = jnp.sum(
        jnp.where(tv[:, :, :, None], tables.chest_vibe_delta[None], 0), axis=(1, 2)
    )                                                                       # [NC, R]
    res_group, group_base, _ = tables.inv_tables
    cls_c = _lut(tables.chest_type_inv_class, state.chest_type, NTC)        # [NC]
    # (class count is tiny; one-hot the class pick too)
    clsoh = cls_c[:, None] == jnp.arange(group_base.shape[0])[None, :]      # [NC, C]
    base_c = jnp.sum(jnp.where(clsoh[:, :, None], group_base[None], 0), axis=1)  # [NC, R]
    rg_c = jnp.sum(jnp.where(clsoh[:, :, None], res_group[None], 0), axis=1)     # [NC, R]
    rgoh = rg_c[:, :, None] == jnp.arange(R)[None, None, :]                 # [NC, R, R]
    c_lim = jnp.clip(jnp.sum(jnp.where(rgoh, base_c[:, None, :], 0), axis=2), 0, 65535)

    do = claimed & state.chest_valid
    ok = do & has
    c_inv = state.chest_inv
    give_dep = jnp.where((deltas > 0) & ok[:, None], jnp.minimum(a_inv, deltas), 0)
    got_dep = jnp.minimum(give_dep, jnp.maximum(c_lim - c_inv, 0))
    give_w = jnp.where((deltas < 0) & ok[:, None], jnp.minimum(c_inv, -deltas), 0)
    got_w = jnp.minimum(give_w, jnp.maximum(a_lim - a_inv, 0))
    agent_d = got_w - give_dep
    chest_d = got_dep - give_w
    any_tr = jnp.any(got_dep > 0, axis=1) | jnp.any(got_w > 0, axis=1)
    ok_v = ok & any_tr

    old_inv = state.agent_inv
    state = state.replace(
        agent_inv=jnp.clip(
            old_inv + _scatter_rows(jnp.clip(claim, 0, A - 1), claimed, agent_d, A, R),
            0, lims,
        ),
        chest_inv=jnp.clip(state.chest_inv + chest_d, 0, 65535),
    )
    state = _track_agent_inv(state, tables, old_inv)
    if tables.track_chest_stats:
        # Parity: chest.hpp:59-66 game stats + deposited_by_agent
        # (actions.py:205-233 sequential path). The chest loses the full
        # offered amount on withdraw (destroy-untransferred), so withdrawn
        # counts give_w, while deposited counts only what the chest absorbed.
        state = state.replace(
            agent_chest_deposited=state.agent_chest_deposited + _scatter_rows(
                jnp.clip(claim, 0, A - 1), claimed, jnp.maximum(got_dep, 0), A, R
            ),
            game_chest_deposited=state.game_chest_deposited
            + jnp.sum(jnp.maximum(got_dep, 0), axis=0),
            game_chest_withdrawn=state.game_chest_withdrawn
            + jnp.sum(jnp.maximum(give_w, 0), axis=0),
        )
    agent_success = is_winner & jnp.any(coh & ok_v[None, :], axis=1)
    return state, agent_success
