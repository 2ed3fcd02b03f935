"""Token observation renderer.

Parity: ``bindings/mettagrid_c.cpp:397-563`` + ``systems/observation_encoder.hpp``.
Each observation is ``[num_tokens, 3] uint8`` of ``(packed_location,
feature_id, value)`` tokens: global tokens at the window center, an optional
compass token one step toward the map center, then visible objects in
increasing-Manhattan-distance (center-out) order until the buffer fills.
Empty slots are 0xff. Packed location = ``row<<4 | col`` in window coords
(``systems/packed_coordinate.hpp:27-72``).

Design: instead of walking objects per agent per cell, we build
per-object token *blocks* once per step (vmap over agents / assemblers /
chests / wall types), concatenate them into one table, and each agent's render
is a single gather over its 121 window cells followed by a prefix-sum
compaction into the token buffer. Within-object token order for inventories is
resource-id ascending (the reference's order follows unordered_map iteration,
which is unspecified).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from metta_tpu.engine.protocols import select_protocol, select_unclip_protocol, surrounding_vibe_key
from metta_tpu.engine.state import KIND_ASSEMBLER, KIND_CHEST, KIND_WALL
from metta_tpu.engine.xprec import exact_matmuls

EMPTY = 255


def _pad_block(feats, vals, valid, k):
    """Pad (feature, value, valid) stacks to k slots.

    When the raw candidate-slot count exceeds k (e.g. assemblers list 2R
    protocol slots but the compiled bound counts only the max *nonzero*
    protocol entries), the valid tokens are stably compacted to the front and
    truncated — the bound guarantees they fit, and order is preserved.
    """
    n = feats.shape[0]
    if n < k:
        pad = k - n
        feats = jnp.concatenate([feats, jnp.zeros((pad,), feats.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    elif n > k:
        vi = valid.astype(jnp.int32)
        rank = jnp.cumsum(vi) - vi
        oh = valid[:, None] & (rank[:, None] == jnp.arange(k)[None, :])  # [n, k]
        feats = jnp.sum(jnp.where(oh, feats[:, None], 0), axis=0)
        vals = jnp.sum(jnp.where(oh, vals[:, None], 0), axis=0)
        valid = jnp.any(oh, axis=0)
    return feats, vals, valid


def _inventory_tokens(tables, inv_row):
    """Multi-token inventory encoding for one inventory vector [R].

    Returns (feats [R*n_tok], vals, valid): base token per nonzero resource,
    power tokens while the shifted remainder is nonzero
    (observation_encoder.hpp:160-180).
    """
    base = tables.token_value_base
    n_tok = tables.num_inv_tokens
    feats, vals, valids = [], [], []
    for p in range(n_tok):
        shifted = inv_row // (base ** p)
        vals.append(shifted % base)
        feats.append(tables.inv_feature_ids[:, p])
        valids.append(shifted > 0)
    # interleave per resource: r0 base, r0 p1, ..., r1 base, ...
    feats = jnp.stack(feats, axis=1).reshape(-1)
    vals = jnp.stack(vals, axis=1).reshape(-1)
    valid = jnp.stack(valids, axis=1).reshape(-1)
    return feats, vals, valid


def build_agent_blocks(state, tables):
    """[A, K, 2] (feature, value) + [A, K] valid; order per agent.cpp:195-225."""
    f = tables.feat_id
    K = tables.max_tokens_per_cell

    def one(a):
        feats = [jnp.int32(f["agent:group"]), jnp.int32(f["agent:frozen"]), jnp.int32(f["vibe"])]
        vals = [tables.agent_group[a], (state.agent_frozen[a] != 0).astype(jnp.int32),
                state.agent_vibe[a]]
        valid = [jnp.bool_(True), jnp.bool_(True), state.agent_vibe[a] != 0]
        inv_f, inv_v, inv_ok = _inventory_tokens(tables, state.agent_inv[a])
        tag_f = jnp.full((tables.max_tags,), f["tag"], jnp.int32)
        tag_v = jnp.maximum(tables.agent_tags[a], 0)
        tag_ok = tables.agent_tags[a] >= 0
        feats = jnp.concatenate([jnp.stack(feats), inv_f, tag_f])
        vals = jnp.concatenate([jnp.stack(vals), inv_v, tag_v])
        ok = jnp.concatenate([jnp.stack(valid), inv_ok, tag_ok])
        return _pad_block(feats, vals, ok, K)

    feats, vals, ok = jax.vmap(one)(jnp.arange(tables.num_agents))
    return jnp.stack([feats, vals], axis=-1), ok


def build_wall_blocks(tables):
    """Per-object-type block: tags then vibe (wall.hpp:26-38)."""
    f = tables.feat_id
    K = tables.max_tokens_per_cell

    def one(t):
        tag_f = jnp.full((tables.max_tags,), f["tag"], jnp.int32)
        tag_v = jnp.maximum(tables.type_tags[t], 0)
        tag_ok = tables.type_tags[t] >= 0
        feats = jnp.concatenate([tag_f, jnp.array([f["vibe"]], jnp.int32)])
        vals = jnp.concatenate([tag_v, tables.type_vibe[t][None]])
        ok = jnp.concatenate([tag_ok, (tables.type_vibe[t] != 0)[None]])
        return _pad_block(feats, vals, ok, K)

    feats, vals, ok = jax.vmap(one)(jnp.arange(tables.n_object_types))
    return jnp.stack([feats, vals], axis=-1), ok


def _type_lut(tables, t):
    """One-hot object-type lookups (scalar t)."""
    NT = tables.n_object_types
    toh = t == jnp.arange(NT)
    tags = jnp.sum(jnp.where(toh[:, None], tables.type_tags, 0), axis=0)
    vibe = jnp.sum(jnp.where(toh, tables.type_vibe, 0))
    max_uses = jnp.sum(jnp.where(toh, tables.type_max_uses, 0))
    return tags, vibe, max_uses


def _asm_proto_batched(state, tables):
    """Selected protocol per assembler, batched over the NA axis.

    Replaces per-station ``surrounding_vibe_key`` + ``select_protocol``
    calls (which lower to NA tiny sorts and serialized picks) with one
    [NA, 8, A] neighbor match, a counting-sort key, and argmax-over-NP
    selection — identical results (protocols.py semantics).

    Returns (p_idx [NA] into proto/uproto tables, use_un [NA] bool).
    """
    NA = tables.n_assembler_slots
    NP = tables.n_protocols
    NUP = tables.n_unclip_protocols
    V = tables.num_vibes
    H, W = tables.height, tables.width
    offs = jnp.array(
        [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)],
        jnp.int32,
    )
    rr = state.asm_r[:, None] + offs[None, :, 0]            # [NA, 8]
    cc = state.asm_c[:, None] + offs[None, :, 1]
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    match = (state.agent_r[None, None, :] == rr[..., None]) & (
        state.agent_c[None, None, :] == cc[..., None]
    )                                                        # [NA, 8, A]
    is_agent = inb & jnp.any(match, axis=-1)
    vibes = jnp.where(
        is_agent,
        jnp.sum(jnp.where(match, state.agent_vibe[None, None, :], 0), axis=-1),
        0,
    )                                                        # [NA, 8]
    n_agents = jnp.sum(is_agent.astype(jnp.int32), axis=1)   # [NA]
    # ascending sorted key via counting sort (values < V)
    cnt = jnp.sum(
        (vibes[:, :, None] == jnp.arange(V)[None, None, :]).astype(jnp.int32),
        axis=1,
    )                                                        # [NA, V]
    cum = jnp.cumsum(cnt, axis=1)
    key_vec = jnp.sum(
        (cum[:, None, :] <= jnp.arange(8)[None, :, None]).astype(jnp.int32),
        axis=2,
    )                                                        # [NA, 8]

    def pick(cands):                                         # [NA, NP] -> [NA]
        score = jnp.where(cands, tables.proto_rank[None, :], -1)
        best = jnp.argmax(score, axis=1).astype(jnp.int32)
        return jnp.where(jnp.max(score, axis=1) >= 0, best, -1)

    cands = (
        tables.proto_valid[None, :]
        & (tables.proto_type[None, :] == state.asm_type[:, None])
        & (tables.proto_min_agents[None, :] <= n_agents[:, None])
    )                                                        # [NA, NP]
    exact = jnp.all(
        tables.proto_key[None, :, :] == key_vec[:, None, :], axis=2
    )
    zero = jnp.all(tables.proto_key == 0, axis=1)            # [NP]
    idx = pick(cands & exact)
    idx0 = pick(cands & zero[None, :])
    p_norm = jnp.where(idx >= 0, idx, idx0)

    up = state.asm_unclip_proto                              # [NA]
    i_u = jnp.clip(up, 0, NUP - 1)
    min_u = tables.uproto_min_agents[i_u]
    key_u = tables.uproto_key[i_u]                           # [NA, 8]
    ok_u = (up >= 0) & (min_u <= n_agents)
    key_match = jnp.all(key_u == key_vec, axis=1) | jnp.all(key_u == 0, axis=1)
    p_un = jnp.where(ok_u & key_match, i_u, -1)

    use_un = state.asm_clipped
    return jnp.where(use_un, p_un, p_norm), use_un


def build_assembler_blocks(state, tables):
    """Per-assembler block (assembler.hpp:528-578)."""
    f = tables.feat_id
    K = tables.max_tokens_per_cell
    R = tables.num_resources

    if tables.protocol_details_obs:
        p_idx_all, use_un_all = _asm_proto_batched(state, tables)
    else:
        p_idx_all = use_un_all = None

    def one(i):
        t = state.asm_type[i]
        type_tags, type_vibe, max_uses = _type_lut(tables, t)
        remaining = jnp.clip(state.asm_cooldown_end[i] - state.step, 0, 255)
        remaining_uses = jnp.clip(max_uses - state.asm_uses[i], 0, 255)
        head_f = jnp.array([f["cooldown_remaining"], f["clipped"], f["remaining_uses"]], jnp.int32)
        head_v = jnp.stack([remaining, state.asm_clipped[i].astype(jnp.int32), remaining_uses])
        head_ok = jnp.stack([remaining > 0, state.asm_clipped[i], max_uses > 0])

        if tables.protocol_details_obs:
            p_idx = p_idx_all[i]
            use_un = use_un_all[i]
            has_p = p_idx >= 0
            p_safe = jnp.clip(p_idx, 0, None)
            pn_oh = jnp.clip(p_safe, 0, tables.n_protocols - 1) == jnp.arange(tables.n_protocols)
            pu_oh = jnp.clip(p_safe, 0, tables.n_unclip_protocols - 1) == jnp.arange(tables.n_unclip_protocols)
            inputs = jnp.where(
                use_un,
                jnp.sum(jnp.where(pu_oh[:, None], tables.uproto_in, 0), axis=0),
                jnp.sum(jnp.where(pn_oh[:, None], tables.proto_in, 0), axis=0),
            )
            outputs = jnp.where(
                use_un,
                jnp.sum(jnp.where(pu_oh[:, None], tables.uproto_out, 0), axis=0),
                jnp.sum(jnp.where(pn_oh[:, None], tables.proto_out, 0), axis=0),
            )
            in_f = tables.proto_input_feature
            out_f = tables.proto_output_feature
            proto_f = jnp.concatenate([in_f, out_f])
            proto_v = jnp.concatenate([inputs, outputs])
            proto_ok = (proto_v > 0) & has_p
        else:
            proto_f = jnp.zeros((0,), jnp.int32)
            proto_v = jnp.zeros((0,), jnp.int32)
            proto_ok = jnp.zeros((0,), bool)

        tag_f = jnp.full((tables.max_tags,), f["tag"], jnp.int32)
        tag_v = jnp.maximum(type_tags, 0)
        tag_ok = type_tags >= 0
        vibe_f = jnp.array([f["vibe"]], jnp.int32)
        vibe_v = type_vibe[None]
        vibe_ok = (type_vibe != 0)[None]

        feats = jnp.concatenate([head_f, proto_f, tag_f, vibe_f])
        vals = jnp.concatenate([head_v, proto_v, tag_v, vibe_v])
        ok = jnp.concatenate([head_ok, proto_ok, tag_ok, vibe_ok]) & state.asm_valid[i]
        return _pad_block(feats, vals, ok, K)

    feats, vals, ok = jax.vmap(one)(jnp.arange(tables.n_assembler_slots))
    return jnp.stack([feats, vals], axis=-1), ok


def build_chest_blocks(state, tables):
    """Per-chest block: vibe, inventory, tags (chest.hpp:128-150)."""
    f = tables.feat_id
    K = tables.max_tokens_per_cell

    def one(i):
        t = state.chest_type[i]
        type_tags, type_vibe, _ = _type_lut(tables, t)
        vibe_f = jnp.array([f["vibe"]], jnp.int32)
        vibe_v = type_vibe[None]
        vibe_ok = (type_vibe != 0)[None]
        inv_f, inv_v, inv_ok = _inventory_tokens(tables, state.chest_inv[i])
        tag_f = jnp.full((tables.max_tags,), f["tag"], jnp.int32)
        tag_v = jnp.maximum(type_tags, 0)
        tag_ok = type_tags >= 0
        feats = jnp.concatenate([vibe_f, inv_f, tag_f])
        vals = jnp.concatenate([vibe_v, inv_v, tag_v])
        ok = jnp.concatenate([vibe_ok, inv_ok, tag_ok]) & state.chest_valid[i]
        return _pad_block(feats, vals, ok, K)

    feats, vals, ok = jax.vmap(one)(jnp.arange(tables.n_chest_slots))
    return jnp.stack([feats, vals], axis=-1), ok


def _compact_blocks(blocks, oks):
    """Move each block's valid tokens to the front (stable) + per-block count.

    blocks [N, K, 2], oks [N, K] → (compacted [N, K, 2], counts [N]).
    Token *order* within a block is preserved, so output token order is
    identical to sequential emission.
    """
    order = jnp.argsort(jnp.where(oks, 0, 1), axis=1, stable=True)  # [N, K]
    compacted = jnp.take_along_axis(blocks, order[..., None], axis=1)
    counts = jnp.sum(oks.astype(jnp.int32), axis=1)
    return compacted, counts


@exact_matmuls
def render_observations(state, tables, executed_actions, rewards_at_obs):
    """Render all agents' token observations → [A, T, 3] uint8.

    Gather-based compaction: per-object token blocks are built
    once per step and compacted; each agent's render is then
    cell-count prefix sums + per-output-slot ``searchsorted`` gathers — no
    large scatters and no [cells × K] intermediates.
    """
    A = tables.num_agents
    T = tables.num_obs_tokens
    K = tables.max_tokens_per_cell
    oh, ow = tables.obs_height, tables.obs_width
    ohr, owr = oh // 2, ow // 2
    H, W = tables.height, tables.width
    f = tables.feat_id

    agent_blocks, agent_ok = build_agent_blocks(state, tables)
    wall_blocks, wall_ok = build_wall_blocks(tables)
    if tables.has_assemblers:
        asm_blocks, asm_ok = build_assembler_blocks(state, tables)
    else:
        asm_blocks = jnp.zeros((tables.n_assembler_slots, K, 2), jnp.int32)
        asm_ok = jnp.zeros((tables.n_assembler_slots, K), bool)
    if tables.has_chests:
        chest_blocks, chest_ok = build_chest_blocks(state, tables)
    else:
        chest_blocks = jnp.zeros((tables.n_chest_slots, K, 2), jnp.int32)
        chest_ok = jnp.zeros((tables.n_chest_slots, K), bool)

    # Unified block table: [1 + A + NT + NA + NC, K, 2]
    none_block = jnp.zeros((1, K, 2), jnp.int32)
    none_ok = jnp.zeros((1, K), bool)
    blocks = jnp.concatenate([none_block, agent_blocks, wall_blocks, asm_blocks, chest_blocks])
    oks = jnp.concatenate([none_ok, agent_ok, wall_ok, asm_ok, chest_ok])
    blocks_c, block_counts = _compact_blocks(blocks, oks)
    off_agent = 1
    off_wall = 1 + A
    off_asm = off_wall + tables.n_object_types
    off_chest = off_asm + tables.n_assembler_slots

    # Static per-scan-position window-coordinate location bytes.
    scan_dr = tables.scan_dr
    scan_dc = tables.scan_dc
    loc_bytes = ((scan_dr + ohr) << 4) | (scan_dc + owr)  # [S]
    S = int(loc_bytes.shape[0])

    map_center_r, map_center_c = H // 2, W // 2

    def render_one(a):
        ar, ac = state.agent_r[a], state.agent_c[a]

        # ---- global token slots (static layout) ----
        g_feats, g_vals, g_ok, g_loc = [], [], [], []
        center_loc = jnp.int32((ohr << 4) | owr)
        if tables.global_episode_completion:
            if tables.max_steps > 0:
                pct = jnp.where(
                    state.step >= tables.max_steps,
                    jnp.int32(255),
                    (256 * state.step) // tables.max_steps,
                )
            else:
                pct = jnp.int32(0)
            g_feats.append(jnp.int32(f["episode_completion_pct"]))
            g_vals.append(pct)
            g_ok.append(jnp.bool_(True))
            g_loc.append(center_loc)
        if tables.global_last_action:
            g_feats.append(jnp.int32(f["last_action"]))
            g_vals.append(executed_actions[a])
            g_ok.append(jnp.bool_(True))
            g_loc.append(center_loc)
        if tables.global_last_reward:
            g_feats.append(jnp.int32(f["last_reward"]))
            g_vals.append(jnp.round(rewards_at_obs[a] * 100.0).astype(jnp.int32))
            g_ok.append(jnp.bool_(True))
            g_loc.append(center_loc)
        if tables.global_goal:
            for r in range(tables.num_resources):
                g_feats.append(jnp.int32(f["goal"]))
                g_vals.append(tables.inv_feature_ids[r, 0])
                g_ok.append(tables.goal_token_mask[a, r])
                g_loc.append(center_loc)
        if tables.global_compass:
            dr = map_center_r - ar
            dc = map_center_c - ac
            sr = jnp.sign(dr)
            sc = jnp.sign(dc)
            has_dir = (sr != 0) | (sc != 0)
            g_feats.append(jnp.int32(f["agent:compass"]))
            g_vals.append(jnp.int32(1))
            g_ok.append(has_dir)
            g_loc.append((((ohr + sr) << 4) | (owr + sc)).astype(jnp.int32))
        if not g_feats:
            g_feats = [jnp.int32(0)]
            g_vals = [jnp.int32(0)]
            g_ok = [jnp.bool_(False)]
            g_loc = [jnp.int32(0)]
        g_feats = jnp.stack(g_feats)
        g_vals = jnp.stack(g_vals)
        g_ok = jnp.stack(g_ok)
        g_loc = jnp.stack(g_loc)
        G = int(g_feats.shape[0])
        # compact globals to the front (stable)
        g_order = jnp.argsort(jnp.where(g_ok, 0, 1), stable=True)
        g_feats = g_feats[g_order]
        g_vals = g_vals[g_order]
        g_loc = g_loc[g_order]
        g_count = jnp.sum(g_ok.astype(jnp.int32))

        # ---- window cells in center-out order ----
        rr = ar + scan_dr
        cc = ac + scan_dc
        in_bounds = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        rs = jnp.clip(rr, 0, H - 1)
        cs = jnp.clip(cc, 0, W - 1)
        a_plus1 = state.agent_grid[rs, cs]
        skind = state.static_kind[rs, cs]
        sidx = state.static_idx[rs, cs]
        stype = state.static_type[rs, cs]

        block_idx = jnp.where(
            ~in_bounds,
            0,
            jnp.where(
                a_plus1 > 0,
                off_agent + a_plus1 - 1,
                jnp.where(
                    skind == KIND_WALL, off_wall + stype,
                    jnp.where(
                        skind == KIND_ASSEMBLER, off_asm + sidx,
                        jnp.where(skind == KIND_CHEST, off_chest + sidx, 0),
                    ),
                ),
            ),
        )
        cell_counts = block_counts[block_idx]                 # [S]
        cum = jnp.cumsum(cell_counts)                         # inclusive, [S]
        cum_excl = cum - cell_counts
        total_cells = cum[-1]

        # ---- per-output-slot gather ----
        t_idx = jnp.arange(T)
        tp = t_idx - g_count                                  # object-token index
        seg = jnp.searchsorted(cum, tp, side="right")         # [T] ∈ [0, S]
        seg_c = jnp.clip(seg, 0, S - 1)
        j = jnp.clip(tp - cum_excl[seg_c], 0, K - 1)
        b_idx = block_idx[seg_c]
        obj_tok = blocks_c[b_idx, j]                          # [T, 2]
        obj_loc = loc_bytes[seg_c]
        obj_valid = (tp >= 0) & (tp < total_cells)

        g_j = jnp.clip(t_idx, 0, G - 1)
        is_global = t_idx < g_count
        feats = jnp.where(is_global, g_feats[g_j], obj_tok[:, 0])
        vals = jnp.where(is_global, g_vals[g_j], obj_tok[:, 1])
        locs = jnp.where(is_global, g_loc[g_j], obj_loc)
        valid = is_global | obj_valid

        out = jnp.stack(
            [locs.astype(jnp.uint8), feats.astype(jnp.uint8), vals.astype(jnp.uint8)],
            axis=-1,
        )
        return jnp.where(valid[:, None], out, jnp.uint8(EMPTY))

    return jax.vmap(render_one)(jnp.arange(A))
