"""World state pytree.

The entire MettaGrid world state is one pytree of stacked arrays, stepped under
``jit``/``vmap``. This replaces the reference's per-instance C++ object graph
(``packages/mettagrid/cpp/include/mettagrid/core/grid.hpp:16-113`` and the
object classes) with a structure-of-arrays layout:

- agents are SoA vectors indexed by agent id (``agent_r``/``agent_c``/
  ``agent_inv``/...),
- a dynamic ``agent_grid [H, W]`` maps cells to agent-index+1 (0 = empty),
- immobile objects (walls/assemblers/chests) live in static-per-episode grids
  ``static_kind [H, W]`` / ``static_idx [H, W]``.

All shapes are compile-time constants from :class:`CompiledConfig`, so the
whole step is a single fused XLA program.
"""

from __future__ import annotations

import jax.numpy as jnp

from metta_tpu.utils import struct

# Cell kinds in static_kind / occupancy queries.
KIND_EMPTY = 0
KIND_AGENT = 1
KIND_WALL = 2
KIND_ASSEMBLER = 3
KIND_CHEST = 4


@struct.dataclass
class EnvState:
    """Per-environment world state (vmapped over the env batch dimension)."""

    # --- episode bookkeeping ---
    step: jnp.ndarray          # [] int32, current_step
    key: jnp.ndarray           # [2] uint32 PRNG key
    done: jnp.ndarray          # [] bool (terminated)
    truncated: jnp.ndarray     # [] bool

    # --- agents (SoA over agent id) ---
    agent_r: jnp.ndarray       # [A] int32
    agent_c: jnp.ndarray       # [A] int32
    agent_prev_r: jnp.ndarray  # [A] int32
    agent_prev_c: jnp.ndarray  # [A] int32
    agent_inv: jnp.ndarray     # [A, R] int32 (0..65535)
    agent_frozen: jnp.ndarray  # [A] int32 (ticks remaining; <0 = permanent)
    agent_vibe: jnp.ndarray    # [A] int32
    agent_steps_without_motion: jnp.ndarray  # [A] int32
    agent_current_stat_reward: jnp.ndarray   # [A] f32
    # stat accumulators backing reward-relevant stats (agent.cpp:70-103)
    agent_gained: jnp.ndarray  # [A, R] int32  (<r>.gained)
    agent_lost: jnp.ndarray    # [A, R] int32  (<r>.lost)
    agent_chest_deposited: jnp.ndarray  # [A, R] int32 (chest.<r>.deposited_by_agent)

    # --- occupancy grids ---
    agent_grid: jnp.ndarray    # [H, W] int32: agent idx+1, 0 = empty
    static_kind: jnp.ndarray   # [H, W] int32: KIND_* for immobile objects
    static_idx: jnp.ndarray    # [H, W] int32: index into the per-kind table
    static_type: jnp.ndarray   # [H, W] int32: object-type id (obs tags/vibe)

    # --- assemblers ---
    asm_r: jnp.ndarray               # [NA] int32 (static per episode)
    asm_c: jnp.ndarray               # [NA] int32
    asm_type: jnp.ndarray            # [NA] int32 -> assembler-type table
    asm_cooldown_end: jnp.ndarray    # [NA] int32
    asm_cooldown_duration: jnp.ndarray  # [NA] int32
    asm_uses: jnp.ndarray            # [NA] int32
    asm_clipped: jnp.ndarray         # [NA] bool
    asm_unclip_proto: jnp.ndarray    # [NA] int32 (index into unclip table, -1)
    asm_valid: jnp.ndarray           # [NA] bool (padding mask)

    # --- chests ---
    chest_inv: jnp.ndarray     # [NC, R] int32
    chest_type: jnp.ndarray    # [NC] int32
    chest_valid: jnp.ndarray   # [NC] bool

    # --- collectives ---
    coll_inv: jnp.ndarray      # [NL, R] int32
    agent_coll: jnp.ndarray    # [A] int32 (-1 unaligned; runtime-mutable via
                               #   align/unalign mutations — alignable.cpp)
    coll_aligned: jnp.ndarray  # [NL, NT] int32 live member counts by type
    coll_deposited: jnp.ndarray  # [NL, R] int32 collective.<r>.deposited
    coll_withdrawn: jnp.ndarray  # [NL, R] int32 collective.<r>.withdrawn

    # --- game-level stat accumulators ---
    game_chest_deposited: jnp.ndarray  # [R] int32
    game_chest_withdrawn: jnp.ndarray  # [R] int32
    game_asm_created: jnp.ndarray      # [R] int32 (assembler.<r>.created)

    # --- per-step outputs ---
    reward: jnp.ndarray            # [A] f32 (this step)
    episode_reward: jnp.ndarray    # [A] f32
    action_success: jnp.ndarray    # [A] bool
    executed_action: jnp.ndarray   # [A] int32 (noop when failed)
