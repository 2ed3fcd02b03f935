"""Combat differential harness vs the reference C++ engine.

Extends ``test_parity_cpp.py`` to the combat mechanics (staged configs 3-4 of
BASELINE.md): attack/weapon/armor/defense/freeze/loot (``attack.hpp:143-224``),
the vibe-transfer matrix, and frozen-swap.

Combat steps are order-dependent by construction — even an idle victim's
noop outcome depends on whether it acted before or after being frozen that
step (the reference shuffles agent order per step with ``std::mt19937``,
``mettagrid_c.cpp:591-593``). So instead of replicating the RNG stream, our
sequential step takes an injected permutation (``step_env(..., perm=)``) and
the runner enumerates all A! orders per step: the reference's full observable
outcome (obs bytes, rewards, success flags) must match at least one order,
all matching orders must agree on the ENTIRE resulting engine state, and that
state carries to the next step. Any semantic divergence — damage math, loot
direction, freeze bookkeeping, swap rules — fails for every permutation.

Skipped automatically when the oracle can't be built.
"""

from __future__ import annotations

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.engine.step import step_env
from metta_tpu.testing import make_test_config

from oracle_support import oracle_available
from test_parity_cpp import _ref, run_differential

pytestmark = pytest.mark.skipif(
    not oracle_available(), reason="reference C++ oracle unavailable"
)

RESOURCES = ["heart", "ore_red", "battery_red"]


def make_combat_pair(
    map_lines,
    num_agents,
    *,
    max_steps=40,
    freeze=4,
    loot=("heart",),
    defense=None,
    armor=None,
    weapon=None,
    vibe_bonus=None,
    initial=None,
    transfers=None,
    freeze_duration=4,
):
    """Mirror-configured (ours, reference) combat envs.

    attack vibe: "swords"; transfer vibes per ``transfers``
    [(vibe, actor_delta, target_delta)].
    """
    import metta_tpu.config.mettagrid_config as my
    from metta_tpu.config.mettagrid_config import (
        ActionsConfig,
        AgentConfig,
        AgentRewards,
        AttackActionConfig,
        AttackOutcome,
        InventoryConfig,
        MoveActionConfig,
        NoopActionConfig,
        TransferActionConfig,
        VibeTransfer,
    )

    defense = defense or {}
    armor = armor or {}
    weapon = weapon or {}
    vibe_bonus = vibe_bonus or {}
    initial = initial or {}
    transfers = transfers or []

    my_cfg = make_test_config(
        "\n".join(map_lines),
        num_agents=num_agents,
        actions=ActionsConfig(
            move=MoveActionConfig(),
            noop=NoopActionConfig(),
            attack=AttackActionConfig(
                enabled=True,
                vibes=["swords"],
                defense_resources=defense,
                armor_resources=armor,
                weapon_resources=weapon,
                vibe_bonus=vibe_bonus,
                success=AttackOutcome(freeze=freeze, loot=list(loot)),
            ),
            transfer=TransferActionConfig(
                enabled=bool(transfers),
                vibe_transfers=[
                    VibeTransfer(vibe=v, actor=a, target=t)
                    for (v, a, t) in transfers
                ],
            ),
        ),
        agent=AgentConfig(
            freeze_duration=freeze_duration,
            inventory=InventoryConfig(default_limit=50, initial=dict(initial)),
            rewards=AgentRewards(
                inventory={"heart": 1, "ore_red": 0.1, "battery_red": 0.3}
            ),
        ),
        max_steps=max_steps,
        resource_names=list(RESOURCES),
    )

    building, M, AsciiMapBuilder, Simulation = _ref()
    ref_legend = {str(d): "agent.agent" for d in range(10)}
    ref_legend.update({"#": "wall", ".": "empty"})
    ref_cfg = M.MettaGridConfig(
        game=M.GameConfig(
            num_agents=num_agents,
            max_steps=max_steps,
            resource_names=list(RESOURCES),
            objects={"wall": building.wall},
            actions=M.ActionsConfig(
                move=M.MoveActionConfig(),
                noop=M.NoopActionConfig(),
                attack=M.AttackActionConfig(
                    enabled=True,
                    vibes=["swords"],
                    defense_resources=defense,
                    armor_resources=armor,
                    weapon_resources=weapon,
                    vibe_bonus=vibe_bonus,
                    success=M.AttackOutcome(freeze=freeze, loot=list(loot)),
                ),
                transfer=M.TransferActionConfig(
                    enabled=bool(transfers),
                    vibe_transfers=[
                        M.VibeTransfer(vibe=v, actor=a, target=t)
                        for (v, a, t) in transfers
                    ],
                ),
            ),
            agent=M.AgentConfig(
                freeze_duration=freeze_duration,
                inventory=M.InventoryConfig(
                    default_limit=50, initial=dict(initial)
                ),
                rewards=M.AgentRewards(
                    inventory={"heart": 1, "ore_red": 0.1, "battery_red": 0.3}
                ),
            ),
            map_builder=AsciiMapBuilder.Config(
                map_data=[list(l) for l in map_lines],
                char_to_map_name=ref_legend,
            ),
        )
    )
    return my_cfg, ref_cfg


# ---------------------------------------------------------------------------
# permutation-enumeration runner
# ---------------------------------------------------------------------------


def run_differential_perm(my_cfg, ref_cfg, script, *, ref_seed=77,
                          require_order_dependence=True):
    """Per step: enumerate all A! agent orders through our sequential step,
    require the reference outcome to match ≥1 order AND all matching orders
    to agree on the full engine state; continue from it. Returns the number
    of steps whose outcome was order-dependent (unique matching order)."""
    _, _, _, Simulation = _ref()

    env = MettaGridEnv(my_cfg, num_envs=1, step_mode="sequential",
                       desync_episodes=False)
    env.reset(seed=0)
    sim = Simulation(ref_cfg, seed=ref_seed)
    ref_names = list(sim.action_ids.keys())
    assert list(env.action_names) == ref_names, (
        f"action-order contract broken ({len(env.action_names)} vs "
        f"{len(ref_names)} actions)"
    )

    tables = env.tables
    A = env.num_agents
    step_perm = jax.jit(
        lambda st, acts, perm: step_env(st, acts, tables, perm=perm)
    )
    state = jax.tree.map(lambda x: x[0], env.state.env)

    n_order_dependent = 0
    for t, step_actions in enumerate(script):
        ids = np.asarray([ref_names.index(n) for n in step_actions], np.int32)
        for a in range(A):
            sim._c_sim.actions()[a] = ids[a]
        sim.step()
        ref_obs = np.asarray(sim._c_sim.observations())
        ref_rew = np.asarray(sim._c_sim.rewards())
        ref_succ = np.asarray(sim._c_sim.action_success())

        matches = []
        for perm in itertools.permutations(range(A)):
            st2, obs2 = step_perm(
                state, jnp.asarray(ids), jnp.asarray(perm, jnp.int32)
            )
            ok = (
                np.array_equal(np.asarray(st2.action_success), ref_succ)
                and np.allclose(np.asarray(st2.reward), ref_rew, atol=1e-6)
                and np.array_equal(np.asarray(obs2), ref_obs)
            )
            if ok:
                matches.append((perm, st2))
        assert matches, (
            f"step {t} ({step_actions}): no agent order reproduces the "
            f"reference outcome"
        )
        # order-dependent = some order produced a DIFFERENT outcome than the
        # reference's (the order mattered and the reference's was identified)
        if len(matches) < math.factorial(A):
            n_order_dependent += 1
        if len(matches) > 1:
            # ambiguity is fine only if the resulting states are identical
            flat0 = jax.tree.leaves(matches[0][1])
            for _, stx in matches[1:]:
                for l0, lx in zip(flat0, jax.tree.leaves(stx)):
                    np.testing.assert_array_equal(
                        np.asarray(l0), np.asarray(lx),
                        err_msg=f"step {t}: matching orders diverge in state",
                    )
        state = matches[0][1]

    np.testing.assert_allclose(
        np.asarray(state.episode_reward),
        np.asarray(sim._c_sim.get_episode_rewards()),
        atol=1e-5,
    )
    if require_order_dependence:
        assert n_order_dependent > 0, (
            "scenario never exercised order-dependent semantics"
        )
    return n_order_dependent


# two disjoint attacker→victim pairs in separate corridors
PAIRS_MAP = [
    "#########",
    "#0.1....#",
    "#########",
    "#2.3....#",
    "#########",
]

ARM = "change_vibe_swords"


def test_attack_loot_freeze_differential():
    """Disjoint attacks: freeze applied, loot transferred, freeze decay and
    re-attack — attack.hpp:143-224 semantics under every agent order."""
    my_cfg, ref_cfg = make_combat_pair(
        PAIRS_MAP, 4, initial={"heart": 2}, loot=("heart",), freeze=4
    )
    script = [
        [ARM, "noop", ARM, "noop"],
        ["move_east", "noop", "move_east", "noop"],   # step adjacent
        ["move_east", "noop", "move_east", "noop"],   # attack (freeze+loot)
        ["noop", "noop", "noop", "noop"],
        ["noop", "move_east", "noop", "move_east"],   # mid-freeze move fails
        ["noop", "noop", "noop", "noop"],
        ["noop", "noop", "noop", "noop"],
        ["noop", "move_east", "noop", "move_east"],   # thawed: succeeds
        ["move_east", "noop", "move_east", "noop"],   # chase + re-attack
        ["move_east", "noop", "move_east", "noop"],
    ]
    run_differential_perm(my_cfg, ref_cfg, script)


def test_attack_defense_weapon_armor_differential():
    """Defense math: cost_to_defend = defense + max(weapon-armor, 0) per
    item; blocked attacks consume the defender's resources
    (attack.hpp:158-198)."""
    my_cfg, ref_cfg = make_combat_pair(
        PAIRS_MAP,
        4,
        initial={"heart": 1, "ore_red": 3, "battery_red": 3},
        defense={"battery_red": 1},
        weapon={"ore_red": 1},
        armor={"battery_red": 1},
        loot=("heart", "ore_red"),
        freeze=3,
    )
    script = [
        [ARM, "noop", ARM, "noop"],
        ["move_east", "noop", "move_east", "noop"],
        ["move_east", "noop", "move_east", "noop"],   # attack vs defense
        ["move_east", "noop", "move_east", "noop"],   # repeat until battery gone
        ["move_east", "noop", "move_east", "noop"],
        ["move_east", "noop", "move_east", "noop"],
        ["noop", "noop", "noop", "noop"],
        ["move_east", "noop", "move_east", "noop"],
    ]
    run_differential_perm(my_cfg, ref_cfg, script)


def test_frozen_swap_differential():
    """Moving onto a frozen agent swaps positions (move/swap semantics)."""
    my_cfg, ref_cfg = make_combat_pair(
        PAIRS_MAP, 4, initial={"heart": 1}, freeze=6, freeze_duration=6
    )
    script = [
        [ARM, "noop", ARM, "noop"],
        ["move_east", "noop", "move_east", "noop"],
        ["move_east", "noop", "move_east", "noop"],   # freeze victims
        ["change_vibe_heart_a", "noop", "change_vibe_heart_a", "noop"],
        ["move_east", "noop", "move_east", "noop"],   # swap with frozen victim
        ["move_east", "noop", "move_east", "noop"],
        ["noop", "noop", "noop", "noop"],
    ]
    run_differential_perm(my_cfg, ref_cfg, script)


def test_transfer_matrix_differential():
    """Vibe transfer: moving onto an agent with a matching vibe applies the
    actor/target inventory deltas (transfer matrix semantics)."""
    my_cfg, ref_cfg = make_combat_pair(
        PAIRS_MAP,
        4,
        initial={"heart": 3, "ore_red": 2},
        transfers=[
            ("heart_a", {"heart": -1}, {"heart": 1}),      # gift a heart
            ("money", {"ore_red": -2}, {"ore_red": 2}),    # pay ore
        ],
    )
    script = [
        ["change_vibe_heart_a", "noop", "change_vibe_money", "noop"],
        ["move_east", "noop", "move_east", "noop"],
        ["move_east", "noop", "move_east", "noop"],   # transfer
        ["move_east", "noop", "move_east", "noop"],   # again (limits path)
        ["noop", "noop", "noop", "noop"],
        ["change_vibe_money", "noop", "change_vibe_heart_a", "noop"],
        ["move_east", "noop", "move_east", "noop"],
        ["noop", "noop", "noop", "noop"],
    ]
    # transfers don't freeze, so steps may be fully order-free
    run_differential_perm(my_cfg, ref_cfg, script,
                          require_order_dependence=False)


# two attackers flanking one victim: genuinely contested
FLANK_MAP = [
    "#####",
    "#012#",
    "#####",
]


def test_contested_attack_differential():
    """Two attackers strike the same victim in one step: who lands the hit,
    who gets the loot, and what the loser's move does are all decided by the
    agent order — the reference outcome must match exactly one of ours."""
    my_cfg, ref_cfg = make_combat_pair(
        FLANK_MAP, 3, initial={"heart": 2}, loot=("heart",), freeze=3,
        max_steps=30,
    )
    script = [
        [ARM, "noop", ARM],
        ["move_east", "noop", "move_west"],   # contested attack
        ["noop", "noop", "noop"],
        ["move_east", "noop", "move_west"],   # strike again mid-freeze
        ["noop", "noop", "noop"],
        ["noop", "noop", "noop"],
        ["move_east", "noop", "move_west"],
    ]
    run_differential_perm(my_cfg, ref_cfg, script)
