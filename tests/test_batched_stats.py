"""Batched-step stat accumulation parity.

The batched step must accumulate the same reward-driving stats as the
sequential step: ``<r>.gained``/``<r>.lost`` (agent.cpp:70-83),
``chest.<r>.deposited/withdrawn/deposited_by_agent`` (chest.hpp:59-66) and
``assembler.<r>.created``. Single-agent scripts are conflict-free, so the two
modes must match exactly, including the stat arrays and stat-driven rewards.
"""

import numpy as np

from metta_tpu.builder import building
from metta_tpu.config.mettagrid_config import (
    ActionsConfig,
    AgentConfig,
    AgentRewards,
    ChestConfig,
    InventoryConfig,
    MoveActionConfig,
    NoopActionConfig,
)
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.testing import make_test_config


def _pair(map_str, **kw):
    cfg = make_test_config(map_str, **kw)
    seq = MettaGridEnv(cfg, num_envs=1, step_mode="sequential", desync_episodes=False)
    bat = MettaGridEnv(cfg, num_envs=1, step_mode="batched", desync_episodes=False)
    assert bat.step_mode == "batched", "config unexpectedly fell back to sequential"
    return seq, bat


def _run_script(env, actions_per_step):
    env.reset(seed=0)
    rewards = []
    for acts in actions_per_step:
        obs, rew, done, trunc = env.step(np.asarray([acts], np.int32))
        rewards.append(rew.copy())
    return np.concatenate(rewards), env.env_state()


def test_gained_reward_matches_sequential():
    """An agent crafting hearts at an assembler earns heart.gained rewards
    identically in both step modes."""
    m = """
######
#0.Z.#
######
"""
    cfg_kw = dict(
        objects={"assembler": building.nav_assembler.model_copy()},
        char_to_map_name={"Z": "assembler"},
        actions=ActionsConfig(
            move=MoveActionConfig(), noop=NoopActionConfig()
        ),
        agent=AgentConfig(rewards=AgentRewards(stats={"heart.gained": 1.0})),
        max_steps=100,
        resource_names=["heart"],
    )
    seq, bat = _pair(m, **cfg_kw)
    right = seq.action_names.index("move_east")
    noop = seq.action_names.index("noop")
    script = [[right], [noop], [right], [noop], [right], [noop]]
    rew_s, st_s = _run_script(seq, script)
    rew_b, st_b = _run_script(bat, script)
    assert rew_s.sum() > 0, "script should have earned heart.gained reward"
    np.testing.assert_allclose(rew_s, rew_b)
    np.testing.assert_array_equal(st_s.agent_gained, st_b.agent_gained)
    np.testing.assert_array_equal(st_s.agent_lost, st_b.agent_lost)
    np.testing.assert_array_equal(st_s.game_asm_created, st_b.game_asm_created)


def test_chest_stats_match_sequential():
    """Chest deposit stats (game + per-agent) accumulate identically."""
    m = """
######
#0.C.#
######
"""
    chest = ChestConfig(
        name="chest",
        vibe_transfers={"default": {"heart": 2}},
    )
    cfg_kw = dict(
        objects={"chest": chest},
        char_to_map_name={"C": "chest"},
        actions=ActionsConfig(move=MoveActionConfig(), noop=NoopActionConfig()),
        agent=AgentConfig(
            inventory=InventoryConfig(initial={"heart": 5}),
            rewards=AgentRewards(stats={"chest.heart.deposited": 0.5}),
        ),
        max_steps=100,
        resource_names=["heart"],
    )
    seq, bat = _pair(m, **cfg_kw)
    right = seq.action_names.index("move_east")
    noop = seq.action_names.index("noop")
    script = [[right], [right], [noop], [right]]
    rew_s, st_s = _run_script(seq, script)
    rew_b, st_b = _run_script(bat, script)
    assert st_s.game_chest_deposited.sum() > 0, "script should have deposited"
    np.testing.assert_allclose(rew_s, rew_b)
    np.testing.assert_array_equal(st_s.game_chest_deposited, st_b.game_chest_deposited)
    np.testing.assert_array_equal(st_s.game_chest_withdrawn, st_b.game_chest_withdrawn)
    np.testing.assert_array_equal(
        st_s.agent_chest_deposited, st_b.agent_chest_deposited
    )
    np.testing.assert_array_equal(st_s.agent_gained, st_b.agent_gained)
    np.testing.assert_array_equal(st_s.agent_lost, st_b.agent_lost)


def test_multiagent_crafting_stats_finite_and_conserved():
    """Multi-agent batched crafting: gained − lost equals net inventory change."""
    m = """
########
#0.Z.1.#
#2...3.#
########
"""
    cfg_kw = dict(
        objects={"assembler": building.nav_assembler.model_copy()},
        char_to_map_name={"Z": "assembler"},
        actions=ActionsConfig(move=MoveActionConfig(), noop=NoopActionConfig()),
        agent=AgentConfig(rewards=AgentRewards(stats={"heart.gained": 1.0})),
        max_steps=200,
        resource_names=["heart"],
    )
    cfg = make_test_config(m, **cfg_kw)
    env = MettaGridEnv(cfg, num_envs=2, step_mode="batched", desync_episodes=False)
    assert env.step_mode == "batched"
    rng = np.random.default_rng(0)
    env.reset(seed=0)
    for _ in range(40):
        acts = rng.integers(0, env.compiled.n_actions, (2, 4)).astype(np.int32)
        env.step(acts)
    for e in range(2):
        s = env.env_state(e)
        np.testing.assert_array_equal(
            s.agent_gained.astype(np.int64) - s.agent_lost.astype(np.int64),
            s.agent_inv.astype(np.int64),
        )
