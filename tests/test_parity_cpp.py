"""Differential harness vs the reference C++ engine (BASELINE.md correctness
target).

Drives the *actual* reference engine (built from
``/root/reference/packages/mettagrid``, see ``oracle_support.py``) and our
pure-JAX engine with identical maps and injected action streams, comparing
per step: observation bytes, step rewards, action success, and episode
rewards. Single-agent (and conflict-free multi-agent) trajectories are fully
deterministic in both engines — the only engine RNG (per-step agent-order
shuffle, ``mettagrid_c.cpp:591-593``) cannot affect them — so the comparison
is exact, byte-for-byte.

Skipped automatically when the oracle can't be built (no toolchain).
"""

from __future__ import annotations

import numpy as np
import pytest

from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.testing import make_test_config

from oracle_support import oracle_available

pytestmark = pytest.mark.skipif(
    not oracle_available(), reason="reference C++ oracle unavailable"
)


# ---------------------------------------------------------------------------
# pair construction
# ---------------------------------------------------------------------------


def _ref():
    import mettagrid.builder.building as building
    from mettagrid.config import mettagrid_config as M
    from mettagrid.map_builder.ascii import AsciiMapBuilder
    from mettagrid.simulator.simulator import Simulation

    return building, M, AsciiMapBuilder, Simulation


def make_nav_pair(map_lines, max_steps=60):
    """Single-agent navigation (staged config 1): walls + heart assembler."""
    from metta_tpu.builder import building as my_building
    from metta_tpu.config.mettagrid_config import (
        ActionsConfig,
        AgentConfig,
        AgentRewards,
        ChangeVibeActionConfig,
        MoveActionConfig,
        NoopActionConfig,
    )

    my_cfg = make_test_config(
        "\n".join(map_lines),
        objects={"assembler": my_building.nav_assembler.model_copy(update={"name": "assembler"})},
        char_to_map_name={"Z": "assembler"},
        actions=ActionsConfig(
            move=MoveActionConfig(),
            noop=NoopActionConfig(),
            change_vibe=ChangeVibeActionConfig(enabled=False),
        ),
        agent=AgentConfig(rewards=AgentRewards(inventory={"heart": 1})),
        max_steps=max_steps,
        resource_names=["heart"],
    )

    building, M, AsciiMapBuilder, Simulation = _ref()
    nav_assembler = building.AssemblerConfig(
        name="assembler",
        protocols=[
            building.ProtocolConfig(
                input_resources={}, output_resources={"heart": 1}, cooldown=255
            )
        ],
    )
    ref_cfg = M.MettaGridConfig(
        game=M.GameConfig(
            num_agents=1,
            max_steps=max_steps,
            objects={"assembler": nav_assembler, "wall": building.wall},
            resource_names=["heart"],
            actions=M.ActionsConfig(
                move=M.MoveActionConfig(),
                noop=M.NoopActionConfig(),
                change_vibe=M.ChangeVibeActionConfig(enabled=False),
            ),
            agent=M.AgentConfig(rewards=M.AgentRewards(inventory={"heart": 1})),
            map_builder=AsciiMapBuilder.Config(
                map_data=[list(l) for l in map_lines],
                char_to_map_name={"0": "agent.agent", "Z": "assembler"},
            ),
        )
    )
    return my_cfg, ref_cfg


def make_economy_pair(map_lines, num_agents, max_steps=80):
    """Conflict-free economy (staged config 2): mine → generator → assembler."""
    from metta_tpu.builder import building as my_building
    from metta_tpu.config.mettagrid_config import (
        ActionsConfig,
        AgentConfig,
        AgentRewards,
        ChangeVibeActionConfig,
        InventoryConfig,
        MoveActionConfig,
        NoopActionConfig,
    )

    my_objects = {
        "assembler": my_building.assembler_assembler.model_copy(update={"name": "assembler"}),
        "mine_red": my_building.assembler_mine_red.model_copy(update={"name": "mine_red"}),
        "generator_red": my_building.assembler_generator_red.model_copy(
            update={"name": "generator_red"}
        ),
    }
    legend = {"Z": "assembler", "m": "mine_red", "g": "generator_red"}
    my_cfg = make_test_config(
        "\n".join(map_lines),
        objects=my_objects,
        char_to_map_name=legend,
        actions=ActionsConfig(
            move=MoveActionConfig(),
            noop=NoopActionConfig(),
            change_vibe=ChangeVibeActionConfig(enabled=False),
        ),
        agent=AgentConfig(
            inventory=InventoryConfig(default_limit=50),
            rewards=AgentRewards(inventory={"heart": 1, "ore_red": 0.1, "battery_red": 0.8}),
        ),
        max_steps=max_steps,
    )

    building, M, AsciiMapBuilder, Simulation = _ref()
    ref_legend = {str(d): "agent.agent" for d in range(10)}
    ref_legend.update({"#": "wall", ".": "empty", **legend})
    ref_cfg = M.MettaGridConfig(
        game=M.GameConfig(
            num_agents=num_agents,
            max_steps=max_steps,
            objects={
                "assembler": building.assembler_assembler,
                "mine_red": building.assembler_mine_red,
                "generator_red": building.assembler_generator_red,
                "wall": building.wall,
            },
            actions=M.ActionsConfig(
                move=M.MoveActionConfig(),
                noop=M.NoopActionConfig(),
                change_vibe=M.ChangeVibeActionConfig(enabled=False),
            ),
            agent=M.AgentConfig(
                inventory=M.InventoryConfig(default_limit=50),
                rewards=M.AgentRewards(
                    inventory={"heart": 1, "ore_red": 0.1, "battery_red": 0.8}
                ),
            ),
            map_builder=AsciiMapBuilder.Config(
                map_data=[list(l) for l in map_lines], char_to_map_name=ref_legend
            ),
        )
    )
    return my_cfg, ref_cfg


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def run_differential(my_cfg, ref_cfg, scripts, *, check_obs=True, step_mode="sequential"):
    """scripts: list over steps of list over agents of action *names*."""
    _, _, _, Simulation = _ref()

    env = MettaGridEnv(my_cfg, num_envs=1, step_mode=step_mode, desync_episodes=False)
    env.reset(seed=0)
    sim = Simulation(ref_cfg, seed=123)

    ref_names = list(sim.action_ids.keys())
    assert list(env.action_names) == ref_names, (
        f"action-order contract broken: {env.action_names} vs {ref_names}"
    )

    A = env.num_agents
    my_ep_reward = np.zeros((A,), np.float64)
    ref_ep_reward = np.zeros((A,), np.float64)

    for t, step_actions in enumerate(scripts):
        ids = np.asarray(
            [env.action_names.index(n) for n in step_actions], np.int32
        )
        for a in range(A):
            sim._c_sim.actions()[a] = ids[a]
        sim.step()
        obs_mine, rew_mine, done, trunc = env.step_no_reset(ids[None, :])

        ref_obs = np.asarray(sim._c_sim.observations())
        ref_rew = np.asarray(sim._c_sim.rewards())
        ref_succ = np.asarray(sim._c_sim.action_success())

        np.testing.assert_allclose(
            rew_mine[0], ref_rew, rtol=0, atol=1e-6, err_msg=f"step {t} rewards"
        )
        np.testing.assert_array_equal(
            np.asarray(env.action_success(0)), ref_succ, err_msg=f"step {t} success"
        )
        if check_obs:
            np.testing.assert_array_equal(
                obs_mine[0], ref_obs, err_msg=f"step {t} obs bytes"
            )
        my_ep_reward += np.asarray(rew_mine[0], np.float64)
        ref_ep_reward += ref_rew.astype(np.float64)

    np.testing.assert_allclose(my_ep_reward, ref_ep_reward, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(env.episode_rewards(0)),
        np.asarray(sim._c_sim.get_episode_rewards()),
        atol=1e-5,
    )
    return env, sim


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

NAV_MAP = [
    "##########",
    "#0.....#.#",
    "#.####...#",
    "#....#.Z.#",
    "#.##.#...#",
    "#........#",
    "##########",
]


def _nav_script(env_names, steps, seed):
    rng = np.random.default_rng(seed)
    names = [n for n in env_names]
    return [[names[rng.integers(len(names))]] for _ in range(steps)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_navigation_bit_exact(seed):
    my_cfg, ref_cfg = make_nav_pair(NAV_MAP)
    env = MettaGridEnv(my_cfg, num_envs=1)
    script = _nav_script(env.action_names, 50, seed)
    run_differential(my_cfg, ref_cfg, script)


@pytest.mark.parametrize("step_mode", ["sequential", "batched"])
def test_navigation_bit_exact_batched(step_mode):
    """The batched step mode is also exact for conflict-free play."""
    my_cfg, ref_cfg = make_nav_pair(NAV_MAP)
    env = MettaGridEnv(my_cfg, num_envs=1)
    script = _nav_script(env.action_names, 40, 7)
    run_differential(my_cfg, ref_cfg, script, step_mode=step_mode)


ECON_MAP = [
    "############",
    "#0.m...g.Z.#",
    "#..........#",
    "#1.m...g.Z.#",
    "############",
]


def test_economy_two_agents_bit_exact():
    """Two agents working disjoint rows: order-independent, exact."""
    my_cfg, ref_cfg = make_economy_pair(ECON_MAP, num_agents=2)
    # scripted: both walk east to mine, bump it, continue to generator, bump,
    # continue to assembler, bump; interleave noops
    def row_script(reps):
        seq = []
        for _ in range(reps):
            seq += ["move_east", "move_east", "noop"]
        return seq

    s0 = row_script(8)
    script = [[a, a] for a in s0]
    run_differential(my_cfg, ref_cfg, script)


def test_economy_random_walk_bit_exact():
    """Random walks in disjoint half-maps stay conflict-free and exact."""
    my_cfg, ref_cfg = make_economy_pair(ECON_MAP, num_agents=2)
    env = MettaGridEnv(my_cfg, num_envs=1)
    rng = np.random.default_rng(3)
    moves = [n for n in env.action_names if n.startswith("move_") and
             ("north" not in n and "south" not in n)] + ["noop"]
    script = [
        [moves[rng.integers(len(moves))], moves[rng.integers(len(moves))]]
        for _ in range(40)
    ]
    run_differential(my_cfg, ref_cfg, script)


TRUNC_MAP = [
    "##########",
    "###.##.###",
    "##.#0.#.##",
    "###.##..##",
    "##...Z.###",
    "##########",
]


@pytest.mark.parametrize("num_tokens", [12, 20])
def test_obs_truncation_order_bit_exact(num_tokens):
    """Token truncation follows the center-out scan contract exactly
    (packed_coordinate.hpp:74-140): with a dense wall pocket and a tiny
    token budget, the kept/dropped token set and ORDER must match the
    reference engine byte for byte."""
    my_cfg, ref_cfg = make_nav_pair(TRUNC_MAP)
    my_cfg.game.obs.num_tokens = num_tokens
    ref_cfg.game.obs.num_tokens = num_tokens
    env = MettaGridEnv(my_cfg, num_envs=1)
    script = _nav_script(env.action_names, 30, 11)
    run_differential(my_cfg, ref_cfg, script)
