"""Difficulty variants + restored diagnostic objects.

The reference emits resource-specific chests (``chest_<res>``) and
start-clipped extractor variants with unique map_names so diagnostic maps can
place them (``cogs_vs_clips/mission.py:240-283``), plus a difficulty-variant
registry (``evals/difficulty_variants.py``). These tests pin: the objects
exist and are placeable, and every difficulty level builds a runnable env
with its knobs actually applied."""

import numpy as np
import pytest

from metta_tpu.cogames.catalog import get_missions
from metta_tpu.cogames.difficulty import (
    DIFFICULTY_VARIANTS,
    GEAR_BY_TARGET,
    HARD,
    get_difficulty,
)
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.testing import noop_actions


def _base_mission():
    return get_missions()[0]


def test_diagnostic_objects_emitted():
    env_cfg = _base_mission().make_env()
    objs = env_cfg.game.objects
    for res in ("carbon", "oxygen", "germanium", "silicon"):
        assert f"chest_{res}" in objs
        assert objs[f"chest_{res}"].map_name == f"chest_{res}"
        assert objs[f"chest_{res}"].vibe_transfers == {"default": {res: 255}}
        assert f"clipped_{res}_extractor" in objs
        assert objs[f"clipped_{res}_extractor"].start_clipped
        assert not objs[f"{res}_extractor"].start_clipped


def test_clipped_extractor_map_builds_and_runs():
    """A map explicitly placing a clipped extractor + resource chest runs."""
    from metta_tpu.map_builder.ascii import AsciiMapBuilder

    mission = _base_mission()
    cfg = mission.make_env()
    cfg.game.num_agents = 2
    cfg.game.map_builder = AsciiMapBuilder.Config(
        map_data=[
            "##########",
            "#0.x....c#",
            "#1.......#",
            "##########",
        ],
        char_to_map_name={
            "0": "agent.agent", "1": "agent.agent",
            "x": "clipped_carbon_extractor", "c": "chest_carbon",
        },
    )
    cfg.desync_episodes = False
    env = MettaGridEnv(cfg, num_envs=1)
    env.reset(seed=0)
    st = env.env_state()
    assert bool(np.asarray(st.asm_clipped).any()), "extractor starts clipped"
    for _ in range(3):
        env.step(noop_actions(env))


@pytest.mark.parametrize("level", [d.name for d in DIFFICULTY_VARIANTS])
def test_difficulty_levels_build_and_run(level):
    diff = get_difficulty(level)
    mission = diff.apply(_base_mission())
    cfg = mission.make_env()
    cfg.desync_episodes = False
    cfg.game.map_builder.seed = 7
    env = MettaGridEnv(cfg, num_envs=1)
    env.reset(seed=0)
    for _ in range(2):
        env.step(noop_actions(env))


def test_hard_overrides_applied():
    mission = HARD.apply(_base_mission())
    assert mission.carbon_extractor.max_uses == 4
    assert mission.silicon_extractor.max_uses == 3
    assert mission.oxygen_extractor.efficiency == 65
    assert mission.energy_regen_amount == 1
    assert mission.move_energy_cost == 2


@pytest.mark.parametrize("target", list(GEAR_BY_TARGET))
def test_clip_target_filters_unclip_and_adds_gear_protocol(target):
    diff = get_difficulty(f"clipped_{target}")
    mission = diff.apply(_base_mission())
    env_cfg = mission.make_env()
    diff.modify_env(mission, env_cfg)
    gear, res_for_gear = GEAR_BY_TARGET[target]
    protos = env_cfg.game.clipper.unclipping_protocols
    assert [p.input_resources for p in protos] == [{gear: 1}]
    asm = env_cfg.game.objects["assembler"]
    gear_protos = [p for p in asm.protocols if p.vibes == ["gear"]]
    assert gear_protos and gear_protos[-1].input_resources == {res_for_gear: 1}
    assert env_cfg.game.objects[f"{res_for_gear}_extractor"].clip_immune
    assert env_cfg.game.objects[f"{target}_extractor"].start_clipped
