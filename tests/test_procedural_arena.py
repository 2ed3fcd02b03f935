"""MachinaArena procedural composition + procedural mission variants
(reference ``cogames/cogs_vs_clips/procedural.py``)."""

import numpy as np
import pytest

from metta_tpu.mapgen.scene import render_scene
from metta_tpu.mapgen.scenes_arena import MachinaArena, _autoscale_zone_counts


def test_autoscale_matches_reference_formula():
    # procedural.py:138-146 at density 0.9
    b, d = _autoscale_zone_counts(100, 100, 0.9)
    assert b == max(3, min(48, 10000 // max(800, int(1600 / 0.9))))
    assert d == max(3, min(48, 10000 // max(800, int(1500 / 0.9))))


def test_machina_arena_composition():
    g = render_scene(MachinaArena.Config(spawn_count=8), 96, 96, seed=5)
    flat = g.reshape(-1)
    # spawns placed by the hub
    assert int(np.sum(flat == "agent.agent")) == 8
    # hub core objects present
    for obj in ("assembler", "charger", "chest"):
        assert int(np.sum(flat == obj)) >= 1, obj
    # weighted building scatter hit a nonzero coverage
    buildings = sum(
        int(np.sum(flat == n))
        for n in ("carbon_extractor", "oxygen_extractor",
                  "germanium_extractor", "silicon_extractor", "charger")
    )
    assert buildings >= 10
    # walls from the biome/dungeon layers, but the map is not wall-dominated
    walls = int(np.sum(flat == "wall"))
    assert 0 < walls < flat.size // 2


def test_machina_arena_deterministic():
    a = render_scene(MachinaArena.Config(spawn_count=4), 64, 64, seed=11)
    b = render_scene(MachinaArena.Config(spawn_count=4), 64, 64, seed=11)
    c = render_scene(MachinaArena.Config(spawn_count=4), 64, 64, seed=12)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_machina_arena_knobs():
    cfg = MachinaArena.Config(
        spawn_count=4, base_biome="desert",
        building_weights={"carbon_extractor": 1.0},
        biome_count=3, dungeon_count=3,
        building_coverage=0.03,
    )
    g = render_scene(cfg, 72, 72, seed=3)
    flat = g.reshape(-1)
    # only the weighted building is scattered (hub corners add the other
    # extractor types, exactly 1 per corner)
    assert int(np.sum(flat == "carbon_extractor")) > 3
    for other in ("oxygen_extractor", "germanium_extractor", "silicon_extractor"):
        assert int(np.sum(flat == other)) == 1


def test_unknown_base_biome_rejected():
    with pytest.raises(ValueError, match="base_biome"):
        render_scene(MachinaArena.Config(spawn_count=2, base_biome="lava"),
                     48, 48, seed=0)


def test_mission_site_uses_arena_and_runs():
    """The cogames machina sites build + reset through the real engine."""
    from metta_tpu.cogames.catalog import get_missions
    from metta_tpu.engine.env import MettaGridEnv
    from metta_tpu.testing import noop_actions

    arena_missions = [
        m for m in get_missions()
        if "machina" in m.site.name.lower() or "arena" in m.site.name.lower()
    ]
    assert arena_missions, "no machina/arena site in the catalog"
    cfg = arena_missions[0].make_env()
    cfg.game.map_builder.seed = 9
    cfg.desync_episodes = False
    env = MettaGridEnv(cfg, num_envs=1)
    env.reset(seed=0)
    env.step(noop_actions(env))


def test_procedural_variants():
    from metta_tpu.cogames.catalog import get_missions
    from metta_tpu.cogames.procedural import (
        BaseHubVariant,
        MachinaArenaVariant,
        MapSeedVariant,
    )
    from metta_tpu.mapgen.mapgen import MapGen
    from metta_tpu.mapgen.scenes_arena import MachinaArena as MA

    mission = next(
        m for m in get_missions()
        if isinstance(m.site.map_builder, MapGen.Config)
        and isinstance(m.site.map_builder.instance, MA.Config)
    )

    env = mission.make_env()
    MapSeedVariant(seed=77).modify_env(mission, env)
    assert env.game.map_builder.seed == 77

    v = MachinaArenaVariant(updates={"base_biome": "city", "biome_count": 4})
    assert v.compat(mission)
    v.modify_env(mission, env)
    assert env.game.map_builder.instance.base_biome == "city"
    assert env.game.map_builder.instance.biome_count == 4

    hv = BaseHubVariant(updates={"hub_width": 15})
    assert hv.compat(mission)
    hv.modify_env(mission, env)
    assert env.game.map_builder.instance.hub.hub_width == 15
