"""The CPU-vs-device differential's comparison finds what it must find."""

import jax
import numpy as np

from metta_tpu.differential import bf16_ulps, compare_trees, engine_differential


def _tree():
    return {"grid": np.arange(12, dtype=np.int32).reshape(3, 4),
            "obs": np.full((2, 5, 3), 255, np.uint8),
            "done": np.array([True, False]),
            "reward": np.array([0.5, 1.0, 0.0], np.float32)}


def test_compare_trees_accepts_identical_and_rtol():
    ref = _tree()
    got = _tree()
    got["reward"] = ref["reward"] * np.float32(1 + 5e-7)
    assert compare_trees(ref, got, rtol=1e-6) == []


def test_compare_trees_finds_planted_divergence():
    ref = _tree()
    for key, plant in (("grid", lambda a: a.__setitem__((2, 1), 99)),
                       ("obs", lambda a: a.__setitem__((1, 4, 2), 7)),
                       ("done", lambda a: a.__setitem__(1, True)),
                       ("reward", lambda a: a.__setitem__(0, 0.5001))):
        got = _tree()
        plant(got[key])
        mism = compare_trees(ref, got, rtol=1e-6, label="env")
        assert len(mism) == 1 and key in mism[0], mism
    got = _tree()
    got["grid"] = got["grid"].astype(np.int64)
    assert "int32" in compare_trees(ref, got)[0]


def test_bf16_ulps_scale():
    ref = np.array([0.0, 3.0], np.float32)
    assert bf16_ulps(ref, ref) == 0.0
    # scale 3.0 -> ulp 2^(1-7); an error of two ulps reads 2
    assert bf16_ulps(ref, ref + np.float32(2 * 2.0 ** -6)) == 2.0


def test_engine_differential_reports_live_play():
    """CPU against itself: no mismatch, and the report shows that random
    play on the seeded arena mined ore and converted it."""
    from metta_tpu.engine.env import MettaGridEnv
    from recipes.arena_basic_easy_shaped import mettagrid

    cfg = mettagrid()
    cfg.game.map_builder.seed = 123
    rep = engine_differential(
        lambda: MettaGridEnv(cfg, num_envs=4, desync_episodes=False, track_stats=True,
                             step_mode="batched"),
        jax.devices("cpu")[0], n_steps=64)
    assert rep["mismatches"] == []
    assert rep["ref_gained"].get("ore_red", 0) > 0, rep["ref_gained"]
    assert rep["ref_gained"].get("battery_red", 0) > 0, rep["ref_gained"]
