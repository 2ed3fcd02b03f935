"""CPU-vs-GPU engine differential.

CPU-green does not mean correct on the card: XLA compiles another program
there, and a float32 matmul may run in TF32 unless the engine keeps it at
float32 (``engine/xprec.py``). This reruns the arena recipe's trajectory on
the GPU and on the CPU backend of the same process and requires every integer
state field and observation byte to be identical. ``chip_smoke.py`` runs the
same check at E=8 over 64 steps for both env classes.
"""

import pytest

from metta_tpu.differential import engine_differential


@pytest.mark.gpu
def test_engine_trajectory_matches_cpu(gpu):
    from metta_tpu.engine.env import MettaGridEnv
    from recipes.arena_basic_easy_shaped import mettagrid

    cfg = mettagrid()
    cfg.game.map_builder.seed = 123

    def make():
        return MettaGridEnv(cfg, num_envs=4, desync_episodes=False,
                            track_stats=True, step_mode="batched")

    rep = engine_differential(make, gpu, n_steps=64)
    assert rep["step_mode"] == "batched"
    assert rep["mismatches"] == [], rep["mismatches"]
    # identical trajectories prove nothing if both are dead: random play on
    # the seeded arena mines ore and converts it into batteries
    gained = rep["ref_gained"]
    assert gained.get("ore_red", 0) > 0, gained
    assert gained.get("battery_red", 0) > 0, gained
