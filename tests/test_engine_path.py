"""One engine path on every backend.

Both env classes take their step from ``engine.env.select_step``, which does
not look at the backend: the batched step with the in-vmap renderer on CPU
and GPU alike, the sequential reference step only for what the batched step
does not implement. Below, MultiTaskEnv's step is held to MettaGridEnv's on
combat, arena and navigation maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metta_tpu.builder.envs import make_arena, make_combat, make_navigation
from metta_tpu.engine.env import MettaGridEnv, select_step
from metta_tpu.engine.step import step_env
from metta_tpu.engine.step_batched import step_env_batched
from metta_tpu.engine.taskset import MultiTaskEnv


def _nav():
    cfg = make_navigation(num_agents=2, width=10, height=10)
    cfg.game.map_builder.seed = 5
    return cfg


@pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda"])
@pytest.mark.parametrize("env_cls", ["MettaGridEnv", "MultiTaskEnv"])
def test_step_path_ignores_backend(monkeypatch, backend, env_cls):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if env_cls == "MettaGridEnv":
        env = MettaGridEnv(_nav(), num_envs=2, step_mode="batched")
    else:
        env = MultiTaskEnv([_nav(), _nav()], num_envs=2, step_mode="batched")
    assert env.step_mode == "batched"
    assert select_step(env.tables, "batched") == ("batched", step_env_batched)
    assert not any(k.startswith("_pl") or k == "_fused" for k in vars(env))


def test_select_step_sequential_and_unknown():
    env = MettaGridEnv(_nav(), num_envs=1)
    assert select_step(env.tables, "sequential") == ("sequential", step_env)
    with pytest.raises(ValueError):
        select_step(env.tables, "fused")


def test_select_step_falls_back_for_chest_search():
    env = MettaGridEnv(_nav(), num_envs=1)
    env.tables.chest_search_distance = 2
    assert select_step(env.tables, "batched") == ("sequential", step_env)


MAPS = {
    "combat_seed0": (lambda: make_combat(num_agents=8), 1234, 4, 10, 0, False),
    "combat_seed7": (lambda: make_combat(num_agents=8), 1234, 4, 10, 7, False),
    "combat_full_agents": (lambda: make_combat(num_agents=24), 99, 2, 6, 3, False),
    "arena": (lambda: make_arena(num_agents=8), 5, 4, 10, 1, False),
    "arena_track_gained": (lambda: make_arena(num_agents=8), 6, 2, 8, 2, True),
    "navigation": (lambda: make_navigation(num_agents=4, width=20, height=20), 11, 4, 10, 5, False),
}


@pytest.mark.parametrize("name", list(MAPS))
def test_multitask_env_matches_plain_env(name):
    """MultiTaskEnv reads its tables as data (one set per task); over one
    task its trajectory equals MettaGridEnv's, whose tables are constants,
    byte for byte: observations, rewards, episode ends and env state, with
    out-of-range actions mixed in."""
    make, map_seed, E, steps, seed, track = MAPS[name]
    cfg = make()
    cfg.game.map_builder.seed = map_seed
    mt = MultiTaskEnv([cfg], num_envs=E, desync_episodes=False,
                      track_stats=track, step_mode="batched")
    plain = MettaGridEnv(cfg, num_envs=E, desync_episodes=False,
                         track_stats=track, step_mode="batched")
    assert mt.step_mode == plain.step_mode == "batched"
    n_actions = len(mt.action_names)
    acts = jax.random.randint(jax.random.PRNGKey(seed + 1000), (steps, E, mt.num_agents),
                              -1, n_actions + 1, dtype=jnp.int32)

    def run(reset, step):
        vstate, obs0 = reset(jax.random.PRNGKey(seed))

        def body(vstate, a):
            vstate, *out = step(vstate, a)
            return vstate, out

        vstate, outs = jax.lax.scan(body, vstate, acts)
        return obs0, outs, vstate.env

    ts = mt.tsdata
    got = jax.device_get(jax.jit(lambda: run(lambda k: mt.reset_core(k, ts),
                                             lambda v, a: mt.step_core(v, a, ts)))())
    ref = jax.device_get(jax.jit(lambda: run(plain.reset_core, plain.step_core))())
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got), strict=True):
        np.testing.assert_array_equal(a, b)
