"""The env step's observations are the render of the state it returns:
``render_observations`` applied to each returned env state, with that
state's executed actions and rewards, gives the step's observation bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metta_tpu.builder.envs import make_arena, make_combat, make_navigation
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.engine.obs import render_observations


def _env(cfg):
    cfg.game.map_builder.seed = 77
    return MettaGridEnv(cfg, num_envs=2, seed=3, desync_episodes=False,
                        step_mode="batched")


@pytest.mark.parametrize(
    "maker,kw",
    [
        (make_navigation, dict(num_agents=2, width=12, height=12)),
        (make_arena, dict(num_agents=6)),
        (make_combat, dict(num_agents=8)),
    ],
)
def test_step_obs_is_render_of_state(maker, kw):
    env = _env(maker(**kw))
    tables = env.tables
    render = jax.jit(jax.vmap(
        lambda s: render_observations(s, tables, s.executed_action, s.reward)))
    key = jax.random.PRNGKey(0)
    vstate, _ = env.reset_fn(key)
    for t in range(12):
        key, k = jax.random.split(key)
        acts = jax.random.randint(k, (2, env.num_agents), 0, env.compiled.n_actions,
                                  dtype=jnp.int32)
        vstate, obs, *_ = env.step_fn(vstate, acts)
        np.testing.assert_array_equal(np.asarray(obs), np.asarray(render(vstate.env)),
                                      err_msg=f"step {t}")


def test_reset_obs_is_render_with_no_action_and_reward():
    env = _env(make_navigation(num_agents=2, width=10, height=10))
    vstate, obs = env.reset_fn(jax.random.PRNGKey(1))
    zeros = jnp.zeros((2, env.num_agents), jnp.int32)
    want = jax.vmap(
        lambda s, z: render_observations(s, env.tables, z, z.astype(jnp.float32))
    )(vstate.env, zeros)
    np.testing.assert_array_equal(np.asarray(obs), np.asarray(want))
