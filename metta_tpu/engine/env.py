"""Vectorized MettaGrid environment.

The on-device replacement for ``MettaGridPufferEnv`` + pufferlib's process
vectorization (``envs/mettagrid_puffer_env.py:60-283``, ``pufferlib/vector.py``):
instead of worker processes and shared-memory buffers, the batch dimension is a
``vmap`` axis and the whole step (actions → simulation → observations) is one
jitted XLA program that never leaves the device.

Auto-reset: envs that terminate/truncate are reset in the same step call and
return the new episode's initial observations (standard vecenv semantics).
Episode desync (reference ``envs/early_reset_handler.py:6-20``): the first
episode of each env instance is truncated at an independent random step.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from metta_tpu.config.mettagrid_config import MettaGridConfig
from metta_tpu.engine.compiler import compile_game
from metta_tpu.engine.state import EnvState
from metta_tpu.engine.step import step_env
from metta_tpu.engine.tables import Tables
from metta_tpu.utils import struct


def select_step(tables: Tables, step_mode: str):
    """The engine's one choice of step path, the same on every backend.

    ``"batched"`` is the rank-arbitrated vectorized step
    (``engine/step_batched.py``) with the observation render inside the
    per-env ``vmap``. It falls back to the sequential reference step
    (``engine/step.py``) for what only that step implements: coupled
    inventory limit groups and chest search (assembler.hpp:96-121).
    Returns ``(mode, step_fn)``; both env classes call this.
    """
    if step_mode not in ("batched", "sequential"):
        raise ValueError(f"unknown step_mode {step_mode!r}")
    if (step_mode == "batched" and tables.inv_vector_ok
            and tables.chest_search_distance <= 0):
        from metta_tpu.engine.step_batched import step_env_batched

        return "batched", step_env_batched
    return "sequential", step_env


@struct.dataclass
class VecEnvState:
    env: EnvState                # batched over E
    desync_step: jnp.ndarray     # [E] int32; >0 = truncate first episode there
    episode_len: jnp.ndarray     # [E] int32 of the last finished episode
    last_episode_reward: jnp.ndarray  # [E, A] f32 of the last finished episode
    last_episode_gained: jnp.ndarray  # [E, R] f32 agent-mean resources gained


class MettaGridEnv:
    """Batched on-device MettaGrid.

    Args:
      cfg: environment config.
      num_envs: batch size E (vmapped).
      seed: PRNG seed for all per-env chains.
      desync_episodes: truncate each env's first episode at a random step.
    """

    def __init__(
        self,
        cfg: MettaGridConfig,
        num_envs: int = 1,
        seed: int = 0,
        desync_episodes: Optional[bool] = None,
        track_stats: bool = True,
        step_mode: str = "sequential",
    ):
        """step_mode: "sequential" (reference-exact shuffled-order agent loop)
        or "batched" (rank-arbitrated vectorized step — the performance path);
        :func:`select_step` makes the choice."""
        self.cfg = cfg
        self.num_envs = num_envs
        game_map = cfg.game.map_builder.create().build()
        self.game_map = game_map
        self.compiled, self._init = compile_game(cfg.game, game_map)
        self.tables = Tables(self.compiled, track_stats=track_stats)
        self.step_mode, _step_env = select_step(self.tables, step_mode)
        self.desync = cfg.desync_episodes if desync_episodes is None else desync_episodes
        self._seed = seed
        self.single_observation_space_shape = (self.compiled.num_obs_tokens, 3)
        self.num_agents = self.compiled.num_agents
        self.action_names = self.compiled.action_names

        tables = self.tables
        init = self._init

        from metta_tpu.engine.step import make_reset_batch, make_reset_template

        # Concrete template (device arrays): reset/step jits embed it as data,
        # keeping their compile time independent of batch size / map size.
        self._template = make_reset_template(tables, init)

        def _stepped(vstate_env, actions):
            """vmapped sim step with the in-vmap obs render → (env, obs)."""
            return jax.vmap(lambda s, a: _step_env(s, a, tables))(vstate_env, actions)

        template = self._template

        def reset_batch(key):
            keys = jax.random.split(key, num_envs)
            env, obs = make_reset_batch(tables, init, keys, template=template)
            if self.desync and tables.max_steps > 0:
                desync = jax.random.randint(
                    jax.random.fold_in(key, 1), (num_envs,), 1, tables.max_steps
                )
            else:
                desync = jnp.zeros((num_envs,), jnp.int32)
            A = tables.num_agents
            R = tables.num_resources
            return VecEnvState(
                env=env,
                desync_step=desync,
                episode_len=jnp.zeros((num_envs,), jnp.int32),
                last_episode_reward=jnp.zeros((num_envs, A), jnp.float32),
                last_episode_gained=jnp.zeros((num_envs, R), jnp.float32),
            ), obs

        def step_batch(vstate: VecEnvState, actions):
            env, obs = _stepped(vstate.env, actions)
            force_trunc = (vstate.desync_step > 0) & (env.step >= vstate.desync_step)
            truncated = env.truncated | force_trunc
            done = env.done
            ended = done | truncated
            rewards = env.reward
            episode_done_len = jnp.where(ended, env.step, vstate.episode_len)
            episode_done_rew = jnp.where(
                ended[:, None], env.episode_reward, vstate.last_episode_reward
            )
            episode_done_gained = jnp.where(
                ended[:, None],
                jnp.mean(env.agent_gained.astype(jnp.float32), axis=1),
                vstate.last_episode_gained,
            )

            # auto-reset ended envs (fresh key from the env's chain). Fields
            # that are invariant across episodes of the same map (static grids,
            # station geometry) are passed through unchanged so the per-step
            # select costs nothing for them.
            fresh, fresh_obs = make_reset_batch(tables, init, env.key, template=template)
            fresh = fresh.replace(
                static_kind=env.static_kind, static_idx=env.static_idx,
                static_type=env.static_type,
                asm_r=env.asm_r, asm_c=env.asm_c, asm_type=env.asm_type,
                asm_valid=env.asm_valid, chest_type=env.chest_type,
                chest_valid=env.chest_valid,
            )
            env = jax.tree.map(
                lambda new, old: old if new is old else jnp.where(
                    jnp.reshape(ended, (-1,) + (1,) * (old.ndim - 1)), new, old
                ),
                fresh, env,
            )
            obs = jnp.where(ended[:, None, None, None], fresh_obs, obs)
            vstate = VecEnvState(
                env=env,
                desync_step=jnp.where(ended, 0, vstate.desync_step),
                episode_len=episode_done_len,
                last_episode_reward=episode_done_rew,
                last_episode_gained=episode_done_gained,
            )
            return vstate, obs, rewards, done, truncated

        def step_batch_no_reset(vstate: VecEnvState, actions):
            """Evaluation stepping: no auto-reset, terminal state (and its
            episode stats) stays readable after the episode ends."""
            env, obs = _stepped(vstate.env, actions)
            vstate = vstate.replace(env=env)
            return vstate, obs, env.reward, env.done, env.truncated

        # unjitted cores, composable inside a larger jitted program (trainer)
        self.reset_core = reset_batch
        self.step_core = step_batch
        self._reset_fn = jax.jit(reset_batch)
        self._step_fn = jax.jit(step_batch)
        self.step_no_reset_core = step_batch_no_reset
        self._step_no_reset_fn = jax.jit(step_batch_no_reset)
        self._state: Optional[VecEnvState] = None

    # ------------------------------------------------------------------
    # functional API (for use inside a jitted training loop)
    # ------------------------------------------------------------------

    def reset_fn(self, key):
        """(key) -> (VecEnvState, obs). Jit-compatible."""
        return self._reset_fn(key)

    def step_fn(self, vstate, actions):
        """(VecEnvState, actions [E, A] int32) -> (VecEnvState, obs, rew, done, trunc)."""
        return self._step_fn(vstate, actions)

    # ------------------------------------------------------------------
    # stateful numpy API (tests, eval, play)
    # ------------------------------------------------------------------

    def reset(self, seed: Optional[int] = None):
        key = jax.random.PRNGKey(self._seed if seed is None else seed)
        self._state, obs = self._reset_fn(key)
        return np.asarray(obs)

    def step(self, actions):
        assert self._state is not None, "call reset() first"
        actions = jnp.asarray(actions, jnp.int32)
        if actions.ndim == 1:
            actions = actions[None, :]
        self._state, obs, rew, done, trunc = self._step_fn(self._state, actions)
        return (
            np.asarray(obs),
            np.asarray(rew),
            np.asarray(done),
            np.asarray(trunc),
        )

    def step_no_reset(self, actions):
        assert self._state is not None, "call reset() first"
        actions = jnp.asarray(actions, jnp.int32)
        if actions.ndim == 1:
            actions = actions[None, :]
        self._state, obs, rew, done, trunc = self._step_no_reset_fn(self._state, actions)
        return (
            np.asarray(obs),
            np.asarray(rew),
            np.asarray(done),
            np.asarray(trunc),
        )

    # --- inspection helpers (parity with MettaGrid debug accessors) ---

    @property
    def state(self) -> VecEnvState:
        return self._state

    def env_state(self, e: int = 0) -> EnvState:
        """Single-env view of the batched state (host copies)."""
        return jax.tree.map(lambda x: np.asarray(x[e]), self._state.env)

    def action_success(self, e: int = 0):
        return np.asarray(self._state.env.action_success[e])

    def episode_rewards(self, e: int = 0):
        return np.asarray(self._state.env.episode_reward[e])

    def resource_id(self, name: str) -> int:
        return self.compiled.resource_names.index(name)

    def vibe_id(self, name: str) -> int:
        return self.compiled.vibe_names.index(name)

    def set_agent_inventory(self, agent: int, inventory: dict, e: int = 0):
        """Debug/test hook (parity: MettaGrid::set_inventory, bindings:959-965).

        Replaces the agent's inventory with the given {resource_name: amount}.
        """
        inv = self._state.env.agent_inv
        row = np.zeros((self.compiled.num_resources,), np.int32)
        for name, amt in inventory.items():
            row[self.resource_id(name)] = amt
        inv = inv.at[e, agent].set(jnp.asarray(row))
        self._state = self._state.replace(env=self._state.env.replace(agent_inv=inv))

    def agent_inventory(self, agent: int, e: int = 0) -> dict:
        row = np.asarray(self._state.env.agent_inv[e, agent])
        return {
            n: int(row[i]) for i, n in enumerate(self.compiled.resource_names) if row[i] != 0
        }

    def set_agent_vibe(self, agent: int, vibe, e: int = 0):
        v = self.vibe_id(vibe) if isinstance(vibe, str) else int(vibe)
        vibes = self._state.env.agent_vibe.at[e, agent].set(v)
        self._state = self._state.replace(env=self._state.env.replace(agent_vibe=vibes))

    def chest_inventory(self, chest: int = 0, e: int = 0) -> dict:
        row = np.asarray(self._state.env.chest_inv[e, chest])
        return {
            n: int(row[i]) for i, n in enumerate(self.compiled.resource_names) if row[i] != 0
        }
