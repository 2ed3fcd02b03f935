"""Multi-task vectorized environment: per-env, per-episode curriculum tasks.

Reference parity: ``CurriculumEnv`` (``cogworks/curriculum/curriculum_env.py``)
wraps each env instance and swaps its task (a full env config) at every
episode boundary, sampling from the curriculum's learning-progress weights.

The on-device equivalent: a task *set* is K compiled configs whose
:class:`Tables` are stacked along a leading axis (Tables is a registered
pytree whose statics — shapes, subsystem gates — must agree across the set,
which is exactly the "one compiled program" condition). Each env in the
batch carries a ``task_id``; the step gathers that env's table rows inside
the ``vmap``, and episode resets sample a fresh task id from *runtime*
sampling weights. Task swaps, weight updates, and even replacing a task's
tables in a slot (pool eviction) are pure data — zero recompiles.

Constraints (asserted at build): all tasks share map shape, agent count,
action space, obs geometry, and subsystem usage (the pytree aux). Tasks may
differ in any table *values*: maps (static grids live in the per-env state),
rewards, costs, protocols, regen, vibes, etc.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from metta_tpu.config.mettagrid_config import MettaGridConfig
from metta_tpu.engine.compiler import compile_game
from metta_tpu.engine.env import select_step
from metta_tpu.engine.state import EnvState
from metta_tpu.engine.step import make_reset_template
from metta_tpu.engine.tables import Tables
from metta_tpu.utils import struct


@struct.dataclass
class TaskSetData:
    """Runtime (traced) view of the task set — pass through jit boundaries."""
    tables: Tables            # arrays stacked [K, ...]; statics shared
    template: EnvState        # reset-target state per task, stacked [K, ...]
    obs1: jnp.ndarray         # [K, A, T, 3] uint8 initial observations
    start_clipped: jnp.ndarray  # [K, NA] bool
    weights: jnp.ndarray      # [K] f32 sampling weights (need not be normalized)


@struct.dataclass
class MTVecState:
    env: EnvState                 # batched over E
    task_id: jnp.ndarray          # [E] int32 current task per env
    desync_step: jnp.ndarray      # [E] int32; >0 = truncate first episode there
    episode_len: jnp.ndarray      # [E] int32 of the last finished episode
    last_episode_reward: jnp.ndarray  # [E, A] f32 of the last finished episode
    last_episode_task: jnp.ndarray    # [E] int32 task of the last finished episode
    last_episode_gained: jnp.ndarray  # [E, R] f32 agent-mean resources gained
    episodes_done: jnp.ndarray        # [E] int32 total finished episodes


def _stack_pytrees(items: Sequence[Any]):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *items)


def build_task_set(
    cfgs: Sequence[MettaGridConfig],
    track_stats: bool = True,
    weights: Optional[np.ndarray] = None,
) -> tuple[TaskSetData, List[Tables]]:
    """Compile + stack K task configs. Raises if statics/shapes differ."""
    tables_list, templates, obs1s, clip0 = [], [], [], []
    # Templates are built on the host CPU backend and device_put afterwards:
    # building them on the accelerator would compile two fresh programs per
    # task (and per curriculum slot eviction) — task-pool mutations must stay
    # data-only. This needs the CPU backend initialised beside the GPU.
    cpu = jax.devices("cpu")[0]
    for i, cfg in enumerate(cfgs):
        game_map = cfg.game.map_builder.create().build()
        compiled, init = compile_game(cfg.game, game_map)
        t = Tables(compiled, track_stats=track_stats)
        tables_list.append(t)
        with jax.default_device(cpu):
            t_cpu = Tables(compiled, track_stats=track_stats)
            tmpl, obs1 = make_reset_template(t_cpu, init)
        templates.append(jax.device_put(tmpl))
        obs1s.append(jax.device_put(obs1))
        clip0.append(jnp.asarray(init["asm_start_clipped"]))
    t0 = jax.tree.structure(tables_list[0])
    shapes0 = [x.shape for x in jax.tree.leaves(tables_list[0])]
    for i, t in enumerate(tables_list[1:], 1):
        if (
            jax.tree.structure(t) != t0
            or [x.shape for x in jax.tree.leaves(t)] != shapes0
        ):
            raise ValueError(
                f"task {i} is not shape/static-compatible with task 0 — "
                "a task set must share map size, agent count, action space, "
                "obs geometry, and subsystem usage (values may differ)"
            )
    K = len(cfgs)
    w = jnp.ones((K,), jnp.float32) if weights is None else jnp.asarray(weights, jnp.float32)
    ts = TaskSetData(
        tables=_stack_pytrees(tables_list),
        template=_stack_pytrees(templates),
        obs1=jnp.stack(obs1s),
        start_clipped=jnp.stack(clip0),
        weights=w,
    )
    return ts, tables_list


def _tables_at(stacked: Tables, tid):
    return jax.tree.map(lambda x: x[tid], stacked)


class MultiTaskEnv:
    """Batched on-device MettaGrid over a task set (see module docstring).

    API mirrors :class:`MettaGridEnv`, except the functional cores take the
    :class:`TaskSetData` as an explicit traced argument, so sampling-weight
    updates and task-slot replacement never recompile:

        vstate, obs = env.reset_core(key, ts)
        vstate, obs, rew, done, trunc = env.step_core(vstate, actions, ts)
    """

    def __init__(
        self,
        cfgs: Sequence[MettaGridConfig],
        num_envs: int = 1,
        seed: int = 0,
        desync_episodes: Optional[bool] = None,
        track_stats: bool = False,
        step_mode: str = "batched",
    ):
        self.cfgs = list(cfgs)
        self.num_envs = num_envs
        self._seed = seed
        self.tsdata, tables_list = build_task_set(self.cfgs, track_stats=track_stats)
        self.tables = tables_list[0]   # statics view (shared across the set)
        tables0 = self.tables
        self.step_mode, _step_env = select_step(tables0, step_mode)
        self.desync = (
            self.cfgs[0].desync_episodes if desync_episodes is None else desync_episodes
        )
        self.num_agents = tables0.num_agents
        self.single_observation_space_shape = (tables0.num_obs_tokens, 3)
        self.action_names = tables0.action_names
        E = num_envs
        A = tables0.num_agents

        def _fresh_batch(ts: TaskSetData, keys, task_id):
            """Reset-target state+obs for each env from its task's template."""
            state = jax.vmap(lambda tid: _tables_at(ts.template, tid))(task_id)
            obs = ts.obs1[task_id]
            state = state.replace(key=jax.vmap(lambda k: jax.random.split(k)[0])(keys))
            if tables0.clipper_enabled:
                NA = tables0.n_assembler_slots
                nup = max(tables0.n_unclip_protocols, 1)
                protos = jax.vmap(
                    lambda k: jax.random.randint(jax.random.split(k)[1], (NA,), 0, nup)
                )(keys)
                sc = ts.start_clipped[task_id]
                state = state.replace(
                    asm_unclip_proto=jnp.where(sc, protos, -1)
                )
            return state, obs

        def _stepped(ts, env_state, task_id, actions):
            return jax.vmap(
                lambda s, a, tid: _step_env(s, a, _tables_at(ts.tables, tid))
            )(env_state, actions, task_id)

        def reset_core(key, ts: TaskSetData):
            keys = jax.random.split(key, E)
            logw = jnp.log(jnp.maximum(ts.weights, 1e-9))
            task_id = jax.vmap(
                lambda k: jax.random.categorical(jax.random.fold_in(k, 7), logw)
            )(keys).astype(jnp.int32)
            env, obs = _fresh_batch(ts, keys, task_id)
            if self.desync and tables0.max_steps > 0:
                desync = jax.random.randint(
                    jax.random.fold_in(key, 1), (E,), 1, tables0.max_steps
                )
            else:
                desync = jnp.zeros((E,), jnp.int32)
            return MTVecState(
                env=env,
                task_id=task_id,
                desync_step=desync,
                episode_len=jnp.zeros((E,), jnp.int32),
                last_episode_reward=jnp.zeros((E, A), jnp.float32),
                last_episode_task=jnp.zeros((E,), jnp.int32),
                last_episode_gained=jnp.zeros(
                    (E, tables0.num_resources), jnp.float32),
                episodes_done=jnp.zeros((E,), jnp.int32),
            ), obs

        def step_core(vstate: MTVecState, actions, ts: TaskSetData):
            env, obs = _stepped(ts, vstate.env, vstate.task_id, actions)
            force_trunc = (vstate.desync_step > 0) & (env.step >= vstate.desync_step)
            truncated = env.truncated | force_trunc
            done = env.done
            ended = done | truncated
            rewards = env.reward
            episode_done_len = jnp.where(ended, env.step, vstate.episode_len)
            episode_done_rew = jnp.where(
                ended[:, None], env.episode_reward, vstate.last_episode_reward
            )
            episode_done_task = jnp.where(ended, vstate.task_id, vstate.last_episode_task)
            episode_done_gained = jnp.where(
                ended[:, None],
                jnp.mean(env.agent_gained.astype(jnp.float32), axis=1),
                vstate.last_episode_gained,
            )

            # per-episode task resample (CurriculumEnv parity) + auto-reset
            logw = jnp.log(jnp.maximum(ts.weights, 1e-9))
            new_tid = jax.vmap(
                lambda k: jax.random.categorical(jax.random.fold_in(k, 7), logw)
            )(env.key).astype(jnp.int32)
            new_tid = jnp.where(ended, new_tid, vstate.task_id)
            fresh, fresh_obs = _fresh_batch(ts, env.key, new_tid)
            env = jax.tree.map(
                lambda new, old: jnp.where(
                    jnp.reshape(ended, (-1,) + (1,) * (old.ndim - 1)), new, old
                ),
                fresh, env,
            )
            obs = jnp.where(ended[:, None, None, None], fresh_obs, obs)
            vstate = MTVecState(
                env=env,
                task_id=new_tid,
                desync_step=jnp.where(ended, 0, vstate.desync_step),
                episode_len=episode_done_len,
                last_episode_reward=episode_done_rew,
                last_episode_task=episode_done_task,
                last_episode_gained=episode_done_gained,
                episodes_done=vstate.episodes_done + ended.astype(jnp.int32),
            )
            return vstate, obs, rewards, done, truncated

        self.reset_core = reset_core
        self.step_core = step_core
        self._reset_fn = jax.jit(reset_core)
        self._step_fn = jax.jit(step_core)
        self._state: Optional[MTVecState] = None

    # ------------------------------------------------------------------
    # host-side task-pool mutation (no recompiles)
    # ------------------------------------------------------------------

    def set_weights(self, weights):
        self.tsdata = self.tsdata.replace(
            weights=jnp.asarray(weights, jnp.float32)
        )

    def set_task(self, slot: int, cfg: MettaGridConfig):
        """Replace one task slot (curriculum pool eviction). Data-only."""
        sub, _ = build_task_set([cfg], track_stats=False)
        def put(stack, one):
            return stack.at[slot].set(one[0])
        self.cfgs[slot] = cfg
        self.tsdata = self.tsdata.replace(
            tables=jax.tree.map(put, self.tsdata.tables, sub.tables),
            template=jax.tree.map(put, self.tsdata.template, sub.template),
            obs1=put(self.tsdata.obs1, sub.obs1),
            start_clipped=put(self.tsdata.start_clipped, sub.start_clipped),
        )

    # ------------------------------------------------------------------
    # stateful numpy API (tests, eval)
    # ------------------------------------------------------------------

    def reset(self, seed: Optional[int] = None):
        key = jax.random.PRNGKey(self._seed if seed is None else seed)
        self._state, obs = self._reset_fn(key, self.tsdata)
        return np.asarray(obs)

    def step(self, actions):
        assert self._state is not None, "call reset() first"
        actions = jnp.asarray(actions, jnp.int32)
        if actions.ndim == 1:
            actions = actions[None, :]
        self._state, obs, rew, done, trunc = self._step_fn(
            self._state, actions, self.tsdata
        )
        return np.asarray(obs), np.asarray(rew), np.asarray(done), np.asarray(trunc)

    @property
    def state(self) -> MTVecState:
        return self._state

    @property
    def compiled(self):
        """CompiledConfig of task 0 (action space / obs metadata — shared
        across the set by the compatibility contract)."""
        return self.tables._cfg
