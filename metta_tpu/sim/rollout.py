"""Evaluation rollouts.

Parity: reference ``mettagrid/simulator/multi_episode/rollout.py:58-140`` —
multi-policy episodes with largest-remainder proportional agent assignment,
reshuffled per episode; per-episode rewards/stats/replays.

Design: all requested episodes run as ONE vectorized env batch
(episode = env instance); policies act on the whole [episodes × agents] slot
batch each step. Replays are recorded host-side for the first episode (replay
recording forces per-step host transfers, so it is opt-in).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from metta_tpu.config.mettagrid_config import MettaGridConfig
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.policy.policy import MultiAgentPolicy


def compute_policy_agent_counts(num_agents: int, proportions: list[float]) -> list[int]:
    """Largest-remainder apportionment (rollout.py:40-55)."""
    total = sum(proportions)
    if total <= 0:
        raise ValueError("Total policy proportion must be positive.")
    fractions = [p / total for p in proportions]
    ideals = [num_agents * f for f in fractions]
    counts = [math.floor(x) for x in ideals]
    remaining = num_agents - sum(counts)
    remainders = sorted(
        ((i, ideals[i] - counts[i]) for i in range(len(fractions))),
        key=lambda x: x[1], reverse=True,
    )
    for i in range(remaining):
        counts[remainders[i][0]] += 1
    return counts


@dataclass
class EpisodeRolloutResult:
    assignments: np.ndarray      # [A] agent -> policy idx
    rewards: np.ndarray          # [A]
    stats: dict
    replay_path: Optional[str]
    steps: int
    max_steps: int


@dataclass
class MultiEpisodeRolloutResult:
    episodes: list[EpisodeRolloutResult] = field(default_factory=list)

    def rewards_by_policy(self, n_policies: int) -> list[float]:
        sums = np.zeros(n_policies)
        counts = np.zeros(n_policies)
        for ep in self.episodes:
            for a, p in enumerate(ep.assignments):
                sums[p] += ep.rewards[a]
                counts[p] += 1
        return (sums / np.maximum(counts, 1)).tolist()


def episode_stats(env: MettaGridEnv, e: int) -> dict:
    """Engine stat accumulators → named stats (StatsTracker parity subset)."""
    import jax

    s = env.env_state(e)
    compiled = env.compiled
    agent_stats = []
    for a in range(compiled.num_agents):
        d = {}
        for r, name in enumerate(compiled.resource_names):
            if s.agent_gained[a, r]:
                d[f"{name}.gained"] = float(s.agent_gained[a, r])
            if s.agent_lost[a, r]:
                d[f"{name}.lost"] = float(s.agent_lost[a, r])
            if s.agent_inv[a, r]:
                d[f"{name}.amount"] = float(s.agent_inv[a, r])
            if s.agent_chest_deposited[a, r]:
                d[f"chest.{name}.deposited_by_agent"] = float(s.agent_chest_deposited[a, r])
        d["status.steps_without_motion"] = float(s.agent_steps_without_motion[a])
        agent_stats.append(d)
    game = {}
    for r, name in enumerate(compiled.resource_names):
        if s.game_chest_deposited[r]:
            game[f"chest.{name}.deposited"] = float(s.game_chest_deposited[r])
        if s.game_chest_withdrawn[r]:
            game[f"chest.{name}.withdrawn"] = float(s.game_chest_withdrawn[r])
        if s.game_asm_created[r]:
            game[f"assembler.{name}.created"] = float(s.game_asm_created[r])
    return {"game": game, "agent": agent_stats}


def multi_episode_rollout(
    env_cfg: MettaGridConfig,
    policies: list[MultiAgentPolicy],
    episodes: int,
    seed: int = 0,
    proportions: Optional[Sequence[float]] = None,
    save_replay: Optional[str] = None,
    max_steps_override: Optional[int] = None,
    step_mode: str = "batched",
) -> MultiEpisodeRolloutResult:
    """``step_mode`` defaults to the batched (rank-arbitrated) engine: on
    accelerators the sequential-exact mode unrolls A agent iterations into
    one enormous program (minutes of compile at 24 agents through a remote
    compile service); eval semantics are identical up to multi-agent
    conflict ordering, which the reference randomizes per step anyway."""
    env_cfg = env_cfg.model_copy(deep=True)
    env_cfg.desync_episodes = False
    env = MettaGridEnv(env_cfg, num_envs=episodes, desync_episodes=False,
                       step_mode=step_mode)
    A = env.num_agents
    E = episodes
    max_steps = max_steps_override or env.compiled.max_steps or 1000

    counts = compute_policy_agent_counts(
        A, list(proportions) if proportions is not None else [1.0] * len(policies)
    )
    base_assign = np.repeat(np.arange(len(policies)), counts)
    rng = np.random.default_rng(seed)
    assignments = np.stack([rng.permutation(base_assign) for _ in range(E)])  # [E, A]

    for p in policies:
        p.reset(E * A)

    replay = None
    writer = None
    if save_replay is not None:
        from metta_tpu.sim.replay_writer import ReplayLogWriter

        writer = ReplayLogWriter(save_replay)
        replay = writer.new_episode(env, env_cfg)

    from metta_tpu.policy.policy import NetworkPolicy

    if save_replay is None and policies and all(
        isinstance(p, NetworkPolicy) for p in policies
    ):
        # ---- on-device fast path: the whole policy+env loop is one jitted
        # lax.scan (the host loop below dispatches one device call per
        # step) ----
        import jax
        import jax.numpy as jnp

        B = E * A
        assign_d = jnp.asarray(assignments.reshape(-1))
        params = [p.params for p in policies]

        def body(carry, _):
            vstate, obs, states, key, ep_rew, ep_stp, ep_dn = carry
            obs_flat = obs.reshape(B, obs.shape[2], 3)
            key, *ks = jax.random.split(key, len(policies) + 1)
            actions = jnp.zeros((B,), jnp.int32)
            new_states = []
            for i, p in enumerate(policies):
                o = obs_flat[:, : p.policy.cfg.max_tokens]
                logits, _v, _h, st = p.policy.apply(params[i], o, states[i])
                act = (jax.random.categorical(ks[i], logits)
                       if p.sample else jnp.argmax(logits, axis=-1))
                actions = jnp.where(assign_d == i, act.astype(jnp.int32), actions)
                new_states.append(st)
            vs2, obs2, rew, done, trunc = env.step_no_reset_core(
                vstate, actions.reshape(E, A)
            )
            active = ~ep_dn
            # freeze envs whose episode already ended (their final state
            # carries the episode stats the caller reads)
            vs2 = jax.tree.map(
                lambda new, old: jnp.where(
                    jnp.reshape(active, (-1,) + (1,) * (old.ndim - 1)), new, old
                ) if new.ndim >= 1 and new.shape[:1] == (E,) else
                jnp.where(active.any(), new, old),
                vs2, vstate,
            )
            obs2 = jnp.where(active[:, None, None, None], obs2, obs)
            ep_rew = ep_rew + jnp.where(active[:, None], rew, 0.0)
            ep_stp = ep_stp + active.astype(jnp.int64)
            ep_dn = ep_dn | (done | trunc)
            return (vs2, obs2, new_states, key, ep_rew, ep_stp, ep_dn), ()

        def run(key):
            vstate, obs = env.reset_core(key)
            carry = (
                vstate, obs, [p.policy.initial_state(B) for p in policies],
                jax.random.fold_in(key, 17),
                jnp.zeros((E, A), jnp.float32),
                jnp.zeros((E,), jnp.int64),
                jnp.zeros((E,), bool),
            )
            carry, _ = jax.lax.scan(body, carry, None, length=max_steps)
            return carry

        carry = jax.jit(run)(jax.random.PRNGKey(seed))
        vstate_f, _obs, _st, _k, ep_rew_d, ep_stp_d, _dn = carry
        env._state = jax.tree.map(lambda x: x, vstate_f)
        ep_rewards = np.asarray(ep_rew_d)
        ep_steps = np.asarray(ep_stp_d)

        result = MultiEpisodeRolloutResult()
        for e in range(E):
            result.episodes.append(
                EpisodeRolloutResult(
                    assignments=assignments[e],
                    rewards=ep_rewards[e],
                    stats=episode_stats(env, e),
                    replay_path=None,
                    steps=int(ep_steps[e]),
                    max_steps=max_steps,
                )
            )
        return result

    obs = env.reset(seed=seed)
    ep_rewards = np.zeros((E, A))
    ep_steps = np.zeros((E,), np.int64)
    ep_done = np.zeros((E,), bool)
    flat_assign = assignments.reshape(-1)  # [E*A]

    for step in range(max_steps):
        obs_flat = obs.reshape(E * A, *obs.shape[2:])
        actions_flat = np.zeros((E * A,), np.int32)
        for p_idx, policy in enumerate(policies):
            acts = policy.step_batch(obs_flat)
            mask = flat_assign == p_idx
            actions_flat[mask] = acts[mask]
        actions = actions_flat.reshape(E, A)
        obs, rew, done, trunc = env.step_no_reset(actions)
        ended = done | trunc
        active = ~ep_done
        ep_rewards[active] += rew[active]
        ep_steps[active] += 1
        if replay is not None and not ep_done[0]:
            replay.log_step(
                env.state.env, actions[0], env.action_success(0), rew[0], e=0
            )
        ep_done |= ended
        if ep_done.all():
            break

    result = MultiEpisodeRolloutResult()
    replay_path = None
    if replay is not None and writer is not None:
        replay_path = writer.finish_episode(replay)
    for e in range(E):
        result.episodes.append(
            EpisodeRolloutResult(
                assignments=assignments[e],
                rewards=ep_rewards[e],
                stats=episode_stats(env, e),
                replay_path=replay_path if e == 0 else None,
                steps=int(ep_steps[e]),
                max_steps=max_steps,
            )
        )
    return result
