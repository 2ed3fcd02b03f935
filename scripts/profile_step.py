"""Decompose batched-step cost on the real device: sim vs obs vs phases.

Usage: python scripts/profile_step.py [--num-envs 4096] [--steps 50]
Prints one line per variant: name, wall ms/step, env-steps/s.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from metta_tpu.builder.envs import make_combat
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.engine.step_batched import step_env_batched


def time_scan(fn, vstate, key, steps, num_envs, A, n_actions):
    def body(carry, _):
        vs, key, acc = carry
        key, k = jax.random.split(key)
        actions = jax.random.randint(k, (num_envs, A), 0, n_actions, dtype=jnp.int32)
        vs, acc2 = fn(vs, actions)
        return (vs, key, acc + acc2), ()

    def run(vs, key):
        (vs, key, acc), _ = jax.lax.scan(body, (vs, key, jnp.int32(0)), None, length=steps)
        return vs, key, acc

    run_jit = jax.jit(run)
    out = run_jit(vstate, key)
    jax.block_until_ready(out)
    vs, key = out[0], out[1]
    trials = []
    for _ in range(3):
        t0 = time.time()
        out = run_jit(vs, key)
        jax.block_until_ready(out)
        vs, key = out[0], out[1]
        trials.append(time.time() - t0)
    return min(trials)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--agents", type=int, default=24)
    ap.add_argument("--only", type=str, default=None)
    args = ap.parse_args()

    cfg = make_combat(num_agents=args.agents)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=args.num_envs, desync_episodes=True,
                       track_stats=False, step_mode="batched")
    A = env.num_agents
    n_actions = env.compiled.n_actions
    tables = env.tables
    E = args.num_envs

    key = jax.random.PRNGKey(0)
    vstate, obs = env.reset_fn(key)
    print(f"map {tables.height}x{tables.width} agents {A} envs {E} "
          f"obs_tokens {tables.num_obs_tokens} "
          f"NA {tables.n_assembler_slots} NC {tables.n_chest_slots} "
          f"P {tables.n_protocols} R {tables.num_resources} V {tables.num_vibes}")

    def full(vs, actions):
        vs2, obs, rew, done, trunc = env.step_core(vs, actions)
        return vs2, jnp.sum(obs.astype(jnp.int32))

    def sim_only(vs, actions):
        envst, rew_at_obs = jax.vmap(
            lambda s, a: step_env_batched(s, a, tables, render=False)
        )(vs.env, actions)
        vs2 = vs.replace(env=envst)
        return vs2, jnp.sum(rew_at_obs[0].astype(jnp.int32))

    def obs_only(vs, actions):
        from metta_tpu.engine.obs import render_observations

        obs = jax.vmap(lambda s: render_observations(
            s, tables, s.executed_action, s.reward))(vs.env)
        return vs, jnp.sum(obs.astype(jnp.int32))

    variants = {"full": full, "sim_only": sim_only, "obs_only": obs_only}
    if args.only:
        variants = {k: v for k, v in variants.items() if k in args.only.split(",")}
    for name, fn in variants.items():
        dt = time_scan(fn, vstate, key, args.steps, E, A, n_actions)
        per = dt / args.steps
        print(f"{name:10s} {per * 1e3:8.2f} ms/step  {E * args.steps / dt:12.0f} env-steps/s")


if __name__ == "__main__":
    main()
