"""Diagnostic: can RANDOM actions produce ore/battery/heart on the arena env?

Runs the exact training env (recipes.arena_basic_easy_shaped.mettagrid) with
uniform-random actions in the batched (training) step mode and reports total
agent_gained per resource. If battery/heart are exactly zero here, the
heart-gate failure is a mechanics/config bug on the training path, not an
exploration failure.

Usage: JAX_PLATFORMS=cpu python scripts/diag_random_gains.py [--steps 2000]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# --gpu runs on the card; the default is the CPU
if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--num-envs", type=int, default=32)
    ap.add_argument("--mode", type=str, default="batched")
    ap.add_argument("--curriculum", action="store_true")
    ap.add_argument("--gpu", action="store_true")
    args = ap.parse_args()

    from recipes.arena_basic_easy_shaped import make_curriculum, mettagrid
    from metta_tpu.engine.env import MettaGridEnv

    cfg = mettagrid()
    if args.curriculum:
        from metta_tpu.engine.taskset import MultiTaskEnv

        curriculum = make_curriculum()
        mt_tasks = curriculum.active_tasks()
        print(f"curriculum: {len(mt_tasks)} active tasks")
        env = MultiTaskEnv([t.get_env_cfg() for t in mt_tasks],
                           num_envs=args.num_envs, desync_episodes=True,
                           track_stats=True, step_mode=args.mode)
    else:
        env = MettaGridEnv(cfg, num_envs=args.num_envs, desync_episodes=True,
                           track_stats=True, step_mode=args.mode)
    tables = env.tables
    A = env.num_agents
    n_actions = tables.n_actions
    res_names = list(cfg.game.resource_names)
    print(f"resources: {res_names}")
    print(f"n_actions={n_actions} agents={A} map={tables.height}x{tables.width}")

    key = jax.random.PRNGKey(0)
    if args.curriculum:
        ts = env.tsdata
        vstate, _ = jax.jit(env.reset_core)(key, ts)

        def body(carry, _):
            vstate, key = carry
            key, k = jax.random.split(key)
            actions = jax.random.randint(k, (args.num_envs, A), 0, n_actions,
                                         dtype=jnp.int32)
            vstate, obs, rew, done, trunc = env.step_core(vstate, actions, ts)
            return (vstate, key), None
    else:
        vstate, _ = env.reset_fn(key)

        def body(carry, _):
            vstate, key = carry
            key, k = jax.random.split(key)
            actions = jax.random.randint(k, (args.num_envs, A), 0, n_actions,
                                         dtype=jnp.int32)
            vstate, obs, rew, done, trunc = env.step_core(vstate, actions)
            return (vstate, key), None

    @jax.jit
    def run(vstate, key):
        (vstate, key), _ = jax.lax.scan(body, (vstate, key), None,
                                        length=args.steps)
        return vstate

    vstate = run(vstate, key)
    gained = np.asarray(jax.device_get(vstate.env.agent_gained))  # [E, A, R]
    total = gained.sum(axis=(0, 1))
    per_agent_episode = total / (args.num_envs * A) / max(
        args.steps / max(tables.max_steps, 1), 1)
    print(f"\ntotals over {args.steps} steps x {args.num_envs} envs x {A} agents:")
    for i, name in enumerate(res_names):
        print(f"  {name:14s} gained={int(total[i]):8d}   "
              f"per-agent-episode~{per_agent_episode[i]:.4f}")
    # assembler usage counters
    uses = np.asarray(jax.device_get(vstate.env.asm_uses))
    print(f"\nassembler uses: total={uses.sum()}  "
          f"by-slot mean={uses.mean():.2f}")


if __name__ == "__main__":
    main()
