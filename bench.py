"""Benchmark: env-steps/s of the combat simulator on one GPU.

The combat map (24 agents) at 4096 vectorized envs runs through the batched
step with the observation render, as one jitted ``lax.scan`` whose body folds
every observation byte into its carry, as a policy forward would read them;
otherwise XLA would drop the render as dead code. Compilation is timed
apart, as set-up. The rate is the median of five timed windows.

Prints one JSON line that names the device it ran on (platform, kind, count)
and the card's power limit. Exits non-zero and prints no number when JAX's
first device is not a GPU, or when random play produced no ore or no
converted resource: then the conversion chain is dead and the number would
time a broken simulator.

Usage: python bench.py [--num-envs 4096] [--steps 100] [--agents 24]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np


def combat_env(num_envs: int, agents: int = 24):
    from metta_tpu.builder.envs import make_combat
    from metta_tpu.engine.env import MettaGridEnv

    cfg = make_combat(num_agents=agents)
    cfg.game.map_builder.seed = 1234
    return MettaGridEnv(cfg, num_envs=num_envs, desync_episodes=True,
                        track_stats=False, step_mode="batched")


def sim_program(env, steps: int):
    """``run(vstate, key) -> (vstate, key, obs_sum)``: ``steps`` random-action
    steps in one scan that consumes the observations."""
    E, A = env.num_envs, env.num_agents
    n_actions = env.compiled.n_actions

    def run(vstate, key):
        def body(carry, _):
            vstate, key, acc = carry
            key, k = jax.random.split(key)
            actions = jax.random.randint(k, (E, A), 0, n_actions, dtype=jnp.int32)
            vstate, obs, *_ = env.step_core(vstate, actions)
            return (vstate, key, acc + jnp.sum(obs.astype(jnp.int32))), None

        (vstate, key, acc), _ = jax.lax.scan(
            body, (vstate, key, jnp.int32(0)), None, length=steps)
        return vstate, key, acc

    return run


def conversion_check(env, vstate) -> dict:
    """Resources held after random play; raises when no ore was mined or
    nothing was converted (the round-trip through an assembler is dead)."""
    names = list(env.compiled.resource_names)
    inv = np.asarray(jax.device_get(vstate.env.agent_inv)).sum(axis=(0, 1))
    held = {n: int(inv[i]) for i, n in enumerate(names) if inv[i]}
    ore = any(n.startswith("ore") and v > 0 for n, v in held.items())
    converted = any((n.startswith("battery") or n in ("heart", "armor", "laser"))
                    and v > 0 for n, v in held.items())
    if not (ore and converted):
        raise RuntimeError(f"conversion chain dead on this device: held={held}")
    return held


def measure(num_envs: int = 4096, steps: int = 100, agents: int = 24,
            windows: int = 5) -> dict:
    env = combat_env(num_envs, agents)
    vstate, _ = env.reset_fn(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    compiled = jax.jit(sim_program(env, steps)).lower(vstate, key).compile()
    compile_s = time.perf_counter() - t0
    vstate, key, _ = jax.block_until_ready(compiled(vstate, key))   # warm-up
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        vstate, key, _ = jax.block_until_ready(compiled(vstate, key))
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    return {
        "env": env, "vstate": vstate, "compiled": compiled,
        "num_envs": num_envs, "agents_per_env": env.num_agents,
        "steps_per_window": steps, "compile_s": compile_s,
        "window_walls_s": walls, "step_ms": 1e3 * wall / steps,
        "env_steps_per_s": steps * num_envs / wall,
        "agent_steps_per_s": steps * num_envs * env.num_agents / wall,
        "held": conversion_check(env, vstate),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--agents", type=int, default=24)
    args = ap.parse_args()

    from metta_tpu.utils.device import (device_summary, enable_compile_cache,
                                        gpu_name_and_power_limit, require_gpu)

    require_gpu()
    cache = enable_compile_cache()
    r = measure(args.num_envs, args.steps, args.agents)
    print(json.dumps({
        "metric": "env_steps_per_sec",
        "value": r["env_steps_per_s"],
        "unit": "env-steps/s",
        "device": device_summary(),
        "gpu": gpu_name_and_power_limit(),
        "detail": {
            "map": "combat", "num_envs": r["num_envs"],
            "agents_per_env": r["agents_per_env"],
            "agent_steps_per_sec": r["agent_steps_per_s"],
            "step_ms": r["step_ms"], "steps_per_window": r["steps_per_window"],
            "window_walls_s": r["window_walls_s"], "window_selection": "median",
            "compile_s": r["compile_s"], "compile_cache": cache,
            "obs_consumed": True, "held_after_play": r["held"],
        },
    }))


if __name__ == "__main__":
    main()
