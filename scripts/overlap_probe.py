"""Rollout/forward overlap probe (reference async_factor equivalent).

Measures whether phase-shifted half-batches — policy forward for one half
while the env step runs for the other — beat the serial
obs->forward->step rollout body on the device (reference
``training/training_environment.py:46`` async_factor=2 overlaps env workers
with the forward pass; here both live in one program, so the question is
whether XLA co-schedules them when they are dataflow-independent).

Usage: python scripts/overlap_probe.py [--num-envs 4096] [--steps 64]
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
from metta_tpu.models.vit import ViTConfig


def time_jit(f, args, steps, label):
    t0 = time.time()
    out = f(*args)
    jax.block_until_ready(out)
    ct = time.time() - t0
    trials = []
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(f(*args))
        trials.append(time.time() - t0)
    dt = min(trials) / steps
    return dt, ct


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--agents", type=int, default=24)
    ap.add_argument("--core", type=str, default="lstm")
    args = ap.parse_args()
    E, A = args.num_envs, args.agents

    cfg = make_combat(num_agents=A)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=E, desync_episodes=True,
                       track_stats=False, step_mode="batched")
    envh = MettaGridEnv(cfg, num_envs=E // 2, desync_episodes=True,
                        track_stats=False, step_mode="batched")

    pc = ViTConfig(core=args.core)
    policy = pc.make(env.compiled.n_actions, env.compiled.feature_normalizations)
    key = jax.random.PRNGKey(0)
    B = E * A
    obs_shape = (B, env.compiled.num_obs_tokens, 3)
    params = policy.init(key, jnp.zeros(obs_shape, jnp.uint8),
                         policy.initial_state(B))

    vstate, obs0 = env.reset_fn(key)

    def serial(vstate, obs, core, key, steps=args.steps):
        def body(carry, _):
            key, vs, obs, core = carry
            flat = obs.reshape(B, obs.shape[2], 3)
            logits, value, _hv, core = policy.apply(params, flat, core)
            key, k = jax.random.split(key)
            act = jax.random.categorical(k, logits).reshape(E, A).astype(jnp.int32)
            vs, obs, rew, done, trunc = env.step_core(vs, act)
            return (key, vs, obs, core), jnp.sum(rew)
        (key, vs, obs, core), outs = jax.lax.scan(
            body, (key, vstate, obs, core), None, length=steps)
        return jnp.sum(outs) + jnp.sum(obs.astype(jnp.int32))

    # phase-shifted halves: forward(A) and step(B) are independent per iter
    def pipelined(vsA, vsB, obsA, actsB, coreA, coreB, key, steps=args.steps):
        Bh = B // 2
        Eh = E // 2

        def body(carry, _):
            key, vsA, vsB, obsA, actsB, coreA, coreB = carry
            flat = obsA.reshape(Bh, obsA.shape[2], 3)
            logits, _v, _h, coreA2 = policy.apply(params, flat, coreA)
            key, k = jax.random.split(key)
            actsA = jax.random.categorical(k, logits).reshape(Eh, A).astype(jnp.int32)
            vsB2, obsB, rew, done, trunc = envh.step_core(vsB, actsB)
            # swap roles: B (fresh obs) will be forwarded next iteration
            return (key, vsB2, vsA, obsB, actsA, coreB, coreA2), jnp.sum(rew)

        (key, vsA, vsB, obsA, actsB, coreA, coreB), outs = jax.lax.scan(
            body, (key, vsA, vsB, obsA, actsB, coreA, coreB), None,
            length=steps * 2)
        return jnp.sum(outs) + jnp.sum(obsA.astype(jnp.int32))

    core0 = policy.initial_state(B)
    dt, ct = time_jit(jax.jit(serial), (vstate, obs0, core0, key),
                      args.steps, "serial")
    print(f"serial     {dt * 1e3:8.2f} ms/step  {E / dt:12.0f} env-steps/s"
          f"  (compile {ct:.0f}s)")

    keyh = jax.random.PRNGKey(1)
    vsA, obsA = envh.reset_fn(jax.random.PRNGKey(2))
    vsB, _ = envh.reset_fn(jax.random.PRNGKey(3))
    coreh = policy.initial_state(B // 2)
    actsB0 = jnp.zeros((E // 2, A), jnp.int32)
    dt2, ct2 = time_jit(
        jax.jit(pipelined),
        (vsA, vsB, obsA, actsB0, coreh, policy.initial_state(B // 2), keyh),
        args.steps, "pipelined")
    # one pipelined iteration advances E/2 envs; steps*2 iterations = E*steps
    print(f"pipelined  {dt2 * 1e3:8.2f} ms/step  {E / dt2:12.0f} env-steps/s"
          f"  (compile {ct2:.0f}s)")
    print(f"overlap win: {(dt - dt2) / dt * 100:.1f}%")


if __name__ == "__main__":
    main()
