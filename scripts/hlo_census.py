"""Compile the env step for the default backend and print an opcode histogram of the
optimized HLO, plus every scatter/gather/sort/while with operand shapes.

Usage: PYTHONPATH=. python scripts/hlo_census.py [--num-envs 1024] [--no-obs]
"""

from __future__ import annotations

import argparse
import collections
import re


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--agents", type=int, default=24)
    ap.add_argument("--no-obs", action="store_true", help="the sim step without the render")
    ap.add_argument("--full", action="store_true", help="dump full HLO to /tmp/step.hlo")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from metta_tpu.builder.envs import make_combat
    from metta_tpu.engine.env import MettaGridEnv

    cfg = make_combat(num_agents=args.agents)
    env = MettaGridEnv(cfg, num_envs=args.num_envs, desync_episodes=True,
                       track_stats=False, step_mode="batched")
    E, A = args.num_envs, env.num_agents
    n_actions = env.compiled.n_actions

    def one_step(vstate, key):
        actions = jax.random.randint(key, (E, A), 0, n_actions, dtype=jnp.int32)
        if args.no_obs:
            from metta_tpu.engine import step_batched as sb
            env_s, _ = jax.vmap(lambda s, a: sb.step_env_batched_sim(s, a, env.tables))(
                vstate.env, actions)
            vstate = vstate.replace(env=env_s)
            return vstate, jnp.sum(env_s.agent_inv)
        vstate, obs, rew, done, trunc = env.step_core(vstate, actions)
        return vstate, jnp.sum(obs.astype(jnp.int32))

    key = jax.random.PRNGKey(0)
    vstate, _ = env.reset_fn(key)
    lowered = jax.jit(one_step).lower(vstate, key)
    compiled = lowered.compile()
    txt = compiled.as_text()
    if args.full:
        with open("/tmp/step.hlo", "w") as f:
            f.write(txt)

    ops = collections.Counter()
    interesting = []
    for line in txt.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?[\w.-]+\s*=\s*[\w\[\],{}\s/]*\s([a-z][\w-]*)\(", line)
        if not m:
            continue
        op = m.group(1)
        ops[op] += 1
        if op in ("scatter", "gather", "sort", "while", "dynamic-slice",
                  "dynamic-update-slice", "all-reduce"):
            interesting.append(line.strip()[:220])

    print(f"total HLO instruction lines: {sum(ops.values())}")
    for op, n in ops.most_common(30):
        print(f"{n:6d}  {op}")
    print("\n--- scatter/gather/sort/while details ---")
    for l in interesting[:200]:
        print(l)
    try:
        mem = compiled.memory_analysis()
        print("\nmemory:", mem)
    except Exception as e:
        print("memory_analysis unavailable:", e)


if __name__ == "__main__":
    main()
