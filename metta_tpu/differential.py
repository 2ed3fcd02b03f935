"""CPU-vs-device differential for the engine and the policy.

CPU-green does not mean correct on the card: XLA compiles another program
there, and a float32 matmul may run in TF32. These checks run the same
computation on the device under test and on the CPU backend of the same
process, and compare.

- Engine: an env's whole trajectory under the same threefry random actions.
  Every integer and boolean state field and every observation byte must be
  identical. Float fields (rewards) may differ by reduction order within
  ``rtol``.
- Policy: one forward pass on real observations against a CPU float32
  forward at ``default_matmul_precision("highest")``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

BF16_MANTISSA_BITS = 8   # bfloat16 keeps 8 significant bits (7 stored)


def compare_trees(ref, got, rtol: float = 1e-6, atol: float = 0.0,
                  label: str = "") -> list[str]:
    """Mismatches between two pytrees of arrays, one line each. Integer and
    boolean leaves must be identical; float leaves agree within
    ``|got - ref| <= atol + rtol * |ref|``."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves = jax.tree.leaves(got)
    if len(ref_leaves) != len(got_leaves):
        return [f"{label}: {len(ref_leaves)} leaves vs {len(got_leaves)}"]
    out = []
    for (path, a), b in zip(ref_leaves, got_leaves):
        name = label + jax.tree_util.keystr(path)
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            out.append(f"{name}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
            continue
        if np.issubdtype(a.dtype, np.floating):
            bad = ~(np.abs(b.astype(np.float64) - a) <= atol + rtol * np.abs(a))
            bad &= ~(np.isnan(a) & np.isnan(b))
        else:
            bad = a != b
        if bad.any():
            idx = tuple(np.argwhere(bad)[0])
            out.append(f"{name}: {int(bad.sum())} of {a.size} differ, first at "
                       f"{list(idx)}: {a[idx]!r} vs {b[idx]!r}")
    return out


def random_actions(n_steps: int, num_envs: int, num_agents: int, n_actions: int,
                   seed: int = 0) -> np.ndarray:
    """[n_steps, E, A] int32 actions from threefry, made on the CPU."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        key = jax.random.PRNGKey(seed)
        return np.asarray(jax.random.randint(
            key, (n_steps, num_envs, num_agents), 0, n_actions, dtype=jnp.int32))


def env_trajectory(make_env: Callable, device, n_steps: int, seed: int = 0):
    """Build the env on ``device``, reset it from ``seed`` and step it
    ``n_steps`` times with :func:`random_actions`. Returns ``(env, host
    copies of (obs0, env states [T, E, ...], obs [T, E, A, K, 3]))``.
    ``make_env()`` returns a MettaGridEnv or a MultiTaskEnv."""
    with jax.default_device(device):
        env = make_env()
        ts = getattr(env, "tsdata", None)
        actions = random_actions(n_steps, env.num_envs, env.num_agents,
                                 len(env.action_names), seed)

        def run(key, acts):
            if ts is None:
                vstate, obs0 = env.reset_core(key)
                step = env.step_core
            else:
                vstate, obs0 = env.reset_core(key, ts)
                step = lambda v, a: env.step_core(v, a, ts)  # noqa: E731

            def body(vstate, a):
                vstate, obs, *_ = step(vstate, a)
                return vstate, (vstate.env, obs)

            _, (states, obs) = jax.lax.scan(body, vstate, acts)
            return obs0, states, obs

        out = jax.jit(run)(jax.random.PRNGKey(seed), jnp.asarray(actions))
        return env, jax.device_get(out)


def engine_differential(make_env: Callable, device, n_steps: int = 64,
                        seed: int = 0, rtol: float = 1e-6) -> dict:
    """Trajectory on ``device`` against the CPU backend. Returns a report with
    the mismatches (empty when the engine agrees), what was compared, and the
    resources the agents gained over the CPU trajectory (``ref_gained``, by
    name; zero counts left out), which shows whether the play did anything."""
    env, ref = env_trajectory(make_env, jax.devices("cpu")[0], n_steps, seed)
    _, got = env_trajectory(make_env, device, n_steps, seed)
    name = type(env).__name__
    gained = ref[1].agent_gained[-1].sum(axis=(0, 1))
    return {"env": name, "step_mode": env.step_mode, "num_envs": env.num_envs,
            "steps": n_steps, "obs_bytes_compared": int(ref[0].size + ref[2].size),
            "last_obs": ref[2][-1],
            "ref_gained": {n: int(v) for n, v in zip(env.tables.resource_names, gained) if v},
            "mismatches": compare_trees(ref, got, rtol=rtol, label=name)}


def bf16_ulps(ref, got) -> float:
    """Largest ``|got - ref|`` in bfloat16 ulps of the array's scale
    (the ulp of ``max(|ref|)``, at least that of 1.0)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(scale)) - (BF16_MANTISSA_BITS - 1))
    return float(np.max(np.abs(got - ref)) / ulp)


def policy_differential(policy_cfg, n_actions: int, feature_norms: dict,
                        obs: np.ndarray, device, seed: int = 0) -> dict:
    """Forward ``policy_cfg`` on ``device`` against a CPU float32 forward at
    ``default_matmul_precision("highest")`` with the same parameters.

    Returns the largest error of each output: ``max_abs`` for the policy as
    configured, in bf16 ulps when its compute dtype is bfloat16, and
    ``max_abs_f32`` for the float32 policy at highest precision on both
    sides."""
    cpu = jax.devices("cpu")[0]
    cfg32 = dataclasses.replace(policy_cfg, compute_dtype="float32")
    pol = policy_cfg.make(n_actions, feature_norms)
    pol32 = cfg32.make(n_actions, feature_norms)
    B = obs.shape[0]
    with jax.default_device(cpu):
        state = pol.initial_state(B)
        params = pol.init(jax.random.PRNGKey(seed), jnp.asarray(obs), state)
        with jax.default_matmul_precision("highest"):
            ref = jax.device_get(jax.jit(pol32.apply)(params, jnp.asarray(obs), state))
    on_dev = jax.device_put((params, obs, state), device)
    got = jax.device_get(jax.jit(pol.apply)(*on_dev))
    with jax.default_matmul_precision("highest"):
        got32 = jax.device_get(jax.jit(pol32.apply)(*on_dev))
    names = ("logits", "value", "h_value")
    report = {"batch": B, "compute_dtype": policy_cfg.compute_dtype}
    for i, n in enumerate(names):
        report[n] = {
            "max_abs": float(np.max(np.abs(np.asarray(got[i], np.float64) - ref[i]))),
            "bf16_ulps": bf16_ulps(ref[i], got[i]),
            "max_abs_f32": float(np.max(np.abs(np.asarray(got32[i], np.float64) - ref[i]))),
            "finite": bool(np.isfinite(got[i]).all() and np.isfinite(got32[i]).all()),
        }
    report["state_max_abs_f32"] = max(
        float(np.max(np.abs(np.asarray(a, np.float64) - b)))
        for a, b in zip(jax.tree.leaves(got32[3]), jax.tree.leaves(ref[3])))
    return report
