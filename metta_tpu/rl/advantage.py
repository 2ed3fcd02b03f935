"""Advantage computation: VTrace/GAE and TD(λ) reverse scans.

Parity: the pufferlib CUDA kernel ``compute_puff_advantage``
(``packages/pufferlib-core/src/pufferlib/extensions/pufferlib.cpp:28-42``) and
``metta/rl/advantage.py:18-76`` — here these are simple ``lax.scan`` reverse
recurrences (no custom kernel needed; XLA fuses the scan body).

Row layout [B, T]: index t holds (value of obs_t, reward received on arriving
at obs_t, done flag of obs_t). The recurrence runs t = T-2 .. 0:

    delta_t = rho_t (r_{t+1} + γ v_{t+1} (1-d_{t+1}) - v_t)
    adv_t   = delta_t + γλ c_t (1-d_{t+1}) adv_{t+1}
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def puff_advantage(values, rewards, dones, importance, gamma, gae_lambda,
                   vtrace_rho_clip=1.0, vtrace_c_clip=1.0):
    """VTrace-flavored GAE. All inputs [B, T] f32; returns advantages [B, T]
    with adv[:, -1] = 0."""
    nextnonterminal = 1.0 - dones[:, 1:]                       # [B, T-1]
    rho = jnp.minimum(importance[:, :-1], vtrace_rho_clip)
    c = jnp.minimum(importance[:, :-1], vtrace_c_clip)
    delta = rho * (rewards[:, 1:] + gamma * values[:, 1:] * nextnonterminal - values[:, :-1])
    decay = gamma * gae_lambda * c * nextnonterminal

    def body(carry, xs):
        d, k = xs
        adv = d + k * carry
        return adv, adv

    # reverse scan over time
    _, adv_rev = jax.lax.scan(
        body, jnp.zeros_like(delta[:, 0]),
        (jnp.moveaxis(delta, 1, 0)[::-1], jnp.moveaxis(decay, 1, 0)[::-1]),
    )
    adv = jnp.moveaxis(adv_rev[::-1], 0, 1)                    # [B, T-1]
    return jnp.concatenate([adv, jnp.zeros_like(adv[:, :1])], axis=1)


def td_lambda_reverse_scan(delta, mask_next, gamma_lambda):
    """running_t = delta_t + γλ mask_t running_{t+1} (advantage.py:18-24)."""
    def body(carry, xs):
        d, m = xs
        out = d + gamma_lambda * m * carry
        return out, out

    _, out_rev = jax.lax.scan(
        body, jnp.zeros_like(delta[:, 0]),
        (jnp.moveaxis(delta, 1, 0)[::-1], jnp.moveaxis(mask_next, 1, 0)[::-1]),
    )
    return jnp.moveaxis(out_rev[::-1], 0, 1)


def compute_delta_lambda(values, rewards, dones, gamma, gae_lambda):
    """TD(λ) targets for the GTD critic (advantage.py:53-76). [B, T] in/out."""
    mask_next = 1.0 - dones[:, 1:]
    delta = rewards[:, 1:] + gamma * mask_next * values[:, 1:] - values[:, :-1]
    dl = td_lambda_reverse_scan(delta, mask_next, gamma * gae_lambda)
    return jnp.concatenate([dl, jnp.zeros_like(dl[:, :1])], axis=1)


def normalize_advantage(adv, axis_name=None, eps=1e-8):
    """Mean/std normalization; when ``axis_name`` is set, statistics are
    all-reduced over that mesh axis (parity: normalize_advantage_distributed)."""
    n = jnp.float32(adv.size)
    s = jnp.sum(adv)
    ss = jnp.sum(adv * adv)
    if axis_name is not None:
        n = jax.lax.psum(n, axis_name)
        s = jax.lax.psum(s, axis_name)
        ss = jax.lax.psum(ss, axis_name)
    mean = s / n
    var = jnp.maximum(ss / n - mean * mean, 0.0)
    return (adv - mean) / jnp.sqrt(var + eps)
