"""Sequence-mode policy forward == step-by-step scan.

The learner can forward a whole [T, B, K, 3] segment in one policy apply:
token embed / perceiver / heads batch over T·B, and the core runs its
sequence mode — the chunkwise-parallel mLSTM kernel (ops/mlstm_chunkwise.py,
plain JAX in place of the reference Triton kernels,
``cortex/kernels/triton/mlstm/``) for "M" cells, a lifted scan for the LSTM
core, and an unrolled shared-parameter loop for the other cells.

Tolerances: recurrent cores amplify shape-dependent f32 accumulation noise
exponentially over the segment (measured ~1e-7/step growing to ~1e-2 over 16
steps through exp-gated cells), so the stack-level checks use f32 inputs and
mid tolerances, the encoder/head batching is pinned EXACTLY at T=1, and the
end-to-end check uses a bf16-ulp tolerance. Wiring errors produce O(1)
differences, far above all three."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metta_tpu.models.cells import CortexStack, StackSpec
from metta_tpu.models.vit import ViTConfig


def _policy(core):
    cfg = ViTConfig(latent_dim=32, actor_hidden=16, critic_hidden=16,
                    max_tokens=16, core_num_latents=2, core_num_heads=2,
                    core=core, core_layers=1)
    return cfg.make(n_actions=7, feature_norms={})


def _rand_obs(key, T, B, K=16):
    return jax.random.randint(key, (T, B, K, 3), 0, 255, dtype=jnp.int32).astype(
        jnp.uint8
    )


def test_encoder_and_heads_batch_exactly():
    """T=1 sequence apply == single-step apply to f32 ulp: the T·B-batched
    encoder and heads are the same per-row math (only the lifted-scan LSTM
    core fuses differently, at ~1e-7)."""
    policy = _policy("lstm")
    key = jax.random.PRNGKey(0)
    B = 6
    obs = _rand_obs(jax.random.fold_in(key, 1), 1, B)
    state0 = policy.initial_state(B)
    params = policy.init(key, obs[0], state0)
    l1, v1, h1, _ = policy.apply(params, obs[0], state0)
    l2, v2, h2, _ = policy.apply(params, obs, state0)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(h1), np.asarray(h2[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pattern", ["M", "Ag,A,S", "S", "A", "AXMS"])
def test_stack_sequence_equals_step(pattern):
    """CortexStack sequence mode == stepping, on f32 inputs (no encoder)."""
    T, B, D = 16, 5, 32
    spec = StackSpec(d_hidden=D, num_layers=1, pattern=pattern)
    stack = CortexStack(spec=spec)
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(jax.random.fold_in(key, 1), (T, B, D), jnp.float32)
    state0 = spec.initial_state(B)
    params = stack.init(key, x[0], state0)

    def step(carry, x_t):
        y, carry = stack.apply(params, x_t, carry)
        return carry, y

    ref_state, y_ref = jax.lax.scan(step, state0, x)
    y_seq, seq_state = stack.apply(params, x, state0)

    np.testing.assert_allclose(np.asarray(y_seq), np.asarray(y_ref),
                               rtol=2e-3, atol=2e-3)
    for l_ref, l_seq in zip(jax.tree.leaves(ref_state),
                            jax.tree.leaves(seq_state)):
        np.testing.assert_allclose(np.asarray(l_seq), np.asarray(l_ref),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("core", ["lstm", "M"])
def test_policy_sequence_end_to_end(core):
    """Full policy sequence apply tracks the per-step scan within bf16 ulp."""
    T, B = 16, 6
    policy = _policy(core)
    key = jax.random.PRNGKey(0)
    obs = _rand_obs(jax.random.fold_in(key, 1), T, B)
    state0 = policy.initial_state(B)
    params = policy.init(key, obs[0], state0)

    def step(carry, obs_t):
        logits, value, h_value, carry = policy.apply(params, obs_t, carry)
        return carry, (logits, value, h_value)

    _, (l_ref, v_ref, h_ref) = jax.lax.scan(step, state0, obs)
    l_seq, v_seq, h_seq, _ = policy.apply(params, obs, state0)

    np.testing.assert_allclose(np.asarray(l_seq), np.asarray(l_ref),
                               rtol=0.06, atol=0.06)
    np.testing.assert_allclose(np.asarray(v_seq), np.asarray(v_ref),
                               rtol=0.06, atol=0.06)
    np.testing.assert_allclose(np.asarray(h_seq), np.asarray(h_ref),
                               rtol=0.06, atol=0.06)
