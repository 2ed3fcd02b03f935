"""Hand-computed value oracles for the riskiest loss math.

The per-family tests in test_losses.py are effect-smoke (finiteness +
coefficient gating); a sign error that still trains would pass them. These
pin the actual VALUES of the three most error-prone computations to worked
fixtures: GRPO group-relative advantages (``loss/grpo.py:150-210``), the
quantile-regression Huber weighting (``loss/quantile_ppo_critic.py:105-225``),
and the CMPO policy target (``loss/cmpo.py:155-330``)."""

import jax.numpy as jnp
import numpy as np

from metta_tpu.rl.losses import (
    cmpo_policy_target,
    compute_grpo_advantages,
    quantile_huber,
)


def test_grpo_advantages_hand_computed():
    """B=4 rows, T=3, gamma=0.5, group_size=2, with a done cutting row 1."""
    gamma = 0.5
    rewards = np.array([
        [1.0, 0.0, 2.0],
        [0.0, 1.0, 1.0],
        [2.0, 2.0, 0.0],
        [0.0, 0.0, 4.0],
    ], np.float32)
    dones = np.zeros((4, 3), np.float32)
    dones[1, 1] = 1.0  # return chain restarts after this step

    # discounted returns G_t = r_t + gamma * G_{t+1} * (1 - done_t):
    # row0: [1 + .5*(0 + .5*2), 0 + .5*2, 2]        = [1.5, 1.0, 2.0]
    # row1: done at t=1 -> G1 = 1 (no bootstrap), G0 = 0 + .5*1 = 0.5
    #       [0.5, 1.0, 1.0]
    # row2: [2 + .5*(2 + 0), 2.0, 0.0]              = [3.0, 2.0, 0.0]
    # row3: [0 + .5*.5*4, .5*4, 4]                  = [1.0, 2.0, 4.0]
    G = np.array([
        [1.5, 1.0, 2.0],
        [0.5, 1.0, 1.0],
        [3.0, 2.0, 0.0],
        [1.0, 2.0, 4.0],
    ], np.float32)
    # groups of 2 rows: advantages = G - group mean (per column)
    grp_mean = np.stack([
        (G[0] + G[1]) / 2, (G[0] + G[1]) / 2,
        (G[2] + G[3]) / 2, (G[2] + G[3]) / 2,
    ])
    expected = G - grp_mean

    got = compute_grpo_advantages(
        jnp.asarray(rewards), jnp.asarray(dones), gamma, group_size=2
    )
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-6, atol=1e-6)


def test_grpo_remainder_rows_use_their_own_mean():
    """B=3 with group_size=2: the trailing row falls back to its own group."""
    rewards = np.array([[1.0], [3.0], [5.0]], np.float32)
    dones = np.ones((3, 1), np.float32)
    got = np.asarray(compute_grpo_advantages(
        jnp.asarray(rewards), jnp.asarray(dones), 0.9, group_size=2))
    # rows 0,1 form one group (mean 2); row 2 is alone (mean 5)
    np.testing.assert_allclose(got[:, 0], [-1.0, 1.0, 0.0], atol=1e-6)


def test_quantile_huber_hand_computed():
    """N=2 quantiles, tau_hat = (0.25, 0.75); cover both Huber branches and
    both underestimate/overestimate weightings."""
    tau_hat = jnp.asarray([0.25, 0.75])

    # case 1: quantiles (0.0, 2.0), target 0.5
    #   q0: diff = +0.5 (under-estimate), |diff|<1 -> huber = 0.125,
    #       w = |0.25 - 0| = 0.25      -> 0.03125
    #   q1: diff = -1.5 (over-estimate), huber = 1.0, w = |0.75 - 1| = 0.25
    #       -> 0.25
    got = quantile_huber(jnp.asarray([0.0, 2.0]), jnp.asarray(0.5), tau_hat)
    np.testing.assert_allclose(float(got), 0.03125 + 0.25, rtol=1e-6)

    # case 2: both quantiles far below target 3.0 -> linear branch, the
    # upper quantile is penalized more for under-estimating
    #   q0: diff = 3.0, huber = 2.5, w = 0.25 -> 0.625
    #   q1: diff = 2.0, huber = 1.5, w = 0.75 -> 1.125
    got = quantile_huber(jnp.asarray([0.0, 1.0]), jnp.asarray(3.0), tau_hat)
    np.testing.assert_allclose(float(got), 0.625 + 1.125, rtol=1e-6)

    # asymmetry: a low quantile (tau_hat 0.25) is penalized 3x less for
    # under-estimating (diff > 0, w = 0.25) than for over-estimating by the
    # same margin (w = 0.75)
    t25 = jnp.asarray([0.25])
    under = quantile_huber(jnp.asarray([0.0]), jnp.asarray(0.5), t25)
    over = quantile_huber(jnp.asarray([1.0]), jnp.asarray(0.5), t25)
    np.testing.assert_allclose(float(over) / float(under), 3.0, rtol=1e-6)


def test_cmpo_policy_target_hand_computed():
    """Uniform prior over 2 actions, Q = (1, 0), tau = 1, no clipping:
    v_prior = 0.5, adv = (+0.5, -0.5), pi ∝ 0.5·exp(±0.5) -> softmax(±0.5)."""
    prior_logp = jnp.log(jnp.asarray([[0.5, 0.5]]))
    q = jnp.asarray([[1.0, 0.0]])
    got = np.asarray(cmpo_policy_target(prior_logp, q, temperature=1.0,
                                        adv_clip=10.0, norm_adv=False))[0]
    e = np.exp([0.5, -0.5])
    np.testing.assert_allclose(got, e / e.sum(), rtol=1e-6)

    # clipping saturates the tilt: with adv_clip=0.1 the exponent is ±0.1
    got = np.asarray(cmpo_policy_target(prior_logp, q, temperature=1.0,
                                        adv_clip=0.1, norm_adv=False))[0]
    e = np.exp([0.1, -0.1])
    np.testing.assert_allclose(got, e / e.sum(), rtol=1e-6)

    # non-uniform prior folds in multiplicatively before renormalization
    prior_logp = jnp.log(jnp.asarray([[0.8, 0.2]]))
    got = np.asarray(cmpo_policy_target(prior_logp, q, temperature=1.0,
                                        adv_clip=10.0, norm_adv=False))[0]
    # v_prior = 0.8; adv = (0.2, -0.8); pi ∝ (0.8·e^0.2, 0.2·e^-0.8)
    un = np.array([0.8 * np.exp(0.2), 0.2 * np.exp(-0.8)])
    np.testing.assert_allclose(got, un / un.sum(), rtol=1e-6)

    # norm_adv divides by the per-row std of adv
    q2 = jnp.asarray([[2.0, 0.0]])
    prior_logp = jnp.log(jnp.asarray([[0.5, 0.5]]))
    got = np.asarray(cmpo_policy_target(prior_logp, q2, temperature=1.0,
                                        adv_clip=10.0, norm_adv=True))[0]
    # adv = (+1, -1), std = 1 -> same as unnormalized (+1, -1) tilt
    e = np.exp([1.0, -1.0])
    np.testing.assert_allclose(got, e / e.sum(), rtol=1e-5)
