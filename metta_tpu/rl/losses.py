"""Auxiliary loss families (parity: reference ``metta/rl/loss/``).

Every loss is a pure function over one minibatch of ``[T, M, ...]`` arrays plus
the policy forward outputs, returning a scalar term and metrics. Losses are
compile-gated by their config ``enabled`` flags and runtime-scaled by the
scheduler's hp vector (``rl/scheduler.py``) so coefficient schedules and run
gates never recompile.

Structural differences from the reference (deliberate, JAX-first):

- Teacher forward passes happen in the learner on minibatch observations with
  zero initial state per segment — identical math to the reference's
  rollout-time teacher forward (the teacher is frozen; the reference also
  zero-inits per BPTT segment), without a second copy of the rollout loop.
- The contrastive loss samples anchors/positives vectorized (one pair per
  segment row, geometric future offset, same-episode masked via a done-count
  check) instead of the reference's per-row Python episode scan
  (``loss/contrastive.py:196-240``) — same estimator, fixed shapes.
- CMPO's world-model ensemble trains by adding its MSE to the total loss
  (aux optimizer) on the current batch, instead of a host-side 50k deque with
  a private Adam (``loss/cmpo.py:120-150``).

Inputs dict ``fwd`` keys: logits, logp_all, new_logp, entropy, value [T,M],
h_value, inter (dict of sown intermediates or {}).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from metta_tpu.models import nn

from metta_tpu.rl.scheduler import HP_INDEX


# ---------------------------------------------------------------------------
# Aux modules (trainable parameters owned by losses)
# ---------------------------------------------------------------------------


class ViTReconDecoder(nn.Module):
    """Fourier-queried cross-attention decoder reconstructing token
    observations from the pooled latent
    (parity: ``loss/vit_reconstruction.py:47-152``)."""

    embed_dim: int = 64
    num_heads: int = 4
    num_classes: int = 64

    @nn.compact
    def __call__(self, tokens, latent):
        # tokens: [N, K, 3] uint8; latent: [N, D]
        coords = tokens[..., 0].astype(jnp.int32)          # [N, K]
        x_idx = (coords & 0x0F).astype(jnp.float32)
        y_idx = (coords >> 4).astype(jnp.float32)
        mu = 11.0
        x_n = x_idx / (mu - 1.0) * 2.0 - 1.0
        y_n = y_idx / (mu - 1.0) * 2.0 - 1.0
        freqs = 2.0 ** jnp.arange(3, dtype=jnp.float32)
        xs = x_n[..., None] * freqs
        ys = y_n[..., None] * freqs
        queries_raw = jnp.concatenate(
            [jnp.cos(xs), jnp.sin(xs), jnp.cos(ys), jnp.sin(ys)], axis=-1)  # [N,K,12]

        q = nn.Dense(self.embed_dim, name="query_proj")(queries_raw)
        kv_in = latent[:, None, :]                          # [N, 1, D]
        k = nn.Dense(self.embed_dim, name="key_proj")(kv_in)
        v = nn.Dense(self.embed_dim, name="value_proj")(kv_in)
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, name="cross_attn")(q, k, v)
        pred_logits = nn.Dense(self.num_classes, name="id_head")(attn)
        pred_values = nn.Dense(self.num_classes, name="val_head")(attn)
        return pred_logits, pred_values


class WorldModelEnsemble(nn.Module):
    """Feed-forward dynamics ensemble: (s, a_onehot) → (s + Δs, r̂), averaged
    over members (parity: ``loss/cmpo.py:80-118``)."""

    state_dim: int
    action_dim: int
    hidden: int = 512
    ensemble: int = 5

    @nn.compact
    def __call__(self, state, action_onehot):
        x = jnp.concatenate([state, action_onehot], axis=-1)
        s_sum = 0.0
        r_sum = 0.0
        for i in range(self.ensemble):
            h = nn.Dense(self.hidden, name=f"m{i}_fc1")(x)
            h = nn.relu(nn.LayerNorm(name=f"m{i}_ln")(h))
            out = nn.Dense(self.state_dim + 1, name=f"m{i}_out")(h)
            s_sum = s_sum + (state + out[..., : self.state_dim])
            r_sum = r_sum + out[..., -1]
        return s_sum / self.ensemble, r_sum / self.ensemble


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _inter(fwd, key_name):
    val = fwd["inter"].get(key_name)
    if val is None:
        raise KeyError(
            f"loss requires policy intermediate {key_name!r}; "
            "enable intermediate capture / the matching policy head")
    # sow stores a tuple per call site; scan stacks to [T, 1?, M, ...]
    return val


def distill_kl(student_logits, teacher_logits, temperature):
    """(T²)·KL(teacher ‖ student) with temperature-scaled softmaxes
    (``loss/sliced_kickstarter.py:136-143``)."""
    t_logp = jax.lax.stop_gradient(jax.nn.log_softmax(teacher_logits / temperature))
    s_logp = jax.nn.log_softmax(student_logits / temperature)
    s_p = jnp.exp(s_logp)
    return (temperature ** 2) * jnp.mean(jnp.sum(s_p * (s_logp - t_logp), axis=-1))


def masked_mean(x, mask):
    denom = jnp.maximum(jnp.sum(mask), 1e-6)
    return jnp.sum(x * mask) / denom


def slice_masks(rows, total_rows, student_frac, teacher_frac):
    """Static row partition: [0, sB) student-led, [sB, sB+tB) teacher-led,
    rest PPO (``loss/sliced_kickstarter.py:167-190`` slice semantics)."""
    s_end = int(round(student_frac * total_rows))
    t_end = s_end + int(round(teacher_frac * total_rows))
    student = (rows < s_end).astype(jnp.float32)
    teacher = ((rows >= s_end) & (rows < t_end)).astype(jnp.float32)
    ppo = (rows >= t_end).astype(jnp.float32)
    return student, teacher, ppo


# ---------------------------------------------------------------------------
# Loss terms. Each: (trainer, params_bundle, mb, fwd, hp, loss_state, key)
#   -> (term, metrics_dict)
# ``trainer`` is used for static config/shape info only.
# ---------------------------------------------------------------------------


def kickstarter_terms(trainer, teacher_fwd, mb, fwd, hp):
    """kickstarter + logit_kickstarter + eer_kickstarter + sliced_kickstarter,
    all shapes of teacher-output distillation."""

    ls = trainer.cfg.losses
    terms = 0.0
    metrics = {}
    t_logits, t_value = teacher_fwd

    if ls.kickstarter.enabled:
        ks = ls.kickstarter
        act = distill_kl(fwd["logits"], t_logits, 1.0)
        val = jnp.mean((jax.lax.stop_gradient(t_value) - fwd["value"]) ** 2)
        terms = terms + hp[HP_INDEX["kickstarter_coef"]] * act + ks.value_loss_coef * val
        metrics["ks_act_loss"] = act
        metrics["ks_val_loss"] = val

    if ls.logit_kickstarter.enabled:
        lk = ls.logit_kickstarter
        act = distill_kl(fwd["logits"], t_logits, lk.temperature)
        val = jnp.mean((jax.lax.stop_gradient(t_value) - fwd["value"]) ** 2)
        terms = terms + hp[HP_INDEX["logit_kickstarter_coef"]] * (
            lk.action_loss_coef * act + lk.value_loss_coef * val)
        metrics["logit_ks_act_loss"] = act

    if ls.eer_kickstarter.enabled:
        ek = ls.eer_kickstarter
        t_logp = jax.lax.stop_gradient(jax.nn.log_softmax(t_logits))
        s_p = jnp.exp(fwd["logp_all"])
        act = -jnp.mean(jnp.sum(s_p * t_logp, axis=-1))
        val = jnp.mean((jax.lax.stop_gradient(t_value) - fwd["value"]) ** 2)
        terms = terms + hp[HP_INDEX["eer_kickstarter_coef"]] * (
            ek.action_loss_coef * act + ek.value_loss_coef * val)
        metrics["eer_ks_act_loss"] = act

    if ls.sl_checkpointed_kickstarter.enabled:
        sl = ls.sl_checkpointed_kickstarter
        act = distill_kl(fwd["logits"], t_logits, sl.temperature)
        val = jnp.mean((jax.lax.stop_gradient(t_value) - fwd["value"]) ** 2)
        terms = terms + hp[HP_INDEX["sl_kickstarter_coef"]] * (
            sl.action_loss_coef * act + sl.value_loss_coef * val)
        metrics["sl_ks_act_loss"] = act

    if ls.sliced_kickstarter.enabled:
        sk = ls.sliced_kickstarter
        s_mask, t_mask, _ = slice_masks(mb["rows"], trainer.B,
                                        sk.student_led_proportion, sk.teacher_led_proportion)
        dmask = jnp.maximum(t_mask, s_mask)[None, :]        # distill slice [1, M]
        t_logp = jax.lax.stop_gradient(
            jax.nn.log_softmax(t_logits / sk.temperature))
        s_logp = jax.nn.log_softmax(fwd["logits"] / sk.temperature)
        s_p = jnp.exp(s_logp)
        kl = (sk.temperature ** 2) * jnp.sum(s_p * (s_logp - t_logp), axis=-1)
        act = masked_mean(kl, jnp.broadcast_to(dmask, kl.shape))
        vse = (jax.lax.stop_gradient(t_value) - fwd["value"]) ** 2
        val = masked_mean(vse, jnp.broadcast_to(dmask, vse.shape))
        terms = terms + hp[HP_INDEX["sliced_kickstarter_coef"]] * (
            sk.action_loss_coef * act + sk.value_loss_coef * val)
        metrics["sliced_ks_act_loss"] = act

    return terms, metrics


def cloner_terms(trainer, mb, fwd, hp):
    """eer_cloner + sliced_scripted_cloner + action_supervised: behavior
    cloning of the recorded teacher action."""

    ls = trainer.cfg.losses
    terms = 0.0
    metrics = {}
    ta = mb.get("teacher_actions")
    if ta is None:
        return terms, metrics
    s_logp_a = jnp.take_along_axis(fwd["logp_all"], ta[..., None], axis=-1)[..., 0]

    if ls.action_supervised.enabled:
        ce = -jnp.mean(s_logp_a)
        terms = terms + hp[HP_INDEX["action_supervised_coef"]] * ce
        metrics["supervised_action_loss"] = ce

    if ls.eer_cloner.enabled:
        ce = -jnp.mean(s_logp_a) * ls.eer_cloner.action_loss_coef
        terms = terms + hp[HP_INDEX["eer_cloner_coef"]] * ce
        metrics["eer_cloner_loss"] = ce

    if ls.sliced_scripted_cloner.enabled:
        sc = ls.sliced_scripted_cloner
        s_mask, t_mask, _ = slice_masks(mb["rows"], trainer.B,
                                        sc.student_led_proportion, sc.teacher_led_proportion)
        cmask = jnp.maximum(s_mask, t_mask)[None, :]
        ce = masked_mean(-s_logp_a, jnp.broadcast_to(cmask, s_logp_a.shape))
        terms = terms + hp[HP_INDEX["scripted_cloner_coef"]] * sc.action_loss_coef * ce
        metrics["scripted_cloner_loss"] = ce

    return terms, metrics


def grpo_term(trainer, mb, fwd, hp):
    """GRPO clipped policy gradient on group-relative advantages
    (``loss/grpo.py:117-260``); advantages precomputed full-batch."""

    cfg = trainer.cfg.losses.grpo
    adv = mb["grpo_advantages"]
    if cfg.norm_adv:
        adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)
    logratio = jnp.clip(fwd["new_logp"] - mb["logprob"], -10.0, 10.0)
    ratio = jnp.exp(logratio)
    pg1 = -adv * ratio
    pg2 = -adv * jnp.clip(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
    pg_loss = jnp.mean(jnp.maximum(pg1, pg2))
    ent = jnp.mean(fwd["entropy"])
    term = hp[HP_INDEX["grpo_coef"]] * (pg_loss - cfg.ent_coef * ent)
    return term, {"grpo_policy_loss": pg_loss}


def compute_grpo_advantages(rewards_bt, dones_bt, gamma, group_size):
    """Full-batch group-relative advantages: discounted returns per row,
    minus the mean over each consecutive group of rows
    (``loss/grpo.py:150-210``). Inputs [B, T]; returns [B, T]."""

    def disc(carry, x):
        r, d = x
        carry = r + gamma * carry * (1.0 - d)
        return carry, carry

    B = rewards_bt.shape[0]
    _, returns_rev = jax.lax.scan(
        disc, jnp.zeros((B,), rewards_bt.dtype),
        (rewards_bt.T[::-1], dones_bt.T[::-1]))
    returns = returns_rev[::-1].T                          # [B, T]
    g = max(min(group_size, B), 1)
    n_groups = B // g
    if n_groups == 0:
        return returns - jnp.mean(returns, axis=0, keepdims=True)
    main = returns[: n_groups * g].reshape(n_groups, g, -1)
    adv_main = (main - jnp.mean(main, axis=1, keepdims=True)).reshape(n_groups * g, -1)
    if B > n_groups * g:
        rest = returns[n_groups * g:]
        adv_rest = rest - jnp.mean(rest, axis=0, keepdims=True)
        return jnp.concatenate([adv_main, adv_rest], axis=0)
    return adv_main


def quantile_huber(quantiles, target, tau_hat):
    """Per-row quantile-regression Huber loss: Huber(target − quantiles)
    weighted by |τ̂ − 1{diff<0}|, summed over quantiles
    (``loss/quantile_ppo_critic.py:105-225``). ``target`` broadcasts against
    ``quantiles [..., N]``."""
    diff = target - quantiles
    adiff = jnp.abs(diff)
    huber = jnp.where(adiff < 1.0, 0.5 * diff * diff, adiff - 0.5)
    w = jnp.abs(tau_hat - (diff < 0).astype(jnp.float32))
    return jnp.sum(w * huber, axis=-1)


def quantile_critic_term(trainer, mb, fwd, hp):
    """Quantile-regression value loss (``loss/quantile_ppo_critic.py:105-225``):
    Huber(quantiles, scalar return) weighted by |τ̂ − 1{diff<0}|, with optional
    quantile clipping against the rollout quantiles."""

    cfg = trainer.cfg.losses.quantile_ppo_critic
    vq = _inter(fwd, "value_q")                            # [T, M, N]
    N = vq.shape[-1]
    tau_hat = (2 * jnp.arange(N, dtype=jnp.float32) + 1) / (2 * N)
    returns = mb["advantages"] + mb["value"]               # [T, M]
    target = returns[..., None]

    def qloss(quantiles):
        return quantile_huber(quantiles, target, tau_hat)  # [T, M]

    if cfg.clip_vloss and "value_q_old" in mb:
        old_q = mb["value_q_old"]
        clipped = old_q + jnp.clip(vq - old_q, -cfg.vf_clip_coef, cfg.vf_clip_coef)
        v_loss = jnp.mean(jnp.maximum(qloss(vq), qloss(clipped)))
    else:
        v_loss = jnp.mean(qloss(vq))
    term = hp[HP_INDEX["quantile_vf_coef"]] * cfg.vf_coef * v_loss
    return term, {"quantile_value_loss": v_loss}


def contrastive_term(trainer, aux_apply, mb, fwd, hp, key):
    """InfoNCE with geometric-future positives (``loss/contrastive.py:267``):
    one (anchor, positive) pair per segment row; negatives are the other rows'
    positives; pairs crossing an episode boundary are masked out."""

    cfg = trainer.cfg.losses.contrastive
    core = _inter(fwd, "core_out")                             # [T, M, H]
    T, M = core.shape[:2]
    emb = aux_apply("contrastive_proj", core)              # [T, M, E]
    k1, k2 = jax.random.split(key)
    anchor = jax.random.randint(k1, (M,), 0, max(T - 1, 1))
    delta = 1 + jax.random.geometric(
        k2, p=max(1.0 - cfg.discount, 1e-8), shape=(M,)).astype(jnp.int32)
    positive = jnp.minimum(anchor + delta, T - 1)

    done_csum = jnp.cumsum(mb["done"], axis=0)             # [T, M]
    cols = jnp.arange(M)
    same_ep = (jnp.take_along_axis(done_csum, positive[None, :], axis=0)[0]
               == jnp.take_along_axis(done_csum, anchor[None, :], axis=0)[0])
    valid = same_ep & (positive > anchor)

    a_emb = emb[anchor, cols]                              # [M, E]
    p_emb = emb[positive, cols]
    sims = a_emb @ p_emb.T / cfg.temperature               # [M, M]
    labels = jnp.arange(M)
    logp = jax.nn.log_softmax(
        jnp.where(valid[None, :], sims, -1e30), axis=-1)
    nce = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
    loss = masked_mean(nce, valid.astype(jnp.float32))
    term = hp[HP_INDEX["contrastive_coef"]] * cfg.coef * loss
    return term, {"contrastive_loss": loss,
                  "contrastive_pairs": jnp.sum(valid.astype(jnp.float32))}


def stable_latent_term(trainer, mb, fwd, hp):
    """Mean squared step-to-step core-latent delta, masked at episode
    boundaries (``loss/stable_latent.py:80-120``)."""

    cfg = trainer.cfg.losses.stable_latent
    core = _inter(fwd, "core_out")                             # [T, M, H]
    deltas = jnp.diff(core, axis=0)                        # [T-1, M, H]
    # transition t→t+1 is invalid if step t+1 begins a new episode
    valid = (1.0 - mb["done"][1:])[..., None]
    loss = jnp.sum(deltas ** 2 * valid) / jnp.maximum(
        jnp.sum(valid) * core.shape[-1], 1e-6)
    term = hp[HP_INDEX["stable_latent_coef"]] * cfg.loss_coef * loss
    return term, {"stable_latent_loss": loss}


def future_latent_ema_term(trainer, mb, fwd, hp):
    """MSE between the future-prediction head and the EMA of the next
    ``prediction_horizon`` core latents (``loss/future_latent_ema.py:48-100``)."""

    cfg = trainer.cfg.losses.future_latent_ema
    core = jax.lax.stop_gradient(_inter(fwd, "core_out"))      # [T, M, H]
    pred = _inter(fwd, "future_latent_pred")               # [T, M, H]
    T = core.shape[0]
    h = min(cfg.prediction_horizon, T - 1)
    if h < 1:
        return 0.0, {}
    w = (1.0 - cfg.ema_decay) * cfg.ema_decay ** jnp.arange(h, dtype=jnp.float32)
    # ema_target[t] = sum_k w[k] * core[t+1+k], t in [0, T-1-h]
    targets = sum(w[k] * core[1 + k: T - h + 1 + k] for k in range(h))
    targets = targets / (1.0 - cfg.ema_decay ** h)
    err = (pred[: T - h] - targets) ** 2
    # mask transitions crossing episode ends within the horizon
    dones_win = sum(mb["done"][1 + k: T - h + 1 + k] for k in range(h))
    valid = (dones_win == 0).astype(jnp.float32)[..., None]
    loss = jnp.sum(err * valid) / jnp.maximum(jnp.sum(valid) * core.shape[-1], 1e-6)
    term = hp[HP_INDEX["future_latent_coef"]] * cfg.loss_coef * loss
    return term, {"future_latent_loss": loss}


def vit_reconstruction_term(trainer, aux_apply, mb, fwd, hp):
    """Token-observation reconstruction (``loss/vit_reconstruction.py:243-300``):
    BCE on per-coordinate attribute presence + masked MSE on attribute values."""

    cfg = trainer.cfg.losses.vit_reconstruction
    latent = _inter(fwd, "latent_out")                    # [T, M, D]
    T, M = latent.shape[:2]
    K = trainer.policy_cfg.max_tokens
    tokens = mb["obs"][:, :, :K].reshape(T * M, K, 3)
    latent_f = latent.reshape(T * M, -1)

    pred_logits, pred_values = aux_apply("vit_recon", tokens, latent_f)

    coords = tokens[..., 0].astype(jnp.int32)
    attrs = tokens[..., 1].astype(jnp.int32)
    vals = tokens[..., 2].astype(jnp.float32)
    valid = (coords != 255) & (attrs < cfg.num_attribute_classes)
    safe_attrs = jnp.where(valid, attrs, 0)

    match = (coords[:, :, None] == coords[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    onehot = jax.nn.one_hot(safe_attrs, cfg.num_attribute_classes)
    target_ids = jnp.clip(jnp.einsum("nkj,njc->nkc", match.astype(jnp.float32), onehot), 0, 1)
    target_vals = jnp.einsum("nkj,njc->nkc", match.astype(jnp.float32),
                             onehot * vals[..., None])

    bce = optax_sigmoid_bce(pred_logits, target_ids)
    m = valid[..., None].astype(jnp.float32)
    loss_id = jnp.sum(bce * m) / (jnp.sum(m) * cfg.num_attribute_classes + 1e-6)
    sq = (pred_values - target_vals) ** 2
    vm = m * target_ids
    loss_val = jnp.sum(sq * vm) / (jnp.sum(vm) + 1e-6)
    total = cfg.id_loss_coef * loss_id + cfg.val_loss_coef * loss_val
    term = hp[HP_INDEX["vit_recon_coef"]] * total
    return term, {"vit_recon_loss": total, "vit_id_loss": loss_id,
                  "vit_val_loss": loss_val}


def optax_sigmoid_bce(logits, labels):
    log_p = jax.nn.log_sigmoid(logits)
    log_not_p = jax.nn.log_sigmoid(-logits)
    return -labels * log_p - (1.0 - labels) * log_not_p


def ema_term(trainer, ema_fwd, fwd, hp):
    """Self-distillation MSE against the EMA target network's core latent
    (``loss/ema.py``; the reference compares a dedicated prediction head —
    here the core latent serves as that head)."""

    core = _inter(fwd, "core_out")
    core_t = jax.lax.stop_gradient(ema_fwd)
    loss = jnp.mean((core - core_t) ** 2) * trainer.cfg.losses.ema.loss_coef
    term = hp[HP_INDEX["ema_coef"]] * loss
    return term, {"ema_mse_loss": loss}


def cmpo_policy_target(prior_logp, q_values, temperature, adv_clip, norm_adv):
    """π_CMPO ∝ π_prior · exp(clip(Â/τ, ±adv_clip)), Â = Q − E_prior[Q]
    (``loss/cmpo.py:155-330``). prior_logp/q_values [B, A] → [B, A]."""
    pi_prior = jnp.exp(prior_logp)
    v_prior = jnp.sum(pi_prior * q_values, axis=-1, keepdims=True)
    adv = q_values - v_prior
    if norm_adv:
        adv = adv / jnp.clip(jnp.std(adv, axis=-1, keepdims=True), 1e-6)
    adv_s = jnp.clip(adv / temperature, -adv_clip, adv_clip)
    pi_cmpo = pi_prior * jnp.exp(adv_s)
    return pi_cmpo / jnp.sum(pi_cmpo, axis=-1, keepdims=True)


def cmpo_term(trainer, aux_apply, prior_fwd_fn, wm_params_stopgrad, mb, fwd, hp):
    """CMPO (``loss/cmpo.py:155-330``): π_CMPO ∝ π_prior·exp(clip(Â/τ)) where
    Â comes from one-step world-model lookahead Q values; KL distillation +
    value regression toward the CMPO target, plus the world-model MSE.

    ``prior_fwd_fn(obs_uint8) -> (logp_all, value)`` runs the EMA prior policy
    memory-free on raw observations (as the reference's ``_value_from_obs``)."""

    cfg = trainer.cfg.losses.cmpo
    T, M = mb["actions"].shape
    n_act = trainer.env.compiled.n_actions
    K = trainer.policy_cfg.max_tokens
    obs = mb["obs"][:, :, :K]                              # [T, M, K, 3]
    s = obs.astype(jnp.float32).reshape(T * M, -1) / 255.0  # flattened states
    state_dim = s.shape[-1]

    # --- world-model training term (on current batch transitions) ---
    a_onehot = jax.nn.one_hot(mb["actions"].reshape(-1), n_act)
    s_next = jnp.concatenate([s[M:], s[-M:]], axis=0)      # next step, same row
    valid_tr = (1.0 - mb["done"]).reshape(-1)
    valid_tr = valid_tr * jnp.concatenate(
        [jnp.ones(((T - 1) * M,)), jnp.zeros((M,))])
    pred_s, pred_r = aux_apply("cmpo_wm", jax.lax.stop_gradient(s),
                               jax.lax.stop_gradient(a_onehot))
    rew_next = jnp.concatenate([mb["reward"][1:], mb["reward"][-1:]], axis=0).reshape(-1)
    wm_loss = (masked_mean(jnp.mean((pred_s - jax.lax.stop_gradient(s_next)) ** 2, -1), valid_tr)
               + masked_mean((pred_r - jax.lax.stop_gradient(rew_next)) ** 2, valid_tr))

    # --- Q values via one-step lookahead with the (frozen) world model ---
    def q_for_action(a_idx):
        a_oh = jnp.broadcast_to(jax.nn.one_hot(a_idx, n_act), (T * M, n_act))
        ns, r = aux_apply("cmpo_wm", s, a_oh, params_override=wm_params_stopgrad)
        ns_obs = jnp.clip(jnp.round(ns * 255.0), 0, 255).astype(jnp.uint8)
        ns_obs = ns_obs.reshape(T * M, K, 3)
        _, v = prior_fwd_fn(ns_obs)
        return r + trainer.cfg.advantage.gamma * v

    q_values = jax.lax.stop_gradient(
        jax.vmap(q_for_action)(jnp.arange(n_act)).T)       # [T*M, A]

    prior_logp, _ = prior_fwd_fn(obs.reshape(T * M, K, 3))
    prior_logp = jax.lax.stop_gradient(prior_logp)         # [T*M, A]
    pi_cmpo = jax.lax.stop_gradient(cmpo_policy_target(
        prior_logp, q_values, cfg.temperature, cfg.adv_clip, cfg.norm_adv))

    log_pi = fwd["logp_all"].reshape(T * M, n_act)
    kl_loss = -jnp.mean(jnp.sum(pi_cmpo * log_pi, axis=-1))
    v_target = jnp.sum(pi_cmpo * q_values, axis=-1)
    value_loss = 0.5 * jnp.mean((fwd["value"].reshape(T * M) - v_target) ** 2)
    entropy = jnp.mean(fwd["entropy"])

    loss = kl_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    term = hp[HP_INDEX["cmpo_coef"]] * cfg.coef * loss + wm_loss
    return term, {"cmpo_kl_loss": kl_loss, "cmpo_value_loss": value_loss,
                  "cmpo_wm_loss": wm_loss}


# ---------------------------------------------------------------------------
# Aux-module registry: which trainable aux modules each run needs
# ---------------------------------------------------------------------------


def build_aux_modules(trainer) -> Dict[str, nn.Module]:
    ls = trainer.cfg.losses
    mods: Dict[str, nn.Module] = {}
    if ls.vit_reconstruction.enabled:
        v = ls.vit_reconstruction
        mods["vit_recon"] = ViTReconDecoder(
            embed_dim=v.decoder_embed_dim, num_heads=v.decoder_num_heads,
            num_classes=v.num_attribute_classes)
    if ls.contrastive.enabled:
        mods["contrastive_proj"] = nn.Dense(ls.contrastive.embed_dim)
    if ls.cmpo.enabled:
        K = trainer.policy_cfg.max_tokens
        mods["cmpo_wm"] = WorldModelEnsemble(
            state_dim=K * 3, action_dim=trainer.env.compiled.n_actions,
            hidden=ls.cmpo.world_model.hidden_dim,
            ensemble=ls.cmpo.world_model.ensemble_size)
    return mods


def init_aux_params(trainer, key) -> Dict[str, Any]:
    mods = build_aux_modules(trainer)
    params = {}
    K = trainer.policy_cfg.max_tokens
    for name, mod in mods.items():
        key, k = jax.random.split(key)
        if name == "vit_recon":
            params[name] = mod.init(
                k, jnp.zeros((1, K, 3), jnp.uint8),
                jnp.zeros((1, trainer.policy_cfg.latent_dim)))
        elif name == "contrastive_proj":
            params[name] = mod.init(
                k, jnp.zeros((1, trainer.policy_cfg.latent_dim)))
        elif name == "cmpo_wm":
            params[name] = mod.init(
                k, jnp.zeros((1, K * 3)),
                jnp.zeros((1, trainer.env.compiled.n_actions)))
    return params


def any_teacher_loss(ls) -> bool:
    return any([
        ls.kickstarter.enabled, ls.logit_kickstarter.enabled,
        ls.eer_kickstarter.enabled, ls.sliced_kickstarter.enabled,
        ls.sl_checkpointed_kickstarter.enabled,
    ])


def any_cloner_loss(ls) -> bool:
    return any([ls.action_supervised.enabled, ls.eer_cloner.enabled,
                ls.sliced_scripted_cloner.enabled])


def needs_intermediates(ls) -> bool:
    return any([
        ls.contrastive.enabled, ls.stable_latent.enabled,
        ls.future_latent_ema.enabled, ls.vit_reconstruction.enabled,
        ls.quantile_ppo_critic.enabled, ls.ema.enabled,
    ])


def ppo_row_mask(trainer, rows):
    """Rows the PPO losses may train on (1.0 everywhere unless a sliced loss
    reserves teacher/student rows)."""

    ls = trainer.cfg.losses
    if ls.sliced_kickstarter.enabled:
        sk = ls.sliced_kickstarter
        _, _, ppo = slice_masks(rows, trainer.B,
                                sk.student_led_proportion, sk.teacher_led_proportion)
        return ppo
    if ls.sliced_scripted_cloner.enabled:
        sc = ls.sliced_scripted_cloner
        _, _, ppo = slice_masks(rows, trainer.B,
                                sc.student_led_proportion, sc.teacher_led_proportion)
        return ppo
    return jnp.ones_like(rows, jnp.float32)
