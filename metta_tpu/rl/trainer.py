"""On-device PPO actor-learner.

The on-device replacement for the reference trainer stack
(``metta/rl/trainer.py`` + ``training/core.py`` + ``training/experience.py``):
instead of env worker processes feeding a GPU learner through shared memory,
the rollout is a ``lax.scan`` over ``bptt_horizon`` steps alternating
``policy.apply`` and the vectorized env step, writing the trajectory directly
into HBM; the advantage pass and minibatched PPO updates run in the same jitted
program. One call to ``update`` = one full train batch (rollout → advantage →
update_epochs × minibatches) with zero host↔device traffic.

Loss parity: all 17 reference loss families (``loss/losses.py:33-120``) are
implemented — PPO actor/critic inline below (clipped PG + entropy with the
clamp(-10,10) log-ratio, clipped value MSE or the default GTD(λ) update), the
15 auxiliary families in ``rl/losses.py`` — each compile-gated by its
``enabled`` flag and runtime-scaled via the scheduler hp vector. KL early stop
(``target_kl``, reference ``training/core.py:191+``) masks remaining minibatch
updates inside the jitted epoch loop.

Recurrent state: persistent during rollout (reset on episode end), zero per
BPTT segment in the learner (``policies/vit.py:38``
``pass_state_during_training=False``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from metta_tpu.config.mettagrid_config import MettaGridConfig
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.models.vit import ViTConfig
from metta_tpu.rl import losses as L
from metta_tpu.rl.advantage import compute_delta_lambda, normalize_advantage, puff_advantage
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.rl.scheduler import HP_FIELDS, HP_INDEX
from metta_tpu.utils import struct


@struct.dataclass
class TrainState:
    params: Any
    opt_state: Any
    key: jnp.ndarray
    vstate: Any                 # VecEnvState
    obs: jnp.ndarray            # [E, A, T_tok, 3] uint8 (current)
    core: Any                   # recurrent state, [B, ...]
    prev_reward: jnp.ndarray    # [B] f32 — reward received with current obs
    prev_done: jnp.ndarray      # [B] f32 — done flag of current obs
    r_bar: jnp.ndarray          # [] f32 reward-centering EMA
    update_idx: jnp.ndarray     # [] int32
    aux_params: Any = None      # trainable loss-owned modules (rl/losses.py)
    aux_opt_state: Any = None
    loss_state: Any = None      # non-trained loss state (EMA/prior param trees)


@struct.dataclass
class Trajectory:
    obs: jnp.ndarray        # [T, B, K, 3] uint8
    actions: jnp.ndarray    # [T, B] int32
    logprob: jnp.ndarray    # [T, B] f32
    value: jnp.ndarray      # [T, B] f32
    reward: jnp.ndarray     # [T, B] f32 (received on arriving at obs_t)
    done: jnp.ndarray       # [T, B] f32 (obs_t begins a new episode)
    teacher_actions: Any = None   # [T, B] int32 when a teacher/cloner is active
    value_q: Any = None           # [T, B, N] rollout quantiles (quantile critic)


def make_optimizer(cfg: TrainerConfig):
    oc = cfg.optimizer
    if oc.type == "adamw_schedulefree" and hasattr(optax.contrib, "schedule_free_adamw"):
        base = optax.contrib.schedule_free_adamw(
            learning_rate=oc.learning_rate, b1=oc.beta1, b2=oc.beta2,
            eps=oc.eps, weight_decay=oc.weight_decay, warmup_steps=oc.warmup_steps,
        )
    elif oc.type in ("adamw", "adamw_schedulefree"):
        base = optax.adamw(oc.learning_rate, b1=oc.beta1, b2=oc.beta2,
                           eps=oc.eps, weight_decay=oc.weight_decay)
    elif oc.type == "adam":
        base = optax.adam(oc.learning_rate, b1=oc.beta1, b2=oc.beta2, eps=oc.eps)
    else:
        base = optax.sgd(oc.learning_rate)
    return optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), base)


class Trainer:
    """Single-host trainer; see metta_tpu.parallel for the multi-chip version."""

    def __init__(
        self,
        env_cfg: Optional[MettaGridConfig],
        trainer_cfg: Optional[TrainerConfig] = None,
        policy_cfg: Optional[ViTConfig] = None,
        num_envs: Optional[int] = None,
        task_cfgs: Optional[list] = None,
    ):
        """``task_cfgs``: train over a task *set* instead of one env config —
        per-env per-episode curriculum tasks with runtime sampling weights
        (engine/taskset.py; reference CurriculumEnv parity). The task-set
        data (tables/templates/weights) is threaded through the jitted update
        as a traced argument, so weight updates and task-slot replacement
        never recompile."""
        self.cfg = trainer_cfg or TrainerConfig()
        cfg = self.cfg
        self.multi_task = task_cfgs is not None
        base_cfg = task_cfgs[0] if self.multi_task else env_cfg
        A = base_cfg.game.num_agents
        T = cfg.bptt_horizon
        if num_envs is None:
            num_envs = cfg.num_envs or max(cfg.batch_size // (T * A), 1)
        # training env: stat accumulators off unless a reward reads them
        if self.multi_task:
            from metta_tpu.engine.taskset import MultiTaskEnv

            self.env = MultiTaskEnv(task_cfgs, num_envs=num_envs,
                                    track_stats=cfg.track_env_stats,
                                    step_mode=cfg.env_step_mode)
        else:
            self.env = MettaGridEnv(env_cfg, num_envs=num_envs,
                                    track_stats=cfg.track_env_stats,
                                    step_mode=cfg.env_step_mode)
        self.E = num_envs
        self.A = A
        self.B = num_envs * A
        self.T = T
        self.rows_per_mb = max(cfg.minibatch_size // T, 1)
        if self.B % self.rows_per_mb != 0:
            # shrink to a divisor
            while self.B % self.rows_per_mb != 0:
                self.rows_per_mb -= 1
        self.n_minibatches = self.B // self.rows_per_mb

        pcfg = policy_cfg or ViTConfig()
        ls = cfg.losses
        if ls.quantile_ppo_critic.enabled and pcfg.num_quantiles <= 0:
            pcfg.num_quantiles = 16
        if ls.future_latent_ema.enabled:
            pcfg.predict_future = True
        self.policy_cfg = pcfg
        self.policy = pcfg.make(
            n_actions=self.env.compiled.n_actions,
            feature_norms=self.env.compiled.feature_normalizations,
        )
        self.tx = make_optimizer(cfg)

        # --- loss wiring (compile-time gates; see rl/losses.py) ---
        self._need_inter = L.needs_intermediates(ls)
        self._need_teacher = L.any_teacher_loss(ls)
        self._record_teacher = (
            L.any_cloner_loss(ls) or ls.sliced_kickstarter.enabled)
        self.aux_modules = L.build_aux_modules(self)
        self.aux_tx = optax.adam(3e-4) if self.aux_modules else None

        self.teacher = None  # (policy, params) for the distillation family
        teacher_uri = None
        for lc in (ls.kickstarter, ls.sliced_kickstarter, ls.logit_kickstarter,
                   ls.eer_kickstarter, ls.eer_cloner, ls.sliced_scripted_cloner):
            if lc.enabled and getattr(lc, "teacher_uri", None):
                teacher_uri = lc.teacher_uri
                break
        if teacher_uri:
            self._load_teacher(teacher_uri)
        self._update_jit = jax.jit(self._update, donate_argnums=(0,))
        self.agent_steps = 0

    def _load_teacher(self, uri: str):
        from metta_tpu.rl.checkpoint import load_policy_bundle, resolve_uri

        params, policy_cfg, _ = load_policy_bundle(resolve_uri(uri))
        teacher = policy_cfg.make(
            self.env.compiled.n_actions, self.env.compiled.feature_normalizations
        )
        obs0 = jnp.zeros((1, policy_cfg.max_tokens, 3), jnp.uint8)
        like = teacher.init(jax.random.PRNGKey(0), obs0, teacher.initial_state(1))
        params, _, _ = load_policy_bundle(resolve_uri(uri), params_like=like)
        self.set_teacher(teacher, params)

    def set_teacher(self, policy, params):
        self.teacher = (policy, params)
        self._update_jit = jax.jit(self._update, donate_argnums=(0,))

    # ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        key = jax.random.PRNGKey(self.cfg.seed if seed is None else seed)
        key, k_env, k_par, k_aux = jax.random.split(key, 4)
        if self.multi_task:
            vstate, obs = self.env._reset_fn(k_env, self.env.tsdata)
        else:
            vstate, obs = self.env.reset_fn(k_env)
        obs_flat = obs.reshape(self.B, *obs.shape[2:])
        core = self.policy.initial_state(self.B)
        params = self.policy.init(k_par, obs_flat[: self.B], core)
        opt_state = self.tx.init(params)

        aux_params = L.init_aux_params(self, k_aux) if self.aux_modules else None
        aux_opt_state = self.aux_tx.init(aux_params) if self.aux_modules else None
        loss_state = {}
        ls = self.cfg.losses
        if ls.ema.enabled:
            loss_state["ema_target"] = jax.tree.map(jnp.copy, params)
        if ls.cmpo.enabled:
            loss_state["cmpo_prior"] = jax.tree.map(jnp.copy, params)

        return TrainState(
            params=params, opt_state=opt_state, key=key, vstate=vstate,
            obs=obs, core=core,
            prev_reward=jnp.zeros((self.B,), jnp.float32),
            prev_done=jnp.zeros((self.B,), jnp.float32),
            r_bar=jnp.float32(self.cfg.advantage.reward_centering.initial_reward_mean),
            update_idx=jnp.int32(0),
            aux_params=aux_params, aux_opt_state=aux_opt_state,
            loss_state=loss_state,
        )

    # ------------------------------------------------------------------

    def _aux_apply(self, aux_params):
        def apply(name, *args, params_override=None):
            p = params_override if params_override is not None else aux_params[name]
            return self.aux_modules[name].apply(p, *args)
        return apply

    def _teacher_led_mask(self):
        """[B] 1.0 where the teacher picks the executed rollout action."""
        ls = self.cfg.losses
        rows = jnp.arange(self.B)
        if ls.sliced_kickstarter.enabled:
            sk = ls.sliced_kickstarter
            _, t, _ = L.slice_masks(rows, self.B, sk.student_led_proportion,
                                    sk.teacher_led_proportion)
            return t
        if ls.sliced_scripted_cloner.enabled:
            sc = ls.sliced_scripted_cloner
            _, t, _ = L.slice_masks(rows, self.B, sc.student_led_proportion,
                                    sc.teacher_led_proportion)
            return t
        return jnp.zeros((self.B,), jnp.float32)

    def _rollout(self, ts: TrainState, tsdata=None):
        E, A, B, K = self.E, self.A, self.B, self.policy_cfg.max_tokens
        use_teacher = self._record_teacher and self.teacher is not None
        quantile = self.cfg.losses.quantile_ppo_critic.enabled
        t_led = self._teacher_led_mask() if use_teacher else None

        def step_fn(carry, _):
            key, vstate, obs, core, prev_rew, prev_done, t_core = carry
            obs_flat = obs.reshape(B, obs.shape[2], 3)
            if quantile:
                (logits, value, _hv, core2), ivars = self.policy.apply(
                    ts.params, obs_flat, core, mutable=["intermediates"])
                value_q = ivars["intermediates"]["value_q"][0]
            else:
                logits, value, _hv, core2 = self.policy.apply(ts.params, obs_flat, core)
                value_q = None
            key, k_act, k_t = jax.random.split(key, 3)
            action = jax.random.categorical(k_act, logits)

            teacher_action = None
            if use_teacher:
                t_policy, t_params = self.teacher
                t_logits, _tv, _th, t_core = t_policy.apply(
                    t_params, obs_flat[:, : t_policy.cfg.max_tokens], t_core)
                teacher_action = jax.random.categorical(k_t, t_logits)
                # teacher-led rows execute the teacher's action
                action = jnp.where(t_led > 0, teacher_action, action)

            logp = jnp.take_along_axis(
                jax.nn.log_softmax(logits), action[:, None], axis=1
            )[:, 0]
            env_action = action.reshape(E, A).astype(jnp.int32)
            if self.multi_task:
                vstate2, obs2, rew, done, trunc = self.env.step_core(
                    vstate, env_action, tsdata
                )
            else:
                vstate2, obs2, rew, done, trunc = self.env.step_core(
                    vstate, env_action
                )
            ended = (done | trunc).astype(jnp.float32)           # [E]
            dn = jnp.repeat(ended, A)                            # [B]
            zero_state = lambda s: jax.tree.map(  # noqa: E731
                lambda z: jnp.where(dn.reshape((B,) + (1,) * (z.ndim - 1)) > 0,
                                    jnp.zeros_like(z), z), s)
            core3 = zero_state(core2)
            if use_teacher:
                t_core = zero_state(t_core)
            out = Trajectory(
                obs=obs_flat[:, :K],
                actions=action.astype(jnp.int32),
                logprob=logp,
                value=value,
                reward=prev_rew,
                done=prev_done,
                teacher_actions=(teacher_action.astype(jnp.int32)
                                 if use_teacher else None),
                value_q=value_q,
            )
            return (key, vstate2, obs2, core3, rew.reshape(-1), dn, t_core), out

        t_core0 = self.teacher[0].initial_state(B) if use_teacher else None
        carry0 = (ts.key, ts.vstate, ts.obs, ts.core, ts.prev_reward,
                  ts.prev_done, t_core0)
        (key, vstate, obs, core, prev_rew, prev_done, _), traj = jax.lax.scan(
            step_fn, carry0, None, length=self.T
        )
        ts = ts.replace(key=key, vstate=vstate, obs=obs, core=core,
                        prev_reward=prev_rew, prev_done=prev_done)
        return ts, traj

    # ------------------------------------------------------------------

    def _sequence_forward(self, params, obs_seq, rows, want_inter=False):
        """Forward a [T, M, K, 3] obs sequence with zero initial state.

        Returns (logits, value, h_value, inter) where ``inter`` maps sown
        intermediate names to [T, M, ...] stacks (empty unless requested).

        Policies advertising ``supports_sequence`` take the whole segment in
        ONE apply: encoder and heads batch over T·M (large matmuls
        instead of T skinny ones) and chunkwise-parallel cells (mLSTM)
        process the segment without a step scan."""
        core0 = self.policy.initial_state(rows)

        if getattr(self.policy, "supports_sequence", False):
            if want_inter:
                (logits, value, h_value, _), ivars = self.policy.apply(
                    params, obs_seq, core0, mutable=["intermediates"])
                inter = {k: v[0] for k, v in ivars["intermediates"].items()}
                return logits, value, h_value, inter
            logits, value, h_value, _ = self.policy.apply(params, obs_seq, core0)
            return logits, value, h_value, {}

        if want_inter:
            def step(core, obs_t):
                (logits, value, h_value, core), ivars = self.policy.apply(
                    params, obs_t, core, mutable=["intermediates"])
                inter = {k: v[0] for k, v in ivars["intermediates"].items()}
                return core, (logits, value, h_value, inter)

            step = jax.checkpoint(step)
            _, (logits, value, h_value, inter) = jax.lax.scan(step, core0, obs_seq)
            return logits, value, h_value, inter

        def step(core, obs_t):
            logits, value, h_value, core = self.policy.apply(params, obs_t, core)
            return core, (logits, value, h_value)

        step = jax.checkpoint(step)
        _, (logits, value, h_value) = jax.lax.scan(step, core0, obs_seq)
        return logits, value, h_value, {}

    def _teacher_forward(self, mb_obs):
        """Teacher logits/values over a [T, M, K, 3] sequence, zero-init."""
        t_policy, t_params = self.teacher
        Kt = t_policy.cfg.max_tokens
        obs = mb_obs[:, :, :Kt]

        def step(core, obs_t):
            t_logits, t_v, _th, core = t_policy.apply(t_params, obs_t, core)
            return core, (t_logits, t_v)

        _, (t_logits, t_values) = jax.lax.scan(
            step, t_policy.initial_state(obs.shape[1]), obs)
        return jax.lax.stop_gradient(t_logits), jax.lax.stop_gradient(t_values)

    def _loss_fn(self, bundle, mb, hp, loss_state, key, axis_name=None):
        """Total loss on one minibatch dict of [T, M] arrays.

        ``bundle`` = (policy params, aux params); ``hp`` is the runtime
        scheduled-coefficient vector (rl/scheduler.py HP_FIELDS order) so
        schedules never trigger recompiles.
        """
        params, aux_params = bundle
        cfg = self.cfg
        ls = cfg.losses
        ac = ls.ppo_actor
        cc = ls.ppo_critic
        clip_coef = hp[HP_INDEX["ppo_clip_coef"]]
        ent_coef = hp[HP_INDEX["ppo_ent_coef"]]
        vf_coef = hp[HP_INDEX["vf_coef"]]

        logits, value, h_value, inter = self._sequence_forward(
            params, mb["obs"], mb["obs"].shape[1], want_inter=self._need_inter
        )
        logp_all = jax.nn.log_softmax(logits)                    # [T, M, n_act]
        new_logp = jnp.take_along_axis(logp_all, mb["actions"][..., None], axis=2)[..., 0]
        entropy = -jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1)

        logratio = jnp.clip(new_logp - mb["logprob"], -10.0, 10.0)
        ratio = jnp.exp(logratio)

        # PPO rows: sliced distillation losses reserve teacher/student rows
        row_mask = L.ppo_row_mask(self, mb["rows"])              # [M]
        pm = jnp.broadcast_to(row_mask[None, :], ratio.shape)    # [T, M]
        if cc.burn_in_steps > 0:
            # recurrent burn-in: the first steps of each BPTT segment warm up
            # the zero-initialized core and are excluded from every loss
            # (parity: loss/ppo_critic.py:56-91 skipping early stores)
            T_mb = ratio.shape[0]
            tmask = (jnp.arange(T_mb) >= cc.burn_in_steps).astype(pm.dtype)
            pm = pm * tmask[:, None]

        # [M, T] time-major → row-major for the scans
        v_bt = value.T
        rew_bt = mb["reward"].T
        done_bt = mb["done"].T

        run_std_critic = not ls.quantile_ppo_critic.enabled
        if run_std_critic and cc.critic_update == "gtd_lambda":
            dl = compute_delta_lambda(v_bt, rew_bt, done_bt,
                                      cfg.advantage.gamma, cfg.advantage.gae_lambda)
            adv = dl.T                                            # actor uses δλ
            dl_t = dl[:, :-1]
            v_t = v_bt[:, :-1]
            h_bt = h_value.T[:, :-1]
            h_sg = jax.lax.stop_gradient(h_bt)
            dl_sg = jax.lax.stop_gradient(dl_t)
            pmt = pm.T[:, :-1]
            critic_loss = (L.masked_mean(h_sg * dl_t, pmt)
                           - L.masked_mean((dl_sg - h_sg) * v_t, pmt))
            aux_p = params["params"]["gtd_aux"]
            leaves = jax.tree.leaves(aux_p)
            l2 = sum(jnp.sum(p * p) for p in leaves) / max(sum(p.size for p in leaves), 1)
            aux_loss = 0.5 * L.masked_mean((dl_sg - h_bt) ** 2, pmt) + 0.5 * cc.beta * l2
            v_loss = vf_coef * critic_loss + cc.aux_coef * aux_loss
        elif run_std_critic:
            adv = mb["advantages"]
            returns = mb["advantages"] + mb["value"]
            if cc.clip_vloss:
                v_unclipped = (value - returns) ** 2
                v_clipped_pred = mb["value"] + jnp.clip(
                    value - mb["value"], -cc.vf_clip_coef, cc.vf_clip_coef
                )
                v_clipped = (v_clipped_pred - returns) ** 2
                v_loss = 0.5 * L.masked_mean(jnp.maximum(v_unclipped, v_clipped), pm)
            else:
                v_loss = 0.5 * L.masked_mean((value - returns) ** 2, pm)
            v_loss = vf_coef * v_loss
        else:
            adv = mb["advantages"]
            v_loss = jnp.float32(0.0)

        adv = jax.lax.stop_gradient(adv)
        if ac.norm_adv:
            adv = normalize_advantage(adv, axis_name)
        if "prio_weights" in mb:
            # prioritized-replay IS correction (loss/ppo_actor.py:104-105)
            adv = adv * mb["prio_weights"][None, :]
        pg1 = -adv * ratio
        pg2 = -adv * jnp.clip(ratio, 1 - clip_coef, 1 + clip_coef)
        pg_loss = L.masked_mean(jnp.maximum(pg1, pg2), pm)
        ent_loss = L.masked_mean(entropy, pm)

        loss = pg_loss - ent_coef * ent_loss + v_loss

        # --- auxiliary loss families (rl/losses.py) ---
        fwd = dict(logits=logits, logp_all=logp_all, new_logp=new_logp,
                   entropy=entropy, value=value, h_value=h_value, inter=inter)
        metrics = {}

        if self._need_teacher and self.teacher is not None:
            teacher_fwd = self._teacher_forward(mb["obs"])
            term, m = L.kickstarter_terms(self, teacher_fwd, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if L.any_cloner_loss(ls) and "teacher_actions" in mb:
            term, m = L.cloner_terms(self, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.grpo.enabled:
            term, m = L.grpo_term(self, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.quantile_ppo_critic.enabled:
            term, m = L.quantile_critic_term(self, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.contrastive.enabled:
            term, m = L.contrastive_term(
                self, self._aux_apply(aux_params), mb, fwd, hp, key)
            loss = loss + term
            metrics.update(m)

        if ls.stable_latent.enabled:
            term, m = L.stable_latent_term(self, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.future_latent_ema.enabled:
            term, m = L.future_latent_ema_term(self, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.vit_reconstruction.enabled:
            term, m = L.vit_reconstruction_term(
                self, self._aux_apply(aux_params), mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.ema.enabled:
            _, _, _, ema_inter = self._sequence_forward(
                loss_state["ema_target"], mb["obs"], mb["obs"].shape[1],
                want_inter=True)
            term, m = L.ema_term(self, ema_inter["core_out"], fwd, hp)
            loss = loss + term
            metrics.update(m)

        if ls.cmpo.enabled:
            prior_params = loss_state["cmpo_prior"]

            def prior_fwd(obs_u8):
                n = obs_u8.shape[0]
                lg, v, _h, _c = self.policy.apply(
                    prior_params, obs_u8, self.policy.initial_state(n))
                return jax.nn.log_softmax(lg), v

            wm_sg = jax.lax.stop_gradient(aux_params["cmpo_wm"])
            term, m = L.cmpo_term(
                self, self._aux_apply(aux_params), prior_fwd, wm_sg, mb, fwd, hp)
            loss = loss + term
            metrics.update(m)

        approx_kl = jnp.mean((ratio - 1) - logratio)
        clipfrac = jnp.mean((jnp.abs(ratio - 1.0) > ac.clip_coef).astype(jnp.float32))
        metrics.update(dict(
            policy_loss=pg_loss, value_loss=v_loss, entropy=ent_loss,
            approx_kl=approx_kl, clipfrac=clipfrac,
        ))
        return loss, metrics

    # ------------------------------------------------------------------

    def _metric_template(self):
        """Zero-valued metric dict matching _loss_fn's output keys (static)."""
        ls = self.cfg.losses
        keys = ["policy_loss", "value_loss", "entropy", "approx_kl", "clipfrac"]
        if self.cfg.grad_stats:
            keys += ["grad/mean", "grad/variance", "grad/norm"]
        if self._need_teacher and self.teacher is not None:
            if ls.kickstarter.enabled:
                keys += ["ks_act_loss", "ks_val_loss"]
            if ls.logit_kickstarter.enabled:
                keys += ["logit_ks_act_loss"]
            if ls.eer_kickstarter.enabled:
                keys += ["eer_ks_act_loss"]
            if ls.sliced_kickstarter.enabled:
                keys += ["sliced_ks_act_loss"]
            if ls.sl_checkpointed_kickstarter.enabled:
                keys += ["sl_ks_act_loss"]
        if L.any_cloner_loss(ls) and self._record_teacher and self.teacher is not None:
            if ls.action_supervised.enabled:
                keys += ["supervised_action_loss"]
            if ls.eer_cloner.enabled:
                keys += ["eer_cloner_loss"]
            if ls.sliced_scripted_cloner.enabled:
                keys += ["scripted_cloner_loss"]
        if ls.grpo.enabled:
            keys += ["grpo_policy_loss"]
        if ls.quantile_ppo_critic.enabled:
            keys += ["quantile_value_loss"]
        if ls.contrastive.enabled:
            keys += ["contrastive_loss", "contrastive_pairs"]
        if ls.stable_latent.enabled:
            keys += ["stable_latent_loss"]
        if ls.future_latent_ema.enabled:
            keys += ["future_latent_loss"]
        if ls.vit_reconstruction.enabled:
            keys += ["vit_recon_loss", "vit_id_loss", "vit_val_loss"]
        if ls.ema.enabled:
            keys += ["ema_mse_loss"]
        if ls.cmpo.enabled:
            keys += ["cmpo_kl_loss", "cmpo_value_loss", "cmpo_wm_loss"]
        return {k: jnp.float32(0.0) for k in keys}

    def default_hp(self):
        """Base scheduled-coefficient vector from the config."""
        ls = self.cfg.losses
        base = {name: 0.0 for name in HP_FIELDS}
        base.update({
            "ppo_clip_coef": ls.ppo_actor.clip_coef,
            "ppo_ent_coef": ls.ppo_actor.ent_coef,
            "vf_coef": ls.ppo_critic.vf_coef,
        })
        gates = {
            "kickstarter_coef": (ls.kickstarter, "action_loss_coef"),
            "action_supervised_coef": (ls.action_supervised, "coef"),
            "sliced_kickstarter_coef": (ls.sliced_kickstarter, None),
            "logit_kickstarter_coef": (ls.logit_kickstarter, None),
            "scripted_cloner_coef": (ls.sliced_scripted_cloner, None),
            "sl_kickstarter_coef": (ls.sl_checkpointed_kickstarter, None),
            "eer_kickstarter_coef": (ls.eer_kickstarter, None),
            "eer_cloner_coef": (ls.eer_cloner, None),
            "ema_coef": (ls.ema, None),
            "cmpo_coef": (ls.cmpo, None),
            "grpo_coef": (ls.grpo, "coef"),
            "quantile_vf_coef": (ls.quantile_ppo_critic, None),
            "contrastive_coef": (ls.contrastive, None),
            "stable_latent_coef": (ls.stable_latent, None),
            "future_latent_coef": (ls.future_latent_ema, None),
            "vit_recon_coef": (ls.vit_reconstruction, None),
        }
        for name, (lc, attr) in gates.items():
            if lc.enabled:
                base[name] = float(getattr(lc, attr)) if attr else 1.0
        return [float(base[n]) for n in HP_FIELDS]

    def update(self, ts: TrainState, hp=None, active_epochs=None):
        """One train batch; hp overrides the scheduled coefficients.
        active_epochs (runtime scalar) masks trailing update epochs — the
        autotuner's knob; no recompile when it changes."""
        if hp is None:
            hp = jnp.asarray(self.default_hp(), jnp.float32)
        else:
            hp = jnp.asarray(hp, jnp.float32)
        if active_epochs is None:
            active_epochs = self.cfg.update_epochs
        active_epochs = jnp.asarray(active_epochs, jnp.int32)
        if self.multi_task:
            # tsdata is a traced arg only on the multi-task path — the
            # distributed trainer's shard_map specs take the 3-arg form
            if self.cfg.rollout_chunks > 1:
                return self._update_chunked(ts, hp, active_epochs, self.env.tsdata)
            return self._update_jit(ts, hp, active_epochs, self.env.tsdata)
        if self.cfg.rollout_chunks > 1:
            return self._update_chunked(ts, hp, active_epochs)
        return self._update_jit(ts, hp, active_epochs)

    # -- chunked path: several shorter device programs per update (see
    # TrainerConfig.rollout_chunks) --------------------------------------

    def _ensure_chunked_jits(self):
        if getattr(self, "_chunk_jits", None) is not None:
            return
        n_chunks = self.cfg.rollout_chunks
        assert self.T % n_chunks == 0, "bptt_horizon must divide rollout_chunks"
        Tc = self.T // n_chunks

        def rollout_chunk(ts, tsdata=None):
            saved_T = self.T
            self.T = Tc
            try:
                ts, traj = self._rollout(ts, tsdata)
            finally:
                self.T = saved_T
            return ts, traj

        def learn(ts, traj, hp, active_epochs):
            return self._learn_phase(ts, traj, hp, active_epochs, axis_name=None)

        self._chunk_jits = (
            jax.jit(rollout_chunk, donate_argnums=(0,)),
            jax.jit(learn, donate_argnums=(1,)),
        )

    def _update_chunked(self, ts: TrainState, hp, active_epochs, tsdata=None):
        self._ensure_chunked_jits()
        roll_jit, learn_jit = self._chunk_jits
        chunks = []
        for _ in range(self.cfg.rollout_chunks):
            ts, traj = roll_jit(ts, tsdata)
            chunks.append(traj)
        traj = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *chunks)
        return learn_jit(ts, traj, hp, active_epochs)

    def _update(self, ts: TrainState, hp, active_epochs=None, tsdata=None,
                axis_name=None):
        if active_epochs is None:
            active_epochs = jnp.int32(self.cfg.update_epochs)
        ts, traj = self._rollout(ts, tsdata)
        return self._learn_phase(ts, traj, hp, active_epochs, axis_name)

    def _learn_phase(self, ts: TrainState, traj, hp, active_epochs=None,
                     axis_name=None):
        if active_epochs is None:
            active_epochs = jnp.int32(self.cfg.update_epochs)
        cfg = self.cfg
        ls = cfg.losses
        adv_cfg = cfg.advantage
        B = self.B
        T = traj.reward.shape[0]

        # reward centering EMA (trainer_config.py:36-40)
        rc = adv_cfg.reward_centering
        if rc.enabled:
            batch_mean = jnp.mean(traj.reward)
            if axis_name is not None:
                batch_mean = jax.lax.pmean(batch_mean, axis_name)
            r_bar = ts.r_bar + rc.beta * (batch_mean - ts.r_bar)
            rewards_c = traj.reward - r_bar
            ts = ts.replace(r_bar=r_bar)
        else:
            rewards_c = traj.reward

        # full-batch vtrace advantages, [B, T] layout
        adv_bt = puff_advantage(
            traj.value.T, rewards_c.T, traj.done.T,
            jnp.ones_like(traj.value.T),
            adv_cfg.gamma, adv_cfg.gae_lambda,
            adv_cfg.vtrace_rho_clip, adv_cfg.vtrace_c_clip,
        )
        advantages = adv_bt.T  # [T, B]

        data = dict(
            obs=traj.obs, actions=traj.actions, logprob=traj.logprob,
            value=traj.value, reward=rewards_c, done=traj.done,
            advantages=advantages,
        )
        if traj.teacher_actions is not None:
            data["teacher_actions"] = traj.teacher_actions
        if traj.value_q is not None:
            data["value_q_old"] = traj.value_q
        if ls.grpo.enabled:
            grpo_adv = L.compute_grpo_advantages(
                rewards_c.T, traj.done.T, ls.grpo.gamma, ls.grpo.group_size)
            data["grpo_advantages"] = grpo_adv.T

        rows_mb = self.rows_per_mb
        n_mb = self.n_minibatches
        target_kl = ls.ppo_actor.target_kl
        sampling = cfg.sampling
        prioritized = (sampling.method == "prioritized"
                       and sampling.prio_alpha > 0.0)
        if prioritized:
            # prioritized replay over rollout rows
            # (experience.py:233-269): p(b) ∝ (Σ_t |A_tb|)^α, IS weight
            # (B·p)^-β with β annealed toward 1 over the run
            adv_mag = jnp.sum(jnp.abs(advantages), axis=0)       # [B]
            pw = jnp.nan_to_num(adv_mag ** sampling.prio_alpha, nan=0.0,
                                posinf=0.0, neginf=0.0)
            prio_probs = (pw + 1e-6) / (jnp.sum(pw) + 1e-6)
            total_epochs = max(1, cfg.total_timesteps // max(cfg.batch_size, 1))
            anneal_beta = (
                sampling.prio_beta0
                + (1.0 - sampling.prio_beta0) * sampling.prio_alpha
                * ts.update_idx.astype(jnp.float32) / total_epochs
            )
            prio_is_all = (B * prio_probs) ** (-anneal_beta)     # [B]

        def epoch_body(carry, e_i):
            params, aux_params, opt_state, aux_opt, key, msum, stop = carry
            key, k_perm = jax.random.split(key)
            perm = jax.random.permutation(k_perm, B)
            # autotuner masking: epochs past the runtime active count no-op
            stop = jnp.maximum(stop, (e_i >= active_epochs).astype(jnp.float32))

            def mb_body(i, c):
                params, aux_params, opt_state, aux_opt, msum, stop, key = c
                key, k_loss, k_prio = jax.random.split(key, 3)
                if prioritized:
                    rows = jax.random.choice(
                        k_prio, B, (rows_mb,), replace=False, p=prio_probs)
                else:
                    rows = jax.lax.dynamic_slice(perm, (i * rows_mb,), (rows_mb,))
                mb = {k: jnp.take(v, rows, axis=1) for k, v in data.items()}
                mb["rows"] = rows
                if prioritized:
                    mb["prio_weights"] = jnp.take(prio_is_all, rows)
                (loss, metrics), grads = jax.value_and_grad(
                    self._loss_fn, has_aux=True
                )((params, aux_params), mb, hp, ts.loss_state, k_loss, axis_name)
                g_params, g_aux = grads
                if axis_name is not None:
                    g_params = jax.lax.pmean(g_params, axis_name)
                    if g_aux is not None:
                        g_aux = jax.lax.pmean(g_aux, axis_name)
                    metrics = jax.tree.map(lambda m: jax.lax.pmean(m, axis_name), metrics)
                # KL early stop (reference training/core.py target_kl): once
                # the running-average KL exceeds the target, remaining
                # minibatch updates in this train phase are no-ops.
                do = 1.0 - stop
                updates, opt_state2 = self.tx.update(g_params, opt_state, params)
                updates = jax.tree.map(lambda u: u * do, updates)
                params = optax.apply_updates(params, updates)
                opt_state = jax.tree.map(
                    lambda old, new: jnp.where(stop > 0, old, new),
                    opt_state, opt_state2)
                if self.aux_modules:
                    aux_updates, aux_opt2 = self.aux_tx.update(g_aux, aux_opt, aux_params)
                    aux_updates = jax.tree.map(lambda u: u * do, aux_updates)
                    aux_params = optax.apply_updates(aux_params, aux_updates)
                    aux_opt = jax.tree.map(
                        lambda old, new: jnp.where(stop > 0, old, new),
                        aux_opt, aux_opt2)
                if target_kl is not None:
                    stop = jnp.where(metrics["approx_kl"] > target_kl, 1.0, stop)
                if cfg.grad_stats:
                    flat = jnp.concatenate([
                        jnp.ravel(x) for x in jax.tree.leaves(g_params)
                    ]).astype(jnp.float32)
                    metrics = dict(metrics)
                    metrics["grad/mean"] = jnp.mean(flat)
                    metrics["grad/variance"] = jnp.var(flat)
                    metrics["grad/norm"] = jnp.linalg.norm(flat)
                msum = jax.tree.map(jnp.add, msum, metrics)
                return params, aux_params, opt_state, aux_opt, msum, stop, key

            params, aux_params, opt_state, aux_opt, msum, stop, key = jax.lax.fori_loop(
                0, n_mb, mb_body,
                (params, aux_params, opt_state, aux_opt, msum, stop, key)
            )
            return (params, aux_params, opt_state, aux_opt, key, msum, stop), None

        m0 = self._metric_template()
        (params, aux_params, opt_state, aux_opt, key, msum, stop), _ = jax.lax.scan(
            epoch_body,
            (ts.params, ts.aux_params, ts.opt_state, ts.aux_opt_state,
             ts.key, m0, jnp.float32(0.0)),
            jnp.arange(cfg.update_epochs),
        )
        n_updates = cfg.update_epochs * n_mb
        metrics = jax.tree.map(lambda m: m / n_updates, msum)
        metrics["reward_mean"] = jnp.mean(traj.reward)
        metrics["r_bar"] = ts.r_bar
        metrics["value_mean"] = jnp.mean(traj.value)
        if target_kl is not None:
            metrics["kl_early_stop"] = stop

        # non-trained loss state: EMA target / CMPO prior track the new params
        loss_state = ts.loss_state
        if ls.ema.enabled:
            d = ls.ema.ema_decay
            loss_state = dict(loss_state)
            loss_state["ema_target"] = jax.tree.map(
                lambda t, p: d * t + (1 - d) * p, loss_state["ema_target"], params)
        if ls.cmpo.enabled:
            d = ls.cmpo.prior_ema_decay
            loss_state = dict(loss_state)
            loss_state["cmpo_prior"] = jax.tree.map(
                lambda t, p: d * t + (1 - d) * p, loss_state["cmpo_prior"], params)

        ts = ts.replace(params=params, opt_state=opt_state, key=key,
                        aux_params=aux_params, aux_opt_state=aux_opt,
                        loss_state=loss_state,
                        update_idx=ts.update_idx + 1)
        return ts, metrics

    # ------------------------------------------------------------------

    def train(
        self,
        total_timesteps: Optional[int] = None,
        ts: Optional[TrainState] = None,
        log_fn: Optional[Callable] = None,
    ):
        total = total_timesteps or self.cfg.total_timesteps
        if ts is None:
            ts = self.init_state()
        steps_per_update = self.B * self.T
        t0 = time.time()
        from metta_tpu.rl.scheduler import LossScheduler, SchedulerConfig
        scheduler = LossScheduler(
            getattr(self.cfg, "scheduler", None) or SchedulerConfig(),
            dict(zip(HP_FIELDS, self.default_hp())),
        )
        n_update = 0
        tuner = None
        if self.cfg.autotuner is not None and self.cfg.autotuner.enabled:
            from metta_tpu.rl.autotuner import UpdateEpochAutoTuner
            tuner = UpdateEpochAutoTuner(self.cfg.autotuner,
                                         self.cfg.update_epochs)
        prof = self.cfg.profiler
        while self.agent_steps < total:
            self._maybe_advance_checkpointed_teacher(n_update)
            active = tuner.current if tuner is not None else None
            profile_now = (
                prof is not None and prof.enabled
                and n_update >= prof.first_update
                and (n_update - prof.first_update) % prof.interval_updates == 0
            )
            if profile_now:
                import os
                os.makedirs(prof.logdir, exist_ok=True)
                try:
                    with jax.profiler.trace(prof.logdir):
                        ts, metrics = self.update(
                            ts, scheduler.hp_vector(n_update), active)
                        jax.block_until_ready(metrics)
                except Exception:  # profiling must never kill training
                    ts, metrics = self.update(
                        ts, scheduler.hp_vector(n_update), active)
            else:
                ts, metrics = self.update(ts, scheduler.hp_vector(n_update), active)
            if tuner is not None:
                tuner.observe(n_update,
                              float(metrics["approx_kl"]),
                              float(metrics["clipfrac"]))
            n_update += 1
            self.agent_steps += steps_per_update
            if log_fn is not None:
                m = {k: float(v) for k, v in metrics.items()}
                m["agent_steps"] = self.agent_steps
                m["sps"] = self.agent_steps / max(time.time() - t0, 1e-9)
                log_fn(m)
        return ts

    def _maybe_advance_checkpointed_teacher(self, n_update: int):
        """sl_checkpointed_kickstarter: walk the teacher through a run's
        checkpoint history (reference loss/sl_checkpointed_kickstarter.py)."""
        sl = self.cfg.losses.sl_checkpointed_kickstarter
        if not (sl.enabled and sl.run_dir):
            return
        if n_update % sl.epochs_per_checkpoint != 0:
            return
        import os

        ckpt_dir = os.path.join(sl.run_dir, "checkpoints")
        if not os.path.isdir(ckpt_dir):
            return
        bundles = sorted(
            d for d in os.listdir(ckpt_dir)
            if os.path.isdir(os.path.join(ckpt_dir, d)))
        if not bundles:
            return
        idx = min(n_update // sl.epochs_per_checkpoint, len(bundles) - 1)
        uri = os.path.join(ckpt_dir, bundles[idx])
        if getattr(self, "_sl_teacher_uri", None) == uri:
            return
        self._sl_teacher_uri = uri
        self._load_teacher(uri)
