"""Trainer configuration.

Parity: reference ``metta/rl/trainer_config.py`` — hyperparameter names and
defaults match (LR/eps from the reference's sweep winners, PPO clip/entropy
from ``loss/ppo_actor.py:19-23`` and ``loss/ppo_critic.py:19-22``).
"""

from __future__ import annotations

from typing import Literal, Optional

from pydantic import Field

from metta_tpu.config.base import Config
from metta_tpu.rl.scheduler import SchedulerConfig


class OptimizerConfig(Config):
    type: Literal["adam", "adamw", "adamw_schedulefree", "sgd"] = "adamw_schedulefree"
    learning_rate: float = Field(default=0.00737503357231617, gt=0, le=1.0)
    beta1: float = Field(default=0.9, ge=0, le=1.0)
    beta2: float = Field(default=0.999, ge=0, le=1.0)
    eps: float = Field(default=5.0833278919526e-07, gt=0)
    weight_decay: float = Field(default=0.01, ge=0)
    warmup_steps: int = Field(default=1000, ge=0)


class RewardCenteringConfig(Config):
    enabled: bool = True
    beta: float = Field(default=1e-3, gt=0, le=1.0)
    initial_reward_mean: float = 0.0


class AdvantageConfig(Config):
    vtrace_rho_clip: float = Field(default=1.0, gt=0)
    vtrace_c_clip: float = Field(default=1.0, gt=0)
    reward_centering: RewardCenteringConfig = Field(default_factory=RewardCenteringConfig)
    gamma: float = Field(default=1.0, ge=0, le=1.0)
    gae_lambda: float = Field(default=0.95, ge=0, le=1.0)


class PPOActorConfig(Config):
    clip_coef: float = Field(default=0.22017136216163635, gt=0, le=1.0)
    ent_coef: float = Field(default=0.01, ge=0)
    norm_adv: bool = True
    target_kl: Optional[float] = None


class PPOCriticConfig(Config):
    vf_clip_coef: float = Field(default=0.1, ge=0)
    vf_coef: float = Field(default=0.49657103419303894, ge=0)
    clip_vloss: bool = True
    critic_update: Literal["mse", "gtd_lambda"] = "gtd_lambda"
    aux_coef: float = Field(default=1.0, ge=0)
    beta: float = Field(default=1.0, ge=0)
    # recurrent burn-in: exclude the first N steps of each BPTT segment from
    # the losses while the zero-init core warms up (loss/ppo_critic.py:56-91)
    burn_in_steps: int = Field(default=0, ge=0)


class KickstarterConfig(Config):
    """Teacher-policy distillation (parity: loss/kickstarter.py).

    Adds KL(teacher ‖ student) on minibatch observations, annealed linearly to
    zero over ``anneal_updates`` (0 = constant).
    """

    enabled: bool = False
    teacher_uri: Optional[str] = None
    action_loss_coef: float = Field(default=1.0, ge=0)
    value_loss_coef: float = Field(default=0.0, ge=0)
    anneal_updates: int = Field(default=0, ge=0)


class ActionSupervisedConfig(Config):
    """Behavior cloning on recorded teacher actions (parity: loss/action_supervised.py)."""

    enabled: bool = False
    coef: float = Field(default=1.0, ge=0)


class SlicedKickstarterConfig(Config):
    """Row-sliced distillation (parity: loss/sliced_kickstarter.py:20-39):
    the rollout batch is partitioned into teacher-led rows (teacher picks the
    executed action), student-led rows (student acts, distilled), and PPO rows
    (plain RL); the distillation KL/value terms run on the first two slices,
    PPO only on the third."""

    enabled: bool = False
    teacher_uri: Optional[str] = None
    action_loss_coef: float = Field(default=0.6, ge=0)
    value_loss_coef: float = Field(default=1.0, ge=0)
    temperature: float = Field(default=2.0, gt=0)
    student_led_proportion: float = Field(default=0.0, ge=0, le=1.0)
    teacher_led_proportion: float = Field(default=0.0, ge=0, le=1.0)


class LogitKickstarterConfig(Config):
    """Temperature-scaled logit distillation on all rows
    (parity: loss/logit_kickstarter.py)."""

    enabled: bool = False
    teacher_uri: Optional[str] = None
    action_loss_coef: float = Field(default=1.0, ge=0)
    value_loss_coef: float = Field(default=1.0, ge=0)
    temperature: float = Field(default=2.0, gt=0)


class SlicedScriptedClonerConfig(Config):
    """Behavior cloning of the executed teacher action on sliced rows
    (parity: loss/sliced_scripted_cloner.py)."""

    enabled: bool = False
    teacher_uri: Optional[str] = None
    action_loss_coef: float = Field(default=1.0, ge=0)
    student_led_proportion: float = Field(default=0.0, ge=0, le=1.0)
    teacher_led_proportion: float = Field(default=0.5, ge=0, le=1.0)


class SLCheckpointedKickstarterConfig(Config):
    """Kickstarter whose teacher advances through a run's checkpoint history
    (parity: loss/sl_checkpointed_kickstarter.py): every
    ``epochs_per_checkpoint`` updates the teacher is reloaded from the next
    checkpoint of ``run_dir``."""

    enabled: bool = False
    run_dir: Optional[str] = None
    epochs_per_checkpoint: int = Field(default=10, ge=1)
    action_loss_coef: float = Field(default=0.6, ge=0)
    value_loss_coef: float = Field(default=1.0, ge=0)
    temperature: float = Field(default=2.0, gt=0)


class EERKickstarterConfig(Config):
    """Expected-entropy-regularized distillation: cross-entropy of student
    probs against teacher log-probs (parity: loss/eer_kickstarter.py)."""

    enabled: bool = False
    teacher_uri: Optional[str] = None
    action_loss_coef: float = Field(default=1.0, ge=0)
    value_loss_coef: float = Field(default=1.0, ge=0)


class EERClonerConfig(Config):
    """-log π_student(a_teacher) cloning (parity: loss/eer_cloner.py)."""

    enabled: bool = False
    teacher_uri: Optional[str] = None
    action_loss_coef: float = Field(default=1.0, ge=0)


class EMAConfig(Config):
    """Self-distillation against an EMA copy of the policy
    (parity: loss/ema.py): MSE between the online policy's prediction head
    and the EMA target's."""

    enabled: bool = False
    loss_coef: float = Field(default=1.0, ge=0)
    ema_decay: float = Field(default=0.999, ge=0, le=1.0)


class CMPOWorldModelConfig(Config):
    ensemble_size: int = Field(default=5, ge=1)
    hidden_dim: int = Field(default=512, gt=0)
    learning_rate: float = Field(default=3e-4, gt=0)
    train_steps: int = Field(default=2, ge=1)


class CMPOConfig(Config):
    """Conservative Model-based Policy Optimization (parity: loss/cmpo.py:50):
    a world-model ensemble gives one-step lookahead Q values; the policy is
    distilled toward π_prior·exp(clip(Â/τ)) (Muesli eq. 7/9) with an EMA prior.

    JAX difference: the world model trains on the current rollout batch each
    update (``train_steps`` gradient steps) instead of a host-side 50k-item
    replay deque — the transition source is the same data, fresher."""

    enabled: bool = False
    temperature: float = Field(default=1.0, gt=0)
    adv_clip: float = Field(default=10.0, gt=0)
    norm_adv: bool = True
    ent_coef: float = Field(default=0.0, ge=0)
    vf_coef: float = Field(default=0.5, ge=0)
    coef: float = Field(default=1.0, ge=0)
    prior_ema_decay: float = Field(default=0.99, ge=0, le=1.0)
    world_model: CMPOWorldModelConfig = Field(default_factory=CMPOWorldModelConfig)


class GRPOConfig(Config):
    """Group Relative Policy Optimization (parity: loss/grpo.py:15): replaces
    GAE with group-mean-relative discounted returns; policy-gradient only."""

    enabled: bool = False
    clip_coef: float = Field(default=0.2, gt=0, le=1.0)
    ent_coef: float = Field(default=0.01, ge=0)
    gamma: float = Field(default=0.99, ge=0, le=1.0)
    group_size: int = Field(default=4, gt=1)
    norm_adv: bool = True
    coef: float = Field(default=1.0, ge=0)


class QuantilePPOCriticConfig(Config):
    """Quantile-regression critic (parity: loss/quantile_ppo_critic.py:17).
    Requires the policy's ``num_quantiles`` > 0 (value head outputs a quantile
    vector; the mean is used for advantages)."""

    enabled: bool = False
    vf_clip_coef: float = Field(default=0.1, ge=0)
    vf_coef: float = Field(default=0.49657103419303894, ge=0)
    clip_vloss: bool = True


class ContrastiveConfig(Config):
    """InfoNCE over (anchor, geometric-future-positive) core-latent pairs
    within episodes (parity: loss/contrastive.py:74-267)."""

    enabled: bool = False
    coef: float = Field(default=1.0, ge=0)
    temperature: float = Field(default=0.1, gt=0)
    discount: float = Field(default=0.95, ge=0, lt=1.0)
    embed_dim: int = Field(default=64, gt=0)


class StableLatentConfig(Config):
    """Penalize squared step-to-step core-latent deltas within episodes
    (parity: loss/stable_latent.py:80-120)."""

    enabled: bool = False
    loss_coef: float = Field(default=1.0, ge=0)


class FutureLatentEMAConfig(Config):
    """Predict the EMA of future core latents from the current step
    (parity: loss/future_latent_ema.py:48-100). Requires the policy's
    ``predict_future=True`` head."""

    enabled: bool = False
    loss_coef: float = Field(default=1.0, ge=0)
    ema_decay: float = Field(default=0.9, ge=0, lt=1.0)
    prediction_horizon: int = Field(default=4, ge=1)


class ViTReconstructionConfig(Config):
    """Reconstruct sparse token observations from the perceiver latent via a
    Fourier-queried cross-attention decoder (parity:
    loss/vit_reconstruction.py:47-300)."""

    enabled: bool = False
    id_loss_coef: float = Field(default=0.08, ge=0)
    val_loss_coef: float = Field(default=0.4, ge=0)
    decoder_embed_dim: int = Field(default=64, gt=0)
    decoder_num_heads: int = Field(default=4, ge=1)
    num_attribute_classes: int = Field(default=64, gt=0)


class LossesConfig(Config):
    """Loss registry (parity: loss/losses.py:33-120 — PPO actor+critic enabled
    by default; all 17 reference loss families are available, gated by their
    ``enabled`` flags with runtime-scheduled coefficients)."""

    ppo_actor: PPOActorConfig = Field(default_factory=PPOActorConfig)
    ppo_critic: PPOCriticConfig = Field(default_factory=PPOCriticConfig)
    kickstarter: KickstarterConfig = Field(default_factory=KickstarterConfig)
    action_supervised: ActionSupervisedConfig = Field(default_factory=ActionSupervisedConfig)
    sliced_kickstarter: SlicedKickstarterConfig = Field(default_factory=SlicedKickstarterConfig)
    logit_kickstarter: LogitKickstarterConfig = Field(default_factory=LogitKickstarterConfig)
    sliced_scripted_cloner: SlicedScriptedClonerConfig = Field(default_factory=SlicedScriptedClonerConfig)
    sl_checkpointed_kickstarter: SLCheckpointedKickstarterConfig = Field(
        default_factory=SLCheckpointedKickstarterConfig)
    eer_kickstarter: EERKickstarterConfig = Field(default_factory=EERKickstarterConfig)
    eer_cloner: EERClonerConfig = Field(default_factory=EERClonerConfig)
    ema: EMAConfig = Field(default_factory=EMAConfig)
    cmpo: CMPOConfig = Field(default_factory=CMPOConfig)
    grpo: GRPOConfig = Field(default_factory=GRPOConfig)
    quantile_ppo_critic: QuantilePPOCriticConfig = Field(default_factory=QuantilePPOCriticConfig)
    contrastive: ContrastiveConfig = Field(default_factory=ContrastiveConfig)
    stable_latent: StableLatentConfig = Field(default_factory=StableLatentConfig)
    future_latent_ema: FutureLatentEMAConfig = Field(default_factory=FutureLatentEMAConfig)
    vit_reconstruction: ViTReconstructionConfig = Field(default_factory=ViTReconstructionConfig)


class SamplingConfig(Config):
    """Minibatch sampling (reference ``training/experience.py:223-303``):
    sequential contiguous slices or prioritized-by-|advantage| replay with
    annealed importance-sampling correction."""

    method: str = "sequential"            # "sequential" | "prioritized"
    prio_alpha: float = Field(default=0.8, ge=0.0)
    prio_beta0: float = Field(default=0.6, ge=0.0, le=1.0)


class AutoTunerConfig(Config):
    """Online update-epochs tuner (reference
    ``training/update_epochs_tuner.py``): steps the number of *active* update
    epochs up when KL is well under target, down when KL/clipfrac overshoot.
    Enabled when evaluation_epochs > 0. The jitted update always runs
    ``update_epochs`` scan iterations; inactive epochs are masked at runtime,
    so tuning never recompiles."""

    min_update_epochs: int = Field(default=1, ge=1)
    max_update_epochs: int = Field(default=8, ge=1)
    step_size: int = Field(default=1, ge=1)
    evaluation_epochs: int = Field(default=0, ge=0)
    warmup_epochs: int = Field(default=2, ge=0)
    cooldown_epochs: int = Field(default=2, ge=0)
    target_kl: float = Field(default=0.015, ge=0.0)
    kl_tolerance: float = Field(default=0.3, ge=0.0)
    max_clipfrac: float = Field(default=0.3, ge=0.0, le=1.0)

    @property
    def enabled(self) -> bool:
        return self.evaluation_epochs > 0


class ProfilerConfig(Config):
    """Periodic jax.profiler traces (reference ``training/torch_profiler.py``
    equivalent): every ``interval_updates`` updates one full update is
    captured to ``logdir`` for xprof/Perfetto."""

    interval_updates: int = Field(default=0, ge=0)
    first_update: int = Field(default=3, ge=0)
    logdir: str = "/tmp/metta_tpu_profiles"

    @property
    def enabled(self) -> bool:
        return self.interval_updates > 0


class TrainerConfig(Config):
    total_timesteps: int = Field(default=10_000_000_000, gt=0)
    losses: LossesConfig = Field(default_factory=LossesConfig)
    optimizer: OptimizerConfig = Field(default_factory=OptimizerConfig)
    advantage: AdvantageConfig = Field(default_factory=AdvantageConfig)

    # Workload shape. batch_size = rollout_rows × bptt_horizon agent-steps per
    # update; minibatch_size divides it (reference defaults: 2,097,152 / 16,384
    # / 256 — trainer_config.py:88-90).
    batch_size: int = Field(default=2_097_152, gt=0)
    minibatch_size: int = Field(default=16384, gt=0)
    bptt_horizon: int = Field(default=256, gt=0)
    update_epochs: int = Field(default=1, gt=0)

    # env batch: number of vectorized env instances; rollout rows = num_envs ×
    # agents-per-env. When 0, derived from batch_size / bptt / num_agents.
    num_envs: int = Field(default=0, ge=0)

    max_grad_norm: float = Field(default=0.5, gt=0)
    seed: int = 0

    # track per-episode env stat accumulators (gained/lost/chest) in the
    # TRAINING envs — needed by acceptance gates on env_agent/* metrics
    # (devops/stable.py); off by default (costs two [E, A, R] accumulations
    # per sim phase)
    track_env_stats: bool = False

    # env step mode: "batched" (rank-arbitrated vectorized step, the perf
    # path) or "sequential" (reference-exact agent loop). See
    # engine/step_batched.py for the semantics notes.
    env_step_mode: str = "batched"

    # hyperparameter schedules + loss run gates (rl/scheduler.py)
    scheduler: Optional[SchedulerConfig] = None

    sampling: SamplingConfig = Field(default_factory=SamplingConfig)
    autotuner: Optional[AutoTunerConfig] = None
    profiler: Optional[ProfilerConfig] = None
    # gradient statistics (grad/mean, grad/variance, grad/norm) in metrics
    # (reference training/gradient_reporter.py)
    grad_stats: bool = False

    # Split each update into this many device programs (rollout chunks + a
    # separate learner program). 1 = fully fused.
    rollout_chunks: int = Field(default=1, ge=1)

    checkpoint_interval: int = Field(default=30, ge=0)
    evaluate_interval: int = Field(default=100, ge=0)
