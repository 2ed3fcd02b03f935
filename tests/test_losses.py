"""Loss-family tests (mirror of reference tests/rl/test_losses.py subset)."""

import jax
import numpy as np
import pytest

from metta_tpu.config.mettagrid_config import AgentConfig, AgentRewards
from metta_tpu.models.vit import ViTConfig
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.rl.trainer import Trainer
from metta_tpu.testing import make_test_config


def small_cfg():
    return make_test_config(
        """
######
#0..1#
######
""",
        max_steps=16,
        agent=AgentConfig(rewards=AgentRewards(inventory={"heart": 1.0})),
    )


def small_trainer(**loss_overrides):
    tcfg = TrainerConfig(batch_size=2 * 2 * 8, minibatch_size=2 * 8,
                         bptt_horizon=8, num_envs=2)
    tcfg.losses.ppo_critic.critic_update = "mse"
    for path, v in loss_overrides.items():
        tcfg.override(path, v)
    # core="lstm": these tests exercise the loss machinery, not the core;
    # the tanh-bounded LSTM keeps latent magnitudes small so saturating
    # losses (contrastive InfoNCE with the reference's unnormalized dot
    # products) stay in their responsive regime at init
    pcfg = ViTConfig(latent_dim=16, actor_hidden=16, critic_hidden=16,
                     max_tokens=16, core_num_latents=2, core_num_heads=2,
                     core="lstm")
    return Trainer(small_cfg(), tcfg, pcfg)


def test_kickstarter_changes_update():
    tr = small_trainer()
    ts = tr.init_state(seed=0)
    # teacher = a differently-initialized copy of the same architecture
    teacher_params = tr.policy.init(
        jax.random.PRNGKey(123),
        np.zeros((1, 16, 3), np.uint8),
        tr.policy.initial_state(1),
    )
    tr.cfg.losses.kickstarter.enabled = True
    tr.cfg.losses.kickstarter.action_loss_coef = 1.0
    tr.set_teacher(tr.policy, teacher_params)
    ts2, metrics = tr.update(ts)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k


def test_gtd_vs_mse_both_finite():
    for mode in ("mse", "gtd_lambda"):
        tr = small_trainer(**{"losses.ppo_critic.critic_update": mode})
        ts = tr.init_state(seed=0)
        ts, metrics = tr.update(ts)
        assert np.isfinite(float(metrics["value_loss"])), mode


def test_scheduler_rules_and_gates():
    from metta_tpu.rl.scheduler import (
        HP_FIELDS, HP_INDEX, LossRunGate, LossScheduler, ScheduleRule, SchedulerConfig,
    )

    base = {n: 1.0 for n in HP_FIELDS}
    sched = LossScheduler(
        SchedulerConfig(
            rules=[ScheduleRule(param="ppo_ent_coef", schedule="linear",
                                start_value=0.02, end_value=0.0,
                                start_update=0, end_update=100)],
            gates=[LossRunGate(param="kickstarter_coef", start_update=0, end_update=10)],
        ),
        base,
    )
    hp0 = sched.hp_vector(0)
    hp50 = sched.hp_vector(50)
    hp200 = sched.hp_vector(200)
    i = HP_INDEX["ppo_ent_coef"]
    assert abs(hp0[i] - 0.02) < 1e-9
    assert abs(hp50[i] - 0.01) < 1e-9
    assert hp200[i] == 0.0
    k = HP_INDEX["kickstarter_coef"]
    assert hp0[k] == 1.0 and hp50[k] == 0.0


def test_scheduled_coefs_change_update():
    import jax.numpy as jnp

    tr = small_trainer()
    ts = tr.init_state(seed=0)
    hp = tr.default_hp()
    ts1, m1 = tr.update(ts, hp)
    # zero entropy coef → different loss surfaces, same program (no recompile)
    from metta_tpu.rl.scheduler import HP_INDEX

    hp2 = list(hp)
    hp2[HP_INDEX["ppo_ent_coef"]] = 0.0
    ts2, m2 = tr.update(ts1, hp2)
    assert np.isfinite(float(m2["policy_loss"]))


# --- every auxiliary loss family changes the update ---

LOSS_CASES = [
    # (name, config overrides, hp coefficient name, needs teacher)
    ("grpo", {"losses.grpo.enabled": True}, "grpo_coef", False),
    ("quantile", {"losses.quantile_ppo_critic.enabled": True}, "quantile_vf_coef", False),
    ("contrastive", {"losses.contrastive.enabled": True}, "contrastive_coef", False),
    ("stable_latent", {"losses.stable_latent.enabled": True}, "stable_latent_coef", False),
    ("future_latent_ema", {"losses.future_latent_ema.enabled": True}, "future_latent_coef", False),
    ("vit_reconstruction", {"losses.vit_reconstruction.enabled": True}, "vit_recon_coef", False),
    # ema's gradient is zero while target==online (they start equal), so give
    # it a real lr and 2 epochs so the target/online gap opens within the test
    ("ema", {"losses.ema.enabled": True, "optimizer.type": "adam",
             "optimizer.learning_rate": 0.05, "update_epochs": 2}, "ema_coef", False),
    ("cmpo", {"losses.cmpo.enabled": True,
              "losses.cmpo.world_model.hidden_dim": 32,
              "losses.cmpo.world_model.ensemble_size": 2}, "cmpo_coef", False),
    ("logit_kickstarter", {"losses.logit_kickstarter.enabled": True}, "logit_kickstarter_coef", True),
    ("eer_kickstarter", {"losses.eer_kickstarter.enabled": True}, "eer_kickstarter_coef", True),
    ("eer_cloner", {"losses.eer_cloner.enabled": True}, "eer_cloner_coef", True),
    ("sliced_kickstarter", {"losses.sliced_kickstarter.enabled": True,
                            "losses.sliced_kickstarter.teacher_led_proportion": 0.5},
     "sliced_kickstarter_coef", True),
    ("sliced_scripted_cloner", {"losses.sliced_scripted_cloner.enabled": True},
     "scripted_cloner_coef", True),
]


def _param_delta(a, b):
    import jax

    return sum(
        float(np.abs(np.asarray(x) - np.asarray(y)).sum())
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.mark.parametrize("name,overrides,coef,needs_teacher", LOSS_CASES)
def test_loss_changes_update(name, overrides, coef, needs_teacher):
    """Same program, coefficient on vs off (runtime hp) → different params."""
    from metta_tpu.rl.scheduler import HP_INDEX

    tr = small_trainer(**overrides)
    if needs_teacher:
        teacher_params = tr.policy.init(
            jax.random.PRNGKey(123),
            np.zeros((1, 16, 3), np.uint8),
            tr.policy.initial_state(1),
        )
        tr.set_teacher(tr.policy, teacher_params)
    ts0 = tr.init_state(seed=0)
    hp_on = tr.default_hp()
    assert hp_on[HP_INDEX[coef]] > 0.0, f"{name}: coefficient not enabled"
    hp_off = list(hp_on)
    hp_off[HP_INDEX[coef]] = 0.0

    ts_on, m_on = tr.update(ts0, hp_on)
    # fresh state for the off run (same seed → same rollout data)
    ts1 = tr.init_state(seed=0)
    ts_off, m_off = tr.update(ts1, hp_off)
    for k, v in m_on.items():
        assert np.isfinite(float(v)), f"{name}: metric {k} not finite"
    delta = _param_delta(ts_on.params, ts_off.params)
    assert delta > 1e-7, f"{name}: loss coefficient had no effect on the update"


def test_kl_early_stop_masks_updates():
    """target_kl small enough to trip immediately → later minibatches no-op,
    so the param delta is smaller than without the stop."""
    tr = small_trainer(**{"losses.ppo_actor.target_kl": 1e-12,
                          "optimizer.type": "adam",
                          "optimizer.learning_rate": 0.05})
    ts0 = tr.init_state(seed=0)
    ts1, m = tr.update(ts0)
    assert float(m["kl_early_stop"]) == 1.0
    tr2 = small_trainer()
    ts0b = tr2.init_state(seed=0)
    ts1b, m2 = tr2.update(ts0b)
    assert "kl_early_stop" not in m2
