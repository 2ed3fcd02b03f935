"""chip_smoke.py's phases at tiny sizes on the CPU (the card runs them at
full size: ``python chip_smoke.py``)."""

import json

import jax

import chip_smoke as S
from metta_tpu.models.vit import ViTConfig

TINY_VIT = ViTConfig(latent_dim=16, actor_hidden=16, critic_hidden=16,
                     core_num_latents=2, core_num_heads=2)


def test_phase_sim_tiny():
    out = S.phase_sim(num_envs=8, steps=25, render_iters=2)
    assert out["env_steps_per_s"] > 0 and out["held"]
    assert out["render_E8"]["temp_gb"] >= 0 and out["render_E8"]["wall_ms_per_step"] > 0


def test_phase_differential_tiny():
    out = S.phase_differential(jax.devices("cpu")[0], num_envs=2, steps=4,
                               n_tasks=2, policy_cfg=TINY_VIT)
    assert out["MettaGridEnv"]["mismatches"] == []
    assert out["MultiTaskEnv"]["mismatches"] == []
    assert out["policy"]["logits"]["max_abs_f32"] == 0.0


def test_phase_train_tiny(tmp_path):
    out = S.phase_train(str(tmp_path), overrides=(
        "trainer.num_envs=2", "trainer.bptt_horizon=8", "trainer.batch_size=384",
        "trainer.minibatch_size=192", "policy.latent_dim=16", "policy.actor_hidden=16",
        "policy.critic_hidden=16", "policy.core_num_latents=2", "policy.core_num_heads=2"),
        updates=3)
    assert len(out["overview_sps"]) == 3 and out["bundle"].startswith("file://")


def test_probe_reports_optional_imports():
    found = S._sorted_imports()
    assert set(found) == set(S.OPTIONAL_PACKAGES)
    json.dumps(found)
