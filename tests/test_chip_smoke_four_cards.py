"""chip_smoke.py --four-cards's phase on four virtual CPU devices, at a tiny
width (the card runs it on four H100s: ``python chip_smoke.py --four-cards``)."""

import chip_smoke as S
from metta_tpu.models.vit import ViTConfig

TINY_VIT = ViTConfig(latent_dim=16, actor_hidden=16, critic_hidden=16,
                     core_num_latents=2, core_num_heads=2)


def test_phase_four_cards_tiny():
    out = S.phase_four_cards(per_card_envs=1, updates=2, policy_cfg=TINY_VIT,
                             trainer_overrides=dict(bptt_horizon=8, minibatch_size=96))
    assert out["four"]["num_envs"] == 4 and out["one"]["num_envs"] == 1
