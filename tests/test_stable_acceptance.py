"""Stable-job acceptance registry.

Covers: criterion evaluation semantics (tail-window mean, operators, missing
metrics), registry thresholds matching the reference bars, and an end-to-end
micro-run proving the trainer actually EMITS the gated metrics
(``overview/sps`` + ``env_agent/heart.gained``) into metrics.jsonl with
``track_env_stats`` on."""

import json

import pytest

from metta_tpu.devops.stable import (
    STABLE_JOBS,
    AcceptanceCriterion,
    StableJob,
    evaluate_acceptance,
    read_metrics,
)


def test_criterion_tail_window_mean():
    c = AcceptanceCriterion(metric="m", threshold=5.0, operator=">=", window=2)
    recs = [{"m": 0.0}, {"m": 4.0}, {"m": 8.0}]
    ok, v = c.evaluate(recs)
    assert ok and v == 6.0
    ok, v = c.evaluate([{"m": 0.0}, {"m": 4.0}])
    assert not ok and v == 2.0


def test_criterion_missing_metric_fails():
    c = AcceptanceCriterion(metric="absent", threshold=0.0)
    ok, v = c.evaluate([{"m": 1.0}])
    assert not ok and v is None


def test_registry_matches_reference_bars():
    j = STABLE_JOBS["arena_100m"]
    gates = {c.metric: (c.operator, c.threshold) for c in j.acceptance}
    assert gates["overview/sps"] == (">=", 23000)
    assert gates["env_agent/heart.gained"] == (">", 0.1)
    j2 = STABLE_JOBS["arena_2b"]
    gates2 = {c.metric: (c.operator, c.threshold) for c in j2.acceptance}
    assert gates2["overview/sps"] == (">=", 80000)
    assert gates2["env_agent/heart.gained"] == (">", 1.0)


def test_evaluate_acceptance_roundtrip(tmp_path):
    (tmp_path / "metrics.jsonl").write_text(
        "\n".join(json.dumps({"overview/sps": 30000 + i,
                              "env_agent/heart.gained": 0.3}) for i in range(5))
    )
    job = STABLE_JOBS["arena_100m"]
    res = evaluate_acceptance(job, tmp_path)
    assert res["passed"]
    assert all(c["passed"] for c in res["criteria"])
    assert res["n_records"] == 5


def test_trainer_emits_gated_metrics(tmp_path):
    """A micro training run with track_env_stats writes overview/sps AND
    env_agent/heart.gained records the acceptance gates can read."""
    from metta_tpu.config.mettagrid_config import (
        ActionsConfig, AgentConfig, AgentRewards, MoveActionConfig,
        NoopActionConfig,
    )
    from metta_tpu.rl.config import TrainerConfig
    from metta_tpu.testing import make_test_config
    from metta_tpu.tools.train import TrainTool

    cfg = make_test_config(
        """
######
#0.1.#
#....#
######
""",
        max_steps=8,
        actions=ActionsConfig(move=MoveActionConfig(), noop=NoopActionConfig()),
        agent=AgentConfig(rewards=AgentRewards(inventory={"heart": 1})),
        resource_names=["heart"],
    )
    tool = TrainTool(
        run="acc_micro", data_dir=str(tmp_path), env=cfg,
        checkpoint_interval=1000, log_interval=1,
        trainer=TrainerConfig(
            total_timesteps=2 * 2 * 8 * 4, batch_size=2 * 2 * 8,
            minibatch_size=2 * 2 * 8, bptt_horizon=8, num_envs=2,
            update_epochs=1, track_env_stats=True,
        ),
    )
    tool.policy.latent_dim = 16
    tool.policy.actor_hidden = 16
    tool.policy.critic_hidden = 16
    tool.policy.max_tokens = 16
    tool.policy.core_num_latents = 2
    tool.policy.core_num_heads = 2
    assert tool.invoke() == 0
    recs = read_metrics(tmp_path / "acc_micro")
    assert recs, "no metrics.jsonl records"
    assert any("overview/sps" in r for r in recs)
    assert any("env_agent/heart.gained" in r for r in recs), (
        "episodes ended (max_steps=8) but no gained metric was logged"
    )
