"""TrainTool: the end-to-end training entry point.

Parity: reference ``metta/tools/train.py:65-482`` — composes the env (or a
curriculum over envs), policy, trainer, checkpointer, evaluator, and progress
logging. The reference's component callbacks (Checkpointer every 30 epochs,
Evaluator every 100, ProgressLogger SPS lines, Heartbeat) are in-lined into
the update loop here — one update = one train batch (rollout+PPO).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Optional

from pydantic import Field

from metta_tpu.config.base import Config
from metta_tpu.config.mettagrid_config import MettaGridConfig
from metta_tpu.models.vit import ViTConfig
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.tools.tool import Tool

logger = logging.getLogger(__name__)


class PolicyConfig(Config):
    """Pydantic view of ViTConfig (policies/vit.py parity)."""

    name: str = "vit"
    latent_dim: int = 128
    actor_hidden: int = 256
    critic_hidden: int = 512
    core_num_heads: int = 4
    max_tokens: int = 128
    core_num_latents: int = 12
    token_embed_dim: int = 8
    fourier_freqs: int = 3
    # recurrent core: the reference default "Ag,A,S" Column stack, or "lstm"
    # (lighter core), or any cortex pattern string (models/cells.py).
    core: str = "Ag,A,S"
    core_layers: int = 2

    def to_arch(self) -> ViTConfig:
        return ViTConfig(
            latent_dim=self.latent_dim, actor_hidden=self.actor_hidden,
            critic_hidden=self.critic_hidden, core_num_heads=self.core_num_heads,
            max_tokens=self.max_tokens, core_num_latents=self.core_num_latents,
            token_embed_dim=self.token_embed_dim, fourier_freqs=self.fourier_freqs,
            core=self.core, core_layers=self.core_layers,
            name=self.name,
        )


class TrainTool(Tool):
    run: str = "local"
    data_dir: str = "./train_dir"
    env: Optional[MettaGridConfig] = None
    trainer: TrainerConfig = Field(default_factory=TrainerConfig)
    policy: PolicyConfig = Field(default_factory=PolicyConfig)
    total_timesteps: Optional[int] = None
    checkpoint_interval: int = 30      # updates between policy bundles
    evaluate_interval: int = 0         # updates between local evals (0=off)
    curriculum_interval: int = 50      # updates between curriculum task swaps
    eval_episodes: int = 4
    log_interval: int = 1
    heartbeat_file: Optional[str] = None
    # failure/abort controls (parity: rl/training/wandb_aborter.py — abort
    # signal polled between updates — plus a wall-clock watchdog)
    abort_file: Optional[str] = None   # training stops cleanly if this exists
    abort_check_interval: int = 5      # updates between abort-file polls
    max_runtime_hrs: float = 0.0       # 0 = unlimited

    # populated programmatically by recipes (not via CLI)
    _curriculum: Any = None
    _simulations: Any = None

    def with_curriculum(self, curriculum) -> "TrainTool":
        object.__setattr__(self, "_curriculum", curriculum)
        return self

    def with_simulations(self, sims) -> "TrainTool":
        object.__setattr__(self, "_simulations", sims)
        return self

    def invoke(self) -> int:
        import numpy as np

        from metta_tpu.policy.policy import NetworkPolicy
        from metta_tpu.rl.checkpoint import CheckpointManager
        from metta_tpu.rl.trainer import Trainer
        from metta_tpu.sim.runner import run_simulations

        cm = CheckpointManager(self.run, self.data_dir)
        total = self.total_timesteps or self.trainer.total_timesteps

        curriculum = self._curriculum
        arch = self.policy.to_arch()
        task = None
        mt_tasks = None
        if curriculum is not None:
            # Per-env per-episode curriculum (reference CurriculumEnv parity):
            # the whole active pool becomes a task set sampled on-device;
            # weight updates / slot eviction are runtime data (no recompiles).
            mt_tasks = curriculum.active_tasks()
            try:
                trainer = Trainer(
                    None, self.trainer, arch,
                    task_cfgs=[t.get_env_cfg() for t in mt_tasks],
                )
                trainer.env.set_weights(
                    curriculum.task_weights([t.task_id for t in mt_tasks])
                )
            except ValueError:
                # heterogeneous shape classes: fall back to whole-batch swaps
                mt_tasks = None
                task = curriculum.get_task()
                trainer = Trainer(task.get_env_cfg(), self.trainer, arch)
        else:
            env_cfg = self.env
            if env_cfg is None:
                raise SystemExit("TrainTool needs env= or a curriculum")
            trainer = Trainer(env_cfg, self.trainer, arch)
        ts = trainer.init_state()
        restored, meta = cm.load_trainer_state(ts)
        update_idx = 0
        agent_steps = 0
        if restored is not None:
            ts = restored
            update_idx = meta.get("epoch", 0)
            agent_steps = meta.get("extras", {}).get("agent_steps", 0)
            logger.info("resumed from update %d", update_idx)

        steps_per_update = trainer.B * trainer.T
        t0 = time.time()
        last_log_steps = agent_steps
        last_log_t = t0

        from metta_tpu.utils.logging import MetricsLogger

        mlog = MetricsLogger(run_dir=os.path.join(self.data_dir, self.run),
                             run_name=self.run)
        res_names = list(trainer.env.compiled.resource_names)

        while agent_steps < total:
            if self.abort_file and self.abort_check_interval and \
                    update_idx % self.abort_check_interval == 0 and \
                    os.path.exists(self.abort_file):
                logger.warning("abort file %s present — stopping cleanly",
                               self.abort_file)
                break
            if self.max_runtime_hrs and (time.time() - t0) > self.max_runtime_hrs * 3600:
                logger.warning("max_runtime_hrs %.2f reached — stopping cleanly",
                               self.max_runtime_hrs)
                break
            ts, metrics = trainer.update(ts)
            update_idx += 1
            agent_steps += steps_per_update

            if self.log_interval and update_idx % self.log_interval == 0:
                now = time.time()
                sps = (agent_steps - last_log_steps) / max(now - last_log_t, 1e-9)
                last_log_steps, last_log_t = agent_steps, now
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(
                    "update %d  steps %d  overview/sps %.0f  reward %.4f  pg %.4f  vf %.4f  ent %.3f",
                    update_idx, agent_steps, sps, m.get("reward_mean", 0),
                    m.get("policy_loss", 0), m.get("value_loss", 0), m.get("entropy", 0),
                )
                payload = {
                    "agent_step": agent_steps,
                    "overview/sps": sps,
                    "overview/reward": m.get("reward_mean", 0.0),
                    **{f"losses/{k}": v for k, v in m.items()},
                }
                if self.trainer.track_env_stats:
                    # per-episode env stat gate inputs (reference namespace
                    # env_agent/<resource>.gained — acceptance criteria in
                    # devops/stable.py read these). Averaged over episodes
                    # finished SINCE THE LAST LOG LINE: last_episode_gained
                    # is sticky per env, and with long episodes most envs'
                    # "last" episode is the desync-truncated first one from
                    # early training — averaging the sticky values buries
                    # every later improvement under stale zeros (the
                    # reference logs each finished episode as it completes).
                    vst = ts.vstate
                    eps_done = getattr(vst, "episodes_done", None)
                    if eps_done is not None:
                        eps_done = np.asarray(eps_done)
                        prev = getattr(self, "_eps_done_prev", None)
                        fresh = (eps_done > prev) if prev is not None else (
                            eps_done > 0)
                        self._eps_done_prev = eps_done
                        done_mask = fresh
                    else:
                        done_mask = np.asarray(vst.episode_len) > 0
                    if done_mask.any():
                        gained = np.asarray(vst.last_episode_gained)[done_mask]
                        for ri, rn in enumerate(res_names):
                            payload[f"env_agent/{rn}.gained"] = float(
                                gained[:, ri].mean())
                mlog.log(payload, step=agent_steps)

            if self.heartbeat_file:
                # parity: common/util/heartbeat.py record_heartbeat
                try:
                    with open(self.heartbeat_file, "w") as f:
                        f.write(str(time.time()))
                except OSError:
                    pass

            if self.checkpoint_interval and update_idx % self.checkpoint_interval == 0:
                cm.save_policy(ts.params, arch, epoch=update_idx)
                cm.save_trainer_state(ts, update_idx, extras={"agent_steps": agent_steps})

            if mt_tasks is not None:
                # per-task scoring from the envs' last finished episodes
                # (mean per-step reward, as the reference scores completions)
                vst = ts.vstate
                ep_len = np.asarray(vst.episode_len)
                ep_task = np.asarray(vst.last_episode_task)
                ep_rew = np.asarray(vst.last_episode_reward).mean(axis=1)
                for k, t in enumerate(mt_tasks):
                    m = (ep_task == k) & (ep_len > 0)
                    if m.any():
                        score = float((ep_rew[m] / np.maximum(ep_len[m], 1)).mean())
                        curriculum.update_task_performance(t.task_id, score)
                if self.curriculum_interval and update_idx % self.curriculum_interval == 0:
                    # sync evicted slots + refresh sampling weights — all
                    # data-only (Tables pytree), zero recompiles
                    live = {t.task_id: t for t in curriculum.active_tasks()}
                    in_slots = {t.task_id for t in mt_tasks}
                    fresh_pool = [t for tid, t in live.items() if tid not in in_slots]
                    for k, t in enumerate(mt_tasks):
                        if t.task_id not in live and fresh_pool:
                            new_t = fresh_pool.pop()
                            try:
                                trainer.env.set_task(k, new_t.get_env_cfg())
                                mt_tasks[k] = new_t
                            except ValueError:
                                logger.warning(
                                    "curriculum task %d not shape-compatible; keeping slot",
                                    new_t.task_id,
                                )
                    trainer.env.set_weights(
                        curriculum.task_weights([t.task_id for t in mt_tasks])
                    )
            elif task is not None:
                # fallback path: whole-batch task, swapped at update granularity
                curriculum.update_task_performance(
                    task.task_id, float(metrics["reward_mean"])
                )
                if self.curriculum_interval and update_idx % self.curriculum_interval == 0:
                    new_task = curriculum.get_task()
                    if new_task.task_id != task.task_id:
                        task = new_task
                        trainer = Trainer(task.get_env_cfg(), self.trainer, arch)
                        fresh = trainer.init_state()
                        ts = fresh.replace(params=ts.params, opt_state=ts.opt_state,
                                           r_bar=ts.r_bar, update_idx=ts.update_idx)

            if self.evaluate_interval and update_idx % self.evaluate_interval == 0 \
                    and self._simulations:
                uri = cm.save_policy(ts.params, arch, epoch=update_idx)
                from metta_tpu.engine.env import MettaGridEnv

                eval_env = MettaGridEnv(self._simulations[0].env, num_envs=1)
                pol = NetworkPolicy.from_bundle(uri, eval_env, n_slots=1)
                results = run_simulations([pol], self._simulations, seed=update_idx)
                for r in results:
                    logger.info("eval %s: mean_reward %.4f", r.key, r.mean_reward)

        cm.save_policy(ts.params, arch, epoch=update_idx)
        cm.save_trainer_state(ts, update_idx, extras={"agent_steps": agent_steps})
        mlog.close()
        logger.info("done: %d agent steps in %.1fs", agent_steps, time.time() - t0)
        return 0
