"""Failure detection / recovery: abort controls + resume after SIGKILL.

Parity: reference WandbAborter (abort signal polled between updates,
rl/training/wandb_aborter.py), heartbeat liveness, and checkpoint-based
crash recovery (the stable-job restart path).
"""

import os
import signal
import subprocess
import sys
import time

from metta_tpu.builder.envs import make_navigation
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.tools.train import PolicyConfig, TrainTool

TINY = dict(
    trainer=TrainerConfig(num_envs=2, bptt_horizon=8, batch_size=128,
                          minibatch_size=32, total_timesteps=10_000_000),
    policy=PolicyConfig(latent_dim=16, actor_hidden=16, critic_hidden=16,
                        max_tokens=16, core_num_latents=2, core_num_heads=2),
)


def test_abort_file_stops_training(tmp_path):
    abort = tmp_path / "ABORT"
    abort.write_text("stop")
    tool = TrainTool(
        run="aborttest", data_dir=str(tmp_path),
        env=make_navigation(num_agents=2, width=10, height=10),
        total_timesteps=10_000_000, abort_file=str(abort),
        checkpoint_interval=0, log_interval=0, **TINY,
    )
    t0 = time.time()
    assert tool.invoke() == 0
    assert time.time() - t0 < 300  # stopped at the poll, not after 10M steps


def test_max_runtime_watchdog(tmp_path):
    tool = TrainTool(
        run="watchdog", data_dir=str(tmp_path),
        env=make_navigation(num_agents=2, width=10, height=10),
        total_timesteps=10_000_000, max_runtime_hrs=1e-9,
        checkpoint_interval=0, log_interval=0, **TINY,
    )
    assert tool.invoke() == 0


WORKER = r"""
import logging
logging.basicConfig(level=logging.INFO)
import jax
jax.config.update("jax_platforms", "cpu")
from metta_tpu.builder.envs import make_navigation
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.tools.train import PolicyConfig, TrainTool

tool = TrainTool(
    run="killtest", data_dir={data_dir!r},
    env=make_navigation(num_agents=2, width=10, height=10),
    total_timesteps={total},
    checkpoint_interval=1, log_interval=1,
    trainer=TrainerConfig(num_envs=2, bptt_horizon=8, batch_size=128,
                          minibatch_size=32),
    policy=PolicyConfig(latent_dim=16, actor_hidden=16, critic_hidden=16,
                        max_tokens=16, core_num_latents=2, core_num_heads=2),
)
raise SystemExit(tool.invoke())
"""


def test_resume_after_sigkill(tmp_path):
    """Kill training mid-run; a restart must resume from the checkpoint."""
    data_dir = str(tmp_path)
    ckpt_dir = tmp_path / "killtest" / "checkpoints"
    env = {**os.environ, "PYTHONPATH": os.getcwd(),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}

    p = subprocess.Popen(
        [sys.executable, "-c", WORKER.format(data_dir=data_dir, total=10_000_000)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 420
        while time.time() < deadline:
            if (ckpt_dir / "trainer_state.npz").exists():
                break
            if p.poll() is not None:
                raise AssertionError("worker exited before first checkpoint")
            time.sleep(1)
        else:
            raise AssertionError("no checkpoint within 420s")
        time.sleep(1)  # let at least one full checkpoint write land
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()

    # restart with a small remaining budget; must resume, not restart
    out = subprocess.run(
        [sys.executable, "-c", WORKER.format(data_dir=data_dir, total=512)],
        env=env, capture_output=True, text=True, timeout=420,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from update" in (out.stderr + out.stdout)
