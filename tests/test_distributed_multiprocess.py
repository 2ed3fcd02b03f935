"""Real multi-process distributed evidence.

Two actual OS processes form a jax.distributed cluster over CPU (gloo
collectives), build a global 4-device mesh (2 local devices each), and run
the full sharded train step. This exercises the cross-process collective path
that single-process virtual-device tests cannot: the reference has no
equivalent test at all (SURVEY §4 "multi-node without a cluster: none" — its
DDP path is only exercised by cloud jobs).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    pid = int(sys.argv[1]); port = sys.argv[2]
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    assert len(jax.devices()) == 4

    import numpy as np
    from metta_tpu.config.mettagrid_config import AgentConfig, AgentRewards
    from metta_tpu.models.vit import ViTConfig
    from metta_tpu.parallel.distributed import DistributedTrainer, make_mesh
    from metta_tpu.rl.config import TrainerConfig
    from metta_tpu.testing import make_test_config

    env_cfg = make_test_config(
        "######\\n#0..1#\\n######",
        max_steps=8,
        agent=AgentConfig(rewards=AgentRewards(inventory={"heart": 1.0})),
    )
    tcfg = TrainerConfig(batch_size=4 * 2 * 4, minibatch_size=2 * 4,
                         bptt_horizon=4, num_envs=4, update_epochs=1)
    tcfg.losses.ppo_critic.critic_update = "mse"
    pcfg = ViTConfig(latent_dim=16, actor_hidden=8, critic_hidden=8,
                     max_tokens=16, core_num_latents=2, core_num_heads=2)
    tr = DistributedTrainer(env_cfg, tcfg, pcfg, mesh=make_mesh())
    ts = tr.init_state(seed=0)
    ts, metrics = tr.update(ts)
    pl = float(metrics["policy_loss"])
    assert np.isfinite(pl), pl
    # params are replicated: every process must see the identical tree
    psum = float(sum(abs(np.asarray(x)).sum() for x in jax.tree.leaves(ts.params)))
    print(f"RESULT pid={pid} policy_loss={pl:.6f} param_sum={psum:.6f}", flush=True)
""")


@pytest.mark.slow
def test_two_process_distributed_train(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), port],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    results = [line for rc, out, err in outs for line in out.splitlines()
               if line.startswith("RESULT")]
    assert len(results) == 2
    # both processes report the same replicated loss and params
    vals = [r.split("policy_loss=")[1] for r in results]
    assert vals[0] == vals[1], results
