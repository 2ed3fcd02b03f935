"""Measure learner throughput with the sequence-mode policy forward vs the
per-step scan: arena-scale update on one chip, cores
"lstm" / "Ag,A,S" / "M" (mLSTM via the chunkwise kernel).

Usage: python scripts/bench_train_seq.py [--num-envs 1024] [--updates 6]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from metta_tpu.builder.envs import make_combat
from metta_tpu.models.vit import ViTConfig, ViTPolicy
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.rl.trainer import Trainer


def bench(core, seq, args):
    ViTPolicy.supports_sequence = seq
    cfg = make_combat(num_agents=24)
    cfg.game.map_builder.seed = 1234
    E = args.num_envs
    T = args.bptt
    tcfg = TrainerConfig(
        batch_size=E * 24 * T, minibatch_size=E * 24 * T // 4,
        bptt_horizon=T, num_envs=E, update_epochs=1,
    )
    pcfg = ViTConfig(core=core)
    tr = Trainer(cfg, tcfg, pcfg)
    ts = tr.init_state(seed=0)
    ts, _ = tr.update(ts)          # compile + warm
    jax.block_until_ready(ts.params)
    trials = []
    for _ in range(3):
        t0 = time.time()
        for _ in range(args.updates):
            ts, _ = tr.update(ts)
        jax.block_until_ready(ts.params)
        trials.append((time.time() - t0) / args.updates)
    dt = min(trials)
    sps = E * 24 * T / dt
    mode = "seq " if seq else "scan"
    print(f"core={core:8s} {mode}  {dt*1e3:9.1f} ms/update  {sps:12.0f} agent-sps")
    return sps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=512)
    ap.add_argument("--bptt", type=int, default=16)
    ap.add_argument("--updates", type=int, default=3)
    ap.add_argument("--cores", type=str, default="M")
    args = ap.parse_args()
    for core in args.cores.split(";"):
        s0 = bench(core, False, args)
        s1 = bench(core, True, args)
        print(f"  -> core={core}: sequence-mode speedup {s1 / s0:.2f}x")


if __name__ == "__main__":
    main()
