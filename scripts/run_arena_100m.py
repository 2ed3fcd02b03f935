"""Run the arena_100m stable job with the reference-default Ag,A,S core.

Usage: python scripts/run_arena_100m.py [--seed 0] [--out train_dir/...]
Writes RESULTS_arena_100m.json + metrics.jsonl into the run dir.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--data-dir", type=str, default="/tmp/stable_r4")
    ap.add_argument("--chunks", type=int, default=1)
    args = ap.parse_args()

    from metta_tpu.devops.stable import STABLE_JOBS, evaluate_acceptance

    job = STABLE_JOBS["arena_100m"]
    tool = job.make_tool()
    tool.trainer.seed = args.seed
    if args.chunks > 1:
        tool.trainer.rollout_chunks = args.chunks
    print(f"arena_100m seed={args.seed} core={tool.policy.core}", flush=True)
    object.__setattr__(tool, "data_dir", args.data_dir)
    rc = tool.invoke()
    run_dir = Path(args.data_dir) / tool.run
    result = evaluate_acceptance(job, run_dir)
    result["exit_code"] = rc
    result["seed"] = args.seed
    result["policy_core"] = tool.policy.core
    out = Path(args.out or f"train_dir/stable_100m_r4_s{args.seed}")
    out.mkdir(parents=True, exist_ok=True)
    (out / "RESULTS_arena_100m.json").write_text(json.dumps(result, indent=2))
    for f in ("metrics.jsonl",):
        src = run_dir / f
        if src.exists():
            shutil.copy(src, out / f)
    print(json.dumps(result, indent=2), flush=True)


if __name__ == "__main__":
    main()
