"""Run the arena_2b stable job (time-boxed legs with kill+resume support).

Each invocation is one LEG: it resumes from the data-dir's checkpoints if
present, runs until --max-minutes (clean stop via the max-runtime watchdog)
or until killed, then evaluates the acceptance criteria on the metrics
collected so far and writes RESULTS_arena_2b.json (partial results are
still recorded; "passed" only means both gates cleared on the tail window).

Usage: python scripts/run_arena_2b.py [--seed 0] [--max-minutes 20]
       [--data-dir /tmp/stable_2b] [--out train_dir/stable_2b]
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
    ap.add_argument("--max-minutes", type=float, default=20.0)
    ap.add_argument("--data-dir", type=str, default="/tmp/stable_2b")
    ap.add_argument("--out", type=str, default="train_dir/stable_2b")
    args = ap.parse_args()

    from metta_tpu.devops.stable import STABLE_JOBS, evaluate_acceptance

    job = STABLE_JOBS["arena_2b"]
    tool = job.make_tool()
    tool.trainer.seed = args.seed
    tool.max_runtime_hrs = args.max_minutes / 60.0
    tool.data_dir = args.data_dir
    print(f"arena_2b leg: seed={args.seed} box={args.max_minutes}min "
          f"core={tool.policy.core}", flush=True)
    rc = tool.invoke()
    run_dir = Path(args.data_dir) / tool.run
    result = evaluate_acceptance(job, run_dir)
    result["exit_code"] = rc
    result["seed"] = args.seed
    result["policy_core"] = tool.policy.core
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "RESULTS_arena_2b.json").write_text(json.dumps(result, indent=2))
    for f in ("metrics.jsonl",):
        src = run_dir / f
        if src.exists():
            shutil.copy(src, out / f)
    print(json.dumps(result, indent=2), flush=True)


if __name__ == "__main__":
    main()
