#!/usr/bin/env python
"""Smoke run of the whole system on one GPU: the quickest proof that the
trainer and the simulator start on the card.

Phases, all in this one process. A phase that fails ends the run with a
non-zero exit and no result line.

1. probe: versions of jax, jaxlib and the CUDA plugin; JAX's devices; the
   card's name and power limit; which optional packages import.
2. sim: the combat simulator at E=4096, A=24 (``bench.py``'s program, a
   scan of 100 steps that consumes the observations): compile time,
   steps/s, ``compiled.memory_analysis()`` and the conversion-chain check.
   Then the device time of one sim step and of one observation render.
3. differential: the arena recipe's MettaGridEnv and MultiTaskEnv (E=8,
   64 steps) against the CPU backend of this process, and the default ViT
   against a CPU float32 forward.
4. train: ``tools/run.py recipes.arena_basic_easy_shaped.train`` through
   ``cli_entry`` at the recipe and trainer defaults, cut to one update:
   losses finite, a bundle written and reloaded through ``policy/policy.py``.
   The one update includes the update program's compilation, so its
   ``overview/sps`` is not a steady rate.

``--four-cards`` runs only the data-parallel trainer over four cards and,
to compare, over one card at the same per-card width (341 arena envs of 24
agents), two updates each. It runs the ViT with its LSTM core and a bptt of
64, not the default Column core at bptt 256: at the defaults one update
takes about 300 s on an H100 and its program about 140 s to compile, so two
updates on one card and two on four would hold four cards for about 25
minutes; with the LSTM core at bptt 64 an update takes about 40 s.

To rerun one phase by hand, call its function, as ``tests/test_chip_smoke.py``
does. The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--out DIR] [--four-cards]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.metadata
import json
import math
import shutil
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

OPTIONAL_PACKAGES = ("flax", "pydantic", "safetensors", "msgpack", "yaml",
                     "google.protobuf")
BF16_ULP_TOLERANCE = 8      # default bf16 ViT vs the CPU float32 forward
F32_ATOL = 1e-4             # float32 ViT at highest precision on both sides
ENGINE_RTOL = 1e-6          # float state fields (rewards): reduction order


def log(*args):
    print(*args, flush=True)


def _sorted_imports() -> dict:
    found = {}
    for name in OPTIONAL_PACKAGES:
        try:
            mod = importlib.import_module(name)
            found[name] = getattr(mod, "__version__", "present")
        except ImportError:
            found[name] = None
    return found


def phase_probe() -> dict:
    from metta_tpu.utils.device import gpu_name_and_power_limit

    versions = {}
    for dist in ("jax", "jaxlib", "jax-cuda12-plugin", "jax-cuda12-pjrt"):
        try:
            versions[dist] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            versions[dist] = None
    devices = [(d.platform, d.device_kind) for d in jax.devices()]
    info = {"versions": versions, "devices": devices,
            "gpu": gpu_name_and_power_limit(), "optional_imports": _sorted_imports()}
    for k, v in info.items():
        log(f"probe {k}: {v}")
    return info


def _render_program(env, iters: int):
    """``run(estate) -> obs byte sum`` of ``iters`` whole-batch renders; the
    executed actions change every iteration so no render is loop-invariant."""
    from metta_tpu.engine.obs import render_observations

    tables = env.tables
    n_act = env.compiled.n_actions

    def run(estate):
        def body(acc, i):
            ea = (estate.executed_action + i) % n_act
            obs = jax.vmap(lambda s, a: render_observations(s, tables, a, s.reward))(estate, ea)
            return acc + jnp.sum(obs.astype(jnp.int32)), None

        acc, _ = jax.lax.scan(body, jnp.int32(0), jnp.arange(iters))
        return acc

    return jax.jit(run)


def _time_program(name: str, prog, args, n: int, trace_dir: str | None) -> dict:
    """Host-clock time of one call of a compiled program that runs ``n``
    steps (after one warm call), and the device's busy time in a traced call.
    The trace is deleted once read: traces are large."""
    jax.block_until_ready(prog(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(prog(*args))
    wall = time.perf_counter() - t0
    busy = None
    if trace_dir is not None:
        from metta_tpu.utils.device import device_busy_seconds

        busy, lines = device_busy_seconds(lambda: prog(*args), f"{trace_dir}/{name}")
        shutil.rmtree(f"{trace_dir}/{name}", ignore_errors=True)
        if busy is None:
            log(f"{name}: no Stream lines in the trace; device lines: {lines}")
    out = {"wall_ms_per_step": 1e3 * wall / n,
           "device_busy_ms_per_step": None if busy is None else 1e3 * busy / n}
    log(f"{name}: {out['wall_ms_per_step']:.4f} ms per step on the host clock "
        f"({n} steps in one program), device busy {out['device_busy_ms_per_step']} ms per step")
    return out


def phase_sim(num_envs: int = 4096, steps: int = 100, agents: int = 24,
              render_iters: int = 20, trace_dir: str | None = None) -> dict:
    import bench

    r = bench.measure(num_envs, steps, agents)
    env, vstate, compiled = r["env"], r["vstate"], r["compiled"]
    log(f"sim combat E={num_envs} A={r['agents_per_env']}: compile {r['compile_s']:.3f} s, "
        f"{r['env_steps_per_s']:.1f} env-steps/s, {r['agent_steps_per_s']:.1f} agent-steps/s, "
        f"{r['step_ms']:.4f} ms/step (median of windows {r['window_walls_s']})")
    log(f"sim memory_analysis: {compiled.memory_analysis()}")
    log(f"sim conversion chain: held {r['held']}")
    out = {k: r[k] for k in ("compile_s", "env_steps_per_s", "agent_steps_per_s",
                             "step_ms", "window_walls_s", "held")}
    out[f"sim_step_E{num_envs}"] = _time_program(
        f"sim_step_E{num_envs}", compiled, (vstate, jax.random.PRNGKey(2)), steps, trace_dir)

    # The observation render alone, on this state.
    name = f"render_E{num_envs}"
    t0 = time.perf_counter()
    prog = _render_program(env, render_iters).lower(vstate.env).compile()
    temp = prog.memory_analysis().temp_size_in_bytes
    log(f"{name}: compile {time.perf_counter() - t0:.3f} s, {temp / 1e9:.3f} GB of temporaries")
    out[name] = {"temp_gb": temp / 1e9,
                 **_time_program(name, prog, (vstate.env,), render_iters, trace_dir)}
    return out


def _arena_env_cfgs(n_tasks: int | None = None):
    from recipes.arena_basic_easy_shaped import make_curriculum, mettagrid

    base = mettagrid()
    base.game.map_builder.seed = 123
    tasks = [t.get_env_cfg() for t in make_curriculum().active_tasks()[:n_tasks]]
    for i, cfg in enumerate(tasks):
        cfg.game.map_builder.seed = 123 + i
    return base, tasks


def phase_differential(device, num_envs: int = 8, steps: int = 64,
                       n_tasks: int | None = None, policy_cfg=None) -> dict:
    from metta_tpu.differential import engine_differential, policy_differential
    from metta_tpu.engine.env import MettaGridEnv
    from metta_tpu.engine.taskset import MultiTaskEnv
    from metta_tpu.models.vit import ViTConfig

    base, tasks = _arena_env_cfgs(n_tasks)
    makers = {
        "MettaGridEnv": lambda: MettaGridEnv(base, num_envs=num_envs, desync_episodes=False,
                                             track_stats=True, step_mode="batched"),
        "MultiTaskEnv": lambda: MultiTaskEnv(tasks, num_envs=num_envs, desync_episodes=False,
                                             track_stats=True, step_mode="batched"),
    }
    out, failures = {}, []
    for name, make in makers.items():
        rep = engine_differential(make, device, n_steps=steps, rtol=ENGINE_RTOL)
        last_obs = rep.pop("last_obs")
        log(f"differential {name}: step_mode={rep['step_mode']} E={rep['num_envs']} "
            f"{rep['steps']} steps, {rep['obs_bytes_compared']} obs bytes, "
            f"{len(rep['mismatches'])} mismatching fields; the CPU trajectory gained "
            f"{rep['ref_gained']}")
        for m in rep["mismatches"]:
            log("  " + m)
        if rep["step_mode"] != "batched":
            failures.append(f"{name} fell back to {rep['step_mode']}")
        failures += rep["mismatches"]
        out[name] = rep

    env = MettaGridEnv(base, num_envs=1)
    obs = last_obs.reshape(-1, *last_obs.shape[2:])
    pcfg = policy_cfg or ViTConfig()
    rep = policy_differential(pcfg, env.compiled.n_actions,
                              env.compiled.feature_normalizations, obs, device)
    log(f"differential policy (latent {pcfg.latent_dim}, core {pcfg.core} x{pcfg.core_layers}, "
        f"{pcfg.max_tokens} tokens, actor {pcfg.actor_hidden}, critic {pcfg.critic_hidden}, "
        f"batch {rep['batch']}): {json.dumps(rep)}")
    for n in ("logits", "value", "h_value"):
        e = rep[n]
        if not e["finite"]:
            failures.append(f"policy {n} not finite")
        if e["bf16_ulps"] > BF16_ULP_TOLERANCE:
            failures.append(f"policy {n}: {e['bf16_ulps']:.2f} bf16 ulps > {BF16_ULP_TOLERANCE}")
        if e["max_abs_f32"] > F32_ATOL:
            failures.append(f"policy {n}: float32 error {e['max_abs_f32']:.3g} > {F32_ATOL}")
    if rep["state_max_abs_f32"] > F32_ATOL:
        failures.append(f"policy state: float32 error {rep['state_max_abs_f32']:.3g}")
    out["policy"] = rep
    if failures:
        raise RuntimeError("differential failed: " + "; ".join(failures[:10]))
    return out


def phase_train(out_dir: str, overrides: tuple = (), updates: int = 1) -> dict:
    """Train through ``cli_entry``; ``overrides`` (``key=value``) apply after
    the recipe's defaults, and only ``trainer.total_timesteps`` is set here.

    One update by default: at the trainer defaults an update takes about
    300 s on an H100 (and the first adds about 140 s of compilation), so
    three would not fit the smoke's 1200 s beside the other phases."""
    from metta_tpu.engine.env import MettaGridEnv
    from metta_tpu.policy.policy import NetworkPolicy
    from metta_tpu.rl.checkpoint import CheckpointManager
    from metta_tpu.tools.tool import apply_overrides, cli_entry, load_tool
    from recipes.arena_basic_easy_shaped import mettagrid

    recipe = "recipes.arena_basic_easy_shaped.train"
    data_dir = str(Path(out_dir) / "train")
    args = [f"data_dir={data_dir}", *overrides]
    tool = apply_overrides(load_tool(recipe), args)
    tc = tool.trainer
    A = mettagrid().game.num_agents
    E = tc.num_envs or max(tc.batch_size // (tc.bptt_horizon * A), 1)
    per_update = E * A * tc.bptt_horizon
    total = (updates - 1) * per_update + 1
    log(f"train: {recipe} E={E} A={A} bptt={tc.bptt_horizon} batch={tc.batch_size} "
        f"minibatch={tc.minibatch_size}; {updates} updates of {per_update} agent-steps")
    t0 = time.perf_counter()
    rc = cli_entry([recipe, *args, f"trainer.total_timesteps={total}"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli_entry returned {rc}")

    run_dir = Path(data_dir) / tool.run
    rows = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != updates:
        raise RuntimeError(f"{len(rows)} updates logged, expected {updates}")
    losses = {k: v for r in rows for k, v in r.items() if k.startswith("losses/")}
    bad = [k for r in rows for k, v in r.items()
           if k.startswith("losses/") and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite losses: {sorted(set(bad))}")
    sps = [r["overview/sps"] for r in rows]
    log(f"train: {updates} updates in {wall:.3f} s (compile included); overview/sps per "
        f"update {sps}; last losses {json.dumps(losses)}")

    uri = CheckpointManager(tool.run, data_dir).latest_policy_uri()
    if uri is None:
        raise RuntimeError("no policy bundle written")
    env = MettaGridEnv(mettagrid(), num_envs=1)
    pol = NetworkPolicy.from_bundle(uri, env, n_slots=env.num_agents)
    leaves = jax.tree.leaves(pol.params)
    if not all(np.isfinite(np.asarray(x)).all() for x in leaves):
        raise RuntimeError("reloaded bundle has non-finite parameters")
    acts = pol.step_batch(env.reset()[0])
    if acts.shape != (env.num_agents,) or acts.min() < 0 or acts.max() >= env.compiled.n_actions:
        raise RuntimeError(f"reloaded policy gave bad actions {acts}")
    log(f"train: bundle {uri} reloaded ({len(leaves)} arrays, "
        f"{sum(np.asarray(x).size for x in leaves)} parameters); actions {acts.tolist()}")
    return {"overview_sps": sps, "wall_s": wall, "bundle": uri}


def _dp_setup(n_cards: int, per_card_envs: int, trainer_overrides: dict, policy_cfg):
    """A DistributedTrainer over the first ``n_cards`` devices, its state
    (checked to hold ``per_card_envs`` envs on each card), the update's
    runtime arguments and its lowered update program."""
    from metta_tpu.parallel.distributed import DistributedTrainer, make_mesh
    from metta_tpu.rl.config import TrainerConfig
    from recipes.arena_basic_easy_shaped import mettagrid

    cfg = mettagrid()
    cfg.game.map_builder.seed = 123
    tr = DistributedTrainer(cfg, TrainerConfig(**trainer_overrides), policy_cfg,
                            num_envs=per_card_envs * n_cards, mesh=make_mesh(n_cards))
    ts = tr.init_state()
    shards = ts.vstate.env.step.addressable_shards
    per_shard = sorted({s.data.shape[0] for s in shards})
    if len(shards) != n_cards or per_shard != [per_card_envs]:
        raise RuntimeError(f"{len(shards)} env shards of sizes {per_shard}, expected "
                           f"{n_cards} of {per_card_envs}")
    # the arguments Trainer.update passes on the single-task path
    args = (jnp.asarray(tr.default_hp(), jnp.float32), jnp.int32(tr.cfg.update_epochs))
    return tr, ts, args, tr._update_jit.lower(ts, *args)


def _dp_run(tr, ts, args, update, n_cards: int, updates: int) -> dict:
    walls = []
    for _ in range(updates):
        t0 = time.perf_counter()
        ts, metrics = update(ts, *args)
        jax.block_until_ready(ts.params)
        walls.append(time.perf_counter() - t0)
    for leaf in jax.tree.leaves(ts.params):
        copies = [np.asarray(s.data) for s in leaf.addressable_shards]
        if len(copies) != n_cards or any(not np.array_equal(copies[0], c) for c in copies[1:]):
            raise RuntimeError("parameters differ between cards after the updates")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in m.values()):
        raise RuntimeError(f"non-finite metrics {m}")
    steps = tr.B * tr.T
    return {"cards": n_cards, "num_envs": tr.E, "agent_steps_per_update": steps,
            "update_walls_s": walls, "agent_steps_per_s": steps / walls[-1]}


FOUR_CARD_TRAINER = {"bptt_horizon": 64}


def phase_four_cards(per_card_envs: int = 341, updates: int = 2,
                     trainer_overrides: dict | None = None, policy_cfg=None) -> dict:
    """DistributedTrainer over four cards against one card at the same
    per-card width: each card holds ``per_card_envs`` envs and parameters are
    bit-identical across cards after the updates. Both update programs are
    compiled first, at the same time in two threads; the last update of
    each is timed."""
    from concurrent.futures import ThreadPoolExecutor

    from metta_tpu.models.vit import ViTConfig

    over = FOUR_CARD_TRAINER if trainer_overrides is None else trainer_overrides
    policy_cfg = policy_cfg or ViTConfig(core="lstm")
    t0 = time.perf_counter()
    setups = {n: _dp_setup(n, per_card_envs, over, policy_cfg) for n in (1, 4)}
    log(f"dp: trainers built, states placed and updates lowered in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(setups)) as pool:
        compiled = dict(zip(setups, pool.map(lambda su: su[3].compile(), setups.values())))
    log(f"dp: the 1-card and 4-card update programs compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for n in (4, 1):    # four cards first: the phase's point, should the run be cut short
        tr, ts, args, _ = setups.pop(n)
        out[n] = _dp_run(tr, ts, args, compiled[n], n, updates)
        log(f"dp {n} card(s): {json.dumps(out[n])}")
    log(f"dp scaling: {out[4]['agent_steps_per_s'] / out[1]['agent_steps_per_s']:.3f}x "
        f"agent-steps/s on 4 cards over 1 card (ideal 4x)")
    return {"one": out[1], "four": out[4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke")
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)

    from metta_tpu.utils.device import (device_summary, enable_compile_cache,
                                        gpu_name_and_power_limit, require_gpu)

    require_gpu()
    log(f"compile cache: {enable_compile_cache()}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results = {}
    t_all = time.perf_counter()

    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        log(f"== {name}")
        results[name] = fn(*a, **kw)
        log(f"== {name} passed in {time.perf_counter() - t0:.1f} s")

    if args.four_cards:
        if len(jax.devices()) < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
        run("four_cards", phase_four_cards)
    else:
        run("probe", phase_probe)
        run("sim", phase_sim, trace_dir=str(out / "traces"))
        run("differential", phase_differential, device=jax.devices()[0])
        run("train", phase_train, out_dir=str(out))
    (out / "results.json").write_text(json.dumps(results, indent=1, default=str))
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    for line in gpu_name_and_power_limit():
        log(f"gpu: {line}")
    print(json.dumps({"ok": True, "device": device_summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
