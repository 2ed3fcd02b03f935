"""Replay golden-file test vs a reference-engine-generated replay
(mettascope byte-compatibility evidence).

Drives the reference C++ engine (same oracle as tests/test_parity_cpp.py)
with the reference ``InMemoryReplayWriter`` and our engine with our
``EpisodeReplay`` on an identical deterministic single-agent episode, then
compares the replay documents: version, structural keys, object inventory,
and the per-step action/reward/position streams of every object.

Skipped automatically when the oracle can't be built.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")

from oracle_support import oracle_available  # noqa: E402

pytestmark = pytest.mark.skipif(
    not oracle_available(), reason="reference C++ oracle unavailable"
)


NAV_MAP = [
    "##########",
    "#0.....#.#",
    "#.####...#",
    "#....#.Z.#",
    "#.##.#...#",
    "#........#",
    "##########",
]


def _expand(stream):
    """Expand a mettascope [step, value] keyframe stream to per-step values."""
    if not isinstance(stream, list) or not stream or not isinstance(stream[0], list):
        return stream  # constant value
    out = {}
    for step, value in stream:
        out[step] = value
    return out


def test_replay_matches_reference_engine(tmp_path):
    from test_parity_cpp import _ref, make_nav_pair  # noqa: E402

    from metta_tpu.engine.env import MettaGridEnv
    from metta_tpu.sim.replay_writer import EpisodeReplay

    my_cfg, ref_cfg = make_nav_pair(NAV_MAP, max_steps=40)
    building, M, AsciiMapBuilder, Simulation = _ref()
    from mettagrid.simulator.replay_log_writer import InMemoryReplayWriter

    writer = InMemoryReplayWriter()
    sim = Simulation(ref_cfg, seed=123, event_handlers=[writer])

    env = MettaGridEnv(my_cfg, num_envs=1, step_mode="sequential",
                       desync_episodes=False)
    env.reset(seed=0)
    my_replay = EpisodeReplay(env, my_cfg)

    rng = np.random.default_rng(5)
    names = list(env.action_names)
    steps = 40
    for t in range(steps):
        a = int(rng.integers(len(names)))
        sim._c_sim.actions()[0] = a
        sim.step()
        obs, rew, done, trunc = env.step_no_reset(np.asarray([[a]], np.int32))
        my_replay.log_step(env.state.env, np.asarray([a]),
                           env.action_success(0), rew[0], e=0)
        if bool(done[0] or trunc[0]):
            break

    ref_doc = writer._episode_replay.get_replay_data()
    my_doc = my_replay.get_replay_data()

    # format contract
    assert my_doc["version"] == ref_doc["version"] == 3
    for key in ("version", "num_agents", "max_steps", "map_size",
                "action_names", "item_names", "type_names", "objects"):
        assert key in ref_doc and key in my_doc, key
    assert my_doc["num_agents"] == ref_doc["num_agents"]
    assert my_doc["max_steps"] == ref_doc["max_steps"]
    assert list(my_doc["map_size"]) == list(ref_doc["map_size"])
    assert list(my_doc["action_names"]) == list(ref_doc["action_names"])
    assert list(my_doc["item_names"]) == list(ref_doc["item_names"])

    # same object population by (type_name, initial location)
    def keyed(doc):
        out = {}
        for obj in doc["objects"]:
            tn = doc["type_names"][obj["type_id"]] if isinstance(
                obj.get("type_id"), int) else obj.get("type_name")
            loc = obj.get("location")
            if isinstance(loc, list) and loc and isinstance(loc[0], list):
                loc0 = loc[0][1]
            else:
                loc0 = loc
            out[(tn, tuple(loc0))] = obj
        return out

    mine = keyed(my_doc)
    ref = keyed(ref_doc)
    assert set(mine.keys()) == set(ref.keys())

    # the agent's streams match step-for-step
    agent_key = next(k for k in ref if k[0] == "agent")
    ref_agent = ref[agent_key]
    my_agent = mine[agent_key]
    for field in ("location", "action_id", "current_reward", "total_reward",
                  "action_success"):
        r = _expand(ref_agent.get(field))
        m = _expand(my_agent.get(field))
        assert m == r, f"agent stream {field!r} diverges: {m} vs {r}"
