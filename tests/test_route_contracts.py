"""Route-contract conformance vs the reference app_backend.

The reference's observatory/gridworks React frontends are formally out of
scope (cloud product UIs); what IS in scope is the DATA CONTRACT those UIs
consume. These tests extract the reference's pydantic response models
directly from its route modules (AST parse — no reference imports needed)
and assert our stdlib server's responses carry exactly those fields, so a
reference frontend pointed at our data plane would parse every implemented
route. The deliberately-unimplemented surface is pinned as an explicit
inventory below.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REF_ROUTES = Path("/root/reference/app_backend/src/metta/app_backend/routes")

pytestmark = pytest.mark.skipif(
    not REF_ROUTES.exists(), reason="reference app_backend not available"
)


def _model_fields(module_path: Path, class_name: str) -> list[str]:
    """Field names of a pydantic BaseModel, in declaration order."""
    tree = ast.parse(module_path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return [
                st.target.id
                for st in node.body
                if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name)
            ]
    raise AssertionError(f"{class_name} not found in {module_path}")


@pytest.fixture(scope="module")
def backend(tmp_path_factory):
    from metta_tpu.utils.stats_writer import StatsWriter
    from metta_tpu.web.app_backend import AppBackend

    d = tmp_path_factory.mktemp("routedb")
    db = d / "stats.db"
    w = StatsWriter(db)
    w.record_episode(
        stats={"agent": [{"heart.gained": 1.0}], "game": {}},
        rewards=[1.0], sim_suite="arena", sim_name="basic",
        policy_uri="file:///p/a:v1", steps=10,
    )
    w.close()
    return AppBackend(str(db), str(d / "queue"))


def test_sql_query_response_contract(backend):
    ref = _model_fields(REF_ROUTES / "sql_routes.py", "SQLQueryResponse")
    got = backend.sql_query({"query": "SELECT 1"})
    assert sorted(got.keys()) == sorted(ref)


def test_table_info_contract(backend):
    ref = _model_fields(REF_ROUTES / "sql_routes.py", "TableInfo")
    rows = backend.tables()
    assert rows, "no tables"
    for row in rows:
        assert sorted(row.keys()) == sorted(ref)


def test_table_schema_contract(backend):
    ref = _model_fields(REF_ROUTES / "sql_routes.py", "TableSchema")
    got = backend.table_schema("episodes")
    assert sorted(got.keys()) == sorted(ref)


def test_unimplemented_surface_is_inventoried():
    """The reference route modules we deliberately do NOT implement (cloud
    product plumbing: Postgres orchestration, auth, tournaments, sweeps-as-
    a-service, job fan-out). If the reference grows a new module, this fails
    so the decision gets re-made instead of rotting silently."""
    ours_implemented = {"sql_routes.py", "stats_routes.py",
                        "eval_task_routes.py",
                        "tournament_routes.py"}  # r5: seasons/leaderboards
    known_out_of_scope = {
        "job_routes.py",          # cloud job fan-out (skypilot workers)
        "sweep_routes.py",        # sweep-as-a-service persistence
    }
    present = {p.name for p in REF_ROUTES.glob("*_routes.py")}
    unaccounted = present - ours_implemented - known_out_of_scope
    assert not unaccounted, (
        f"new reference route modules need a scope decision: {unaccounted}"
    )


def test_observatory_spa_served_with_matching_fields(tmp_path):
    """The observatory SPA is served at / and every API field its views read
    is present in the corresponding route responses (PoliciesPage /
    EpisodeDetailPage / heatmap / SQLQuery parity views)."""
    from metta_tpu.utils.stats_writer import StatsWriter
    from metta_tpu.web.app_backend import AppBackend
    from metta_tpu.web.observatory_html import OBSERVATORY_HTML

    db = tmp_path / "stats.sqlite"
    w = StatsWriter(db)
    stats = {"agent": [{"heart.gained": 1.0}], "game": {"hearts": 2.0}}
    w.record_episode(stats, [0.5], sim_suite="arena", sim_name="basic",
                     policy_uri="file:///p:v1", steps=10)
    w.close()
    b = AppBackend(str(db))

    code, page = b.handle("GET", "/", {}, {})
    assert code == 200 and "__html__" in page
    html = page["__html__"]
    assert html == OBSERVATORY_HTML
    for view in ("policies", "episodes", "heatmap", "sql"):
        assert f'data-v="{view}"' in html

    # fields the SPA reads, per view
    _, pol = b.handle("GET", "/stats/policies", {}, {})
    assert {"policy_uri", "episodes", "last_seen"} <= set(pol["policies"][0])
    _, eps = b.handle("POST", "/stats/episodes/query", {}, {"limit": 10})
    assert "episode_id" in eps["episodes"][0]
    eid = eps["episodes"][0]["episode_id"]
    _, met = b.handle("GET", f"/stats/episodes/{eid}/metrics", {}, {})
    assert {"agent_id", "metric", "value"} <= set(met["agent_metrics"][0])
    _, hm = b.handle("GET", "/dashboard/heatmap", {"metric": ["reward"]}, {})
    assert {"policies", "sims", "cells"} <= set(hm)
    assert {"policy", "sim", "value"} <= set(hm["cells"][0])
    _, sq = b.handle("POST", "/sql/query", {},
                     {"query": "SELECT episode_id FROM episodes"})
    assert {"columns", "rows"} <= set(sq)
