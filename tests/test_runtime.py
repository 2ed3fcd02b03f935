"""Where the program runs: compile cache, GPU guard, and the entry points'
refusal to measure or train on anything but a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from metta_tpu.utils import device as D

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_uses_env_var(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert D.enable_compile_cache() == "/somewhere/else"
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = D.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        D.require_gpu()
    assert D.device_summary()["platform"] == "cpu"


def test_tool_rejects_unknown_device():
    from metta_tpu.tools.tool import Tool

    with pytest.raises(SystemExit):
        Tool(device="cpu").model_copy(update={"device": "metal"})._apply_device()


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_point_fails_without_gpu(script):
    out = _run([script], REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_main_path_imports_only_guaranteed_packages():
    """tools/run.py -> TrainTool -> Trainer -> env -> policy -> checkpoint
    imports nothing beyond JAX, numpy, optax, chex and pydantic."""
    code = """
import sys
class Block:
    banned = ("flax", "safetensors", "msgpack", "yaml", "wandb", "grpc",
              "boto3", "gymnasium", "google.protobuf", "orbax")
    def find_spec(self, name, path=None, target=None):
        if name in self.banned or name.startswith(tuple(b + "." for b in self.banned)):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import recipes.arena_basic_easy_shaped, metta_tpu.tools.tool, metta_tpu.tools.train
import metta_tpu.rl.trainer, metta_tpu.engine.taskset, metta_tpu.policy.policy
import metta_tpu.rl.checkpoint, metta_tpu.parallel.distributed
tool = recipes.arena_basic_easy_shaped.train()
print("ok")
"""
    out = _run(["-c", code], REPO)
    assert out.returncode == 0, out.stderr[-2000:]
