"""Checkpoint management.

Parity: reference ``metta/rl/checkpoint_manager.py:21-222`` +
``training/checkpointer.py`` / ``context_checkpointer.py``. Two artifacts per
run under ``<data_dir>/<run>/checkpoints/``:

1. policy bundle dir ``<run>:v<epoch>/`` = ``weights.safetensors`` +
   ``policy_spec.json`` (class path + architecture spec, so the network can be
   rebuilt without pickles),
2. trainer state ``trainer_state.npz`` (the TrainState pytree's leaves, in
   flatten order: optimizer state, counters, reward EMA, rng) plus
   ``trainer_meta.json`` (epoch and counters), restored on resume.

URIs: ``file://`` paths (s3/wandb schemes are accepted and mapped to local
cache misses with a clear error — remote storage is environment-specific).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import re
import struct
import zipfile
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

# safetensors layout: an 8-byte little-endian header length, a JSON header
# {name: {"dtype", "shape", "data_offsets": [begin, end]}} padded with spaces
# to 8 bytes, then the raw little-endian buffers.
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": jnp.bfloat16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U64": np.uint64, "U32": np.uint32, "U16": np.uint16,
    "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def save_safetensors(tensors: dict[str, np.ndarray], path: str | Path):
    header, bufs, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name], order="C")
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        buf = a.tobytes()
        header[name] = {"dtype": _ST_NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(buf)]}
        bufs.append(buf)
        offset += len(buf)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for buf in bufs:
            f.write(buf)


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = np.dtype(_ST_DTYPES[info["dtype"]])
        a = np.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                          offset=8 + n + begin)
        out[name] = a.reshape(info["shape"]).copy()
    return out


def _params_to_flat(params, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update(_params_to_flat(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def _flat_to_params(flat: dict[str, np.ndarray], like=None):
    tree: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    if like is not None and jax.tree.structure(like) != jax.tree.structure(tree):
        raise ValueError("bundle parameters do not match the policy's structure")
    return tree


def save_policy_bundle(path: str | Path, params, policy_cfg, extra: Optional[dict] = None):
    """Write ``weights.safetensors`` + ``policy_spec.json`` into ``path``.

    The bundle is staged in a temp dir and renamed into place so a crash
    mid-write never leaves a half-written bundle that ``list_policies``
    would pick up (it keys on weights.safetensors existing).
    """
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        import shutil

        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    save_safetensors(_params_to_flat(params), tmp / "weights.safetensors")
    cls = type(policy_cfg)
    spec = {
        "class_path": f"{cls.__module__}.{cls.__qualname__}",
        "architecture_spec": dataclasses.asdict(policy_cfg)
        if dataclasses.is_dataclass(policy_cfg)
        else dict(policy_cfg),
    }
    if extra:
        spec.update(extra)
    (tmp / "policy_spec.json").write_text(json.dumps(spec, indent=2))
    if path.exists():
        import shutil

        shutil.rmtree(path)
    os.replace(tmp, path)


def load_policy_bundle(path: str | Path, params_like=None):
    """Returns (params, policy_cfg, spec_dict)."""
    path = Path(str(path).removeprefix("file://"))
    flat = load_safetensors(path / "weights.safetensors")
    spec = json.loads((path / "policy_spec.json").read_text())
    mod_name, _, cls_name = spec["class_path"].rpartition(".")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    policy_cfg = cls(**spec["architecture_spec"])
    params = _flat_to_params(flat, like=params_like)
    return params, policy_cfg, spec


class CheckpointManager:
    """Run-directory checkpoint layout + save/load/latest resolution."""

    def __init__(self, run: str, data_dir: str | Path = "./train_dir"):
        self.run = run
        self.run_dir = Path(data_dir) / run
        self.checkpoint_dir = self.run_dir / "checkpoints"
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

    # ---- policy bundles ----

    def bundle_path(self, epoch: int) -> Path:
        return self.checkpoint_dir / f"{self.run}:v{epoch}"

    def save_policy(self, params, policy_cfg, epoch: int, metadata: Optional[dict] = None) -> str:
        path = self.bundle_path(epoch)
        save_policy_bundle(path, params, policy_cfg, extra={"epoch": epoch, **(metadata or {})})
        return f"file://{path}"

    def list_policies(self) -> list[tuple[int, Path]]:
        out = []
        for p in self.checkpoint_dir.glob(f"{self.run}:v*"):
            m = re.match(rf"{re.escape(self.run)}:v(\d+)$", p.name)
            if m and (p / "weights.safetensors").exists():
                out.append((int(m.group(1)), p))
        return sorted(out)

    def latest_policy_uri(self) -> Optional[str]:
        bundles = self.list_policies()
        return f"file://{bundles[-1][1]}" if bundles else None

    def load_policy(self, epoch: Optional[int] = None, params_like=None):
        bundles = self.list_policies()
        if not bundles:
            raise FileNotFoundError(f"No policy bundles in {self.checkpoint_dir}")
        if epoch is None:
            path = bundles[-1][1]
        else:
            path = dict(bundles)[epoch]
        return load_policy_bundle(path, params_like=params_like)

    # ---- trainer state ----

    def save_trainer_state(self, ts, epoch: int, extras: Optional[dict] = None):
        """Serialize the full TrainState pytree + counters (context_checkpointer parity).

        Writes are atomic (temp file + ``os.replace``): a crash/SIGKILL mid-write
        must never leave a truncated checkpoint that poisons the next resume.
        """
        leaves = [np.asarray(x) for x in jax.tree.leaves(ts)]
        # state first, meta last: a kill between the two renames leaves the
        # previous meta with the new state — the leaves follow the fixed
        # TrainState treedef, so the two files stay compatible across epochs.
        tmp = self.checkpoint_dir / "trainer_state.npz.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, *leaves)
        os.replace(tmp, self.checkpoint_dir / "trainer_state.npz")
        tmp = self.checkpoint_dir / "trainer_meta.json.tmp"
        tmp.write_text(json.dumps({"epoch": epoch, "extras": extras or {}}))
        os.replace(tmp, self.checkpoint_dir / "trainer_meta.json")

    def load_trainer_state(self, ts_like):
        meta_path = self.checkpoint_dir / "trainer_meta.json"
        state_path = self.checkpoint_dir / "trainer_state.npz"
        if not state_path.exists():
            return None, None
        like, treedef = jax.tree.flatten(ts_like)
        try:
            meta = json.loads(meta_path.read_text())
            with np.load(state_path) as z:
                leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
            if len(leaves) != len(like):
                raise ValueError(f"{len(leaves)} leaves, expected {len(like)}")
            for i, (a, b) in enumerate(zip(leaves, like)):
                if a.dtype != b.dtype and a.dtype.itemsize == np.dtype(b.dtype).itemsize:
                    leaves[i] = a = a.view(b.dtype)   # npy stores bfloat16 as raw V2
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(f"leaf {i} is {a.dtype}{a.shape}, expected "
                                     f"{b.dtype}{b.shape}")
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            # corrupt or stale checkpoint (e.g. killed mid-write)
            logger.warning(
                "trainer state in %s is unreadable (%s); starting fresh",
                self.checkpoint_dir, e,
            )
            return None, None
        return jax.tree.unflatten(treedef, leaves), meta


def resolve_uri(uri: str) -> Path:
    """file:// URIs resolve locally; other schemes raise with guidance.

    Parity: the reference supports file/s3/wandb via
    ``mettagrid/util/uri_resolvers/schemes.py``; remote schemes need
    environment credentials and are out of scope for the core.
    """
    if uri.startswith("file://"):
        return Path(uri[7:])
    if "://" not in uri:
        return Path(uri)
    raise ValueError(f"Unsupported checkpoint URI scheme for {uri!r}; use file:// paths")
