"""Multi-card scaling: mesh construction + data-parallel sharded training step.

The replacement for the reference's torch-DDP/NCCL stack
(``metta/rl/training/distributed_helper.py:29-130``): instead of per-rank
processes with NCCL all-reduce, one SPMD program over a
``jax.sharding.Mesh``. Envs and rollout rows are sharded along the ``data``
axis (each card simulates its own env shard — the analogue of the
reference's per-worker envs AND of DDP's per-rank batches at once); gradients
and advantage statistics are reduced with ``psum/pmean``, which XLA hands to
NCCL. A ``model`` axis is reserved for tensor sharding but unused by default —
the reference has no TP/PP either (SURVEY §2.5) and the policy is small
(latent 128). The cards of one host are joined all to all, so the mesh
follows the algorithm alone.

Several processes: call ``jax.distributed.initialize(coordinator_address,
num_processes, process_id)`` before building the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from metta_tpu.config.mettagrid_config import MettaGridConfig
from metta_tpu.models.vit import ViTConfig
from metta_tpu.rl.config import TrainerConfig
from metta_tpu.rl.trainer import Trainer, TrainState


def shard_map(f, *, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def make_mesh(n_devices: Optional[int] = None, model: int = 1) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    data = len(devs) // model
    arr = np.asarray(devs[: data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


# PartitionSpec per TrainState field: env-side state sharded on the leading
# (env/row) dim over "data"; learner state replicated.
def _state_spec() -> TrainState:
    return TrainState(
        params=P(),
        opt_state=P(),
        key=P(),          # replicated; shards fold in their axis index
        vstate=P("data"),
        obs=P("data"),
        core=P("data"),
        prev_reward=P("data"),
        prev_done=P("data"),
        r_bar=P(),
        update_idx=P(),
        aux_params=P(),
        aux_opt_state=P(),
        loss_state=P(),
    )


class DistributedTrainer(Trainer):
    """Data-parallel trainer: env batch and learner rows sharded over ``data``.

    Each device owns ``E / n_data`` env instances; the rollout, advantage pass,
    and minibatch updates run shard-locally with ``pmean`` for gradients and
    advantage normalization (parity: DDP all-reduce + the reference's
    distributed advantage normalization).
    """

    def __init__(
        self,
        env_cfg: MettaGridConfig,
        trainer_cfg: Optional[TrainerConfig] = None,
        policy_cfg: Optional[ViTConfig] = None,
        num_envs: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_data = self.mesh.shape["data"]
        super().__init__(env_cfg, trainer_cfg, policy_cfg, num_envs)
        if self.E % self.n_data != 0:
            raise ValueError(f"num_envs={self.E} must be divisible by data axis {self.n_data}")

        # Shard-local trainer view: same params/policy, E/n_data envs.
        local = Trainer.__new__(Trainer)
        local.__dict__.update(self.__dict__)
        local.E = self.E // self.n_data
        local.B = local.E * self.A
        local.rows_per_mb = min(self.rows_per_mb, local.B)
        while local.B % local.rows_per_mb != 0:
            local.rows_per_mb -= 1
        local.n_minibatches = local.B // local.rows_per_mb
        self._local = local

        def sharded_update(ts: TrainState, hp, active_epochs):
            idx = jax.lax.axis_index("data")
            ts = ts.replace(key=jax.random.fold_in(ts.key, idx))
            ts, metrics = local._update(ts, hp, active_epochs, axis_name="data")
            # Re-sync the stored key so the replicated spec holds (all shards
            # derive next-round keys by folding their index again).
            ts = ts.replace(key=jax.lax.all_gather(ts.key, "data")[0])
            return ts, metrics

        spec = _state_spec()
        self._update_jit = jax.jit(
            shard_map(
                sharded_update,
                mesh=self.mesh,
                in_specs=(spec, P(), P()),
                out_specs=(spec, P()),
            ),
            donate_argnums=(0,),
        )

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        ts = super().init_state(seed)
        spec = _state_spec()

        def put_field(field_spec, value):
            return jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(self.mesh, field_spec)), value
            )

        kwargs = {
            f.name: put_field(getattr(spec, f.name), getattr(ts, f.name))
            for f in dataclasses.fields(TrainState)
        }
        return TrainState(**kwargs)
