"""metta_tpu — a multi-agent gridworld RL framework on JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of Metta-AI/metta:
the MettaGrid simulator is a pure-JAX vectorized engine (world state = pytree of
stacked arrays, stepped under ``jit``/``vmap``), and the PPO trainer is an
on-device actor-learner sharded over a ``jax.sharding.Mesh``.

Subpackages
-----------
- ``metta_tpu.config``       pydantic config tree (parity with reference
  ``mettagrid/config``) and the config→array compiler.
- ``metta_tpu.map_builder``  host-side numpy map generation.
- ``metta_tpu.engine``       the vectorized simulator.
- ``metta_tpu.models``       policy architectures (explicit parameter pytrees).
- ``metta_tpu.rl``           PPO trainer, losses, advantage scans.
- ``metta_tpu.parallel``     mesh/sharding helpers for multi-chip scaling.
"""

__version__ = "0.1.0"
