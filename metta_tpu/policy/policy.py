"""Inference-policy API.

Parity: reference ``mettagrid/policy/policy.py:22-264`` (``AgentPolicy`` /
``MultiAgentPolicy`` / ``StatefulAgentPolicy``) + ``policy/loader.py``.
Addition: policies are *batched* — ``step_batch`` acts on
``[N, tokens, 3]`` observations for N agent-slots at once so evaluation can
vectorize whole episode batches on device.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class AgentPolicy:
    """Single-agent stepwise view of a policy."""

    def __init__(self, parent: "MultiAgentPolicy", agent_id: int):
        self.parent = parent
        self.agent_id = agent_id

    def reset(self) -> None:
        self.parent.reset_agent(self.agent_id)

    def step(self, obs: np.ndarray) -> int:
        return int(self.parent.step_batch(obs[None])[0])


class MultiAgentPolicy:
    """Batched policy over agent slots; subclasses implement step_batch."""

    def agent_policy(self, agent_id: int) -> AgentPolicy:
        return AgentPolicy(self, agent_id)

    def reset(self, n_slots: Optional[int] = None) -> None:
        pass

    def reset_agent(self, agent_id: int) -> None:
        pass

    def reset_slots(self, mask: np.ndarray) -> None:
        """Reset recurrent state for the masked slots (episode boundaries)."""

    def step_batch(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class NoopPolicy(MultiAgentPolicy):
    def step_batch(self, obs):
        return np.zeros((obs.shape[0],), np.int32)


class RandomPolicy(MultiAgentPolicy):
    def __init__(self, n_actions: int, seed: int = 0):
        self.n_actions = n_actions
        self.rng = np.random.default_rng(seed)

    def step_batch(self, obs):
        return self.rng.integers(0, self.n_actions, size=(obs.shape[0],), dtype=np.int32)


class NetworkPolicy(MultiAgentPolicy):
    """A trained policy with per-slot recurrent state.

    Greedy or sampling action selection; slots map to (episode, agent) pairs
    in batched evaluation.
    """

    def __init__(self, policy, params, n_slots: int, sample: bool = True, seed: int = 0):
        self.policy = policy
        self.params = params
        self.n_slots = n_slots
        self.sample = sample
        self.key = jax.random.PRNGKey(seed)
        self.state = policy.initial_state(n_slots)

        def apply(params, obs, state, key):
            logits, value, _hv, new_state = policy.apply(params, obs, state)
            if sample:
                action = jax.random.categorical(key, logits)
            else:
                action = jnp.argmax(logits, axis=-1)
            return action.astype(jnp.int32), new_state

        self._apply = jax.jit(apply)

    @classmethod
    def from_bundle(cls, uri: str, env, n_slots: int, sample: bool = True, seed: int = 0):
        """Load from a checkpoint bundle written by CheckpointManager."""
        from metta_tpu.rl.checkpoint import load_policy_bundle, resolve_uri

        params, policy_cfg, spec = load_policy_bundle(resolve_uri(uri))
        policy = policy_cfg.make(env.compiled.n_actions, env.compiled.feature_normalizations)
        # re-init params structure then load weights into it
        obs0 = jnp.zeros((1, policy_cfg.max_tokens, 3), jnp.uint8)
        like = policy.init(jax.random.PRNGKey(0), obs0, policy.initial_state(1))
        params, _, _ = load_policy_bundle(resolve_uri(uri), params_like=like)
        return cls(policy, params, n_slots, sample=sample, seed=seed)

    def reset(self, n_slots: Optional[int] = None) -> None:
        if n_slots is not None:
            self.n_slots = n_slots
        self.state = self.policy.initial_state(self.n_slots)

    def reset_slots(self, mask: np.ndarray) -> None:
        m = jnp.asarray(mask)
        self.state = jax.tree.map(
            lambda z: jnp.where(m.reshape((-1,) + (1,) * (z.ndim - 1)), jnp.zeros_like(z), z),
            self.state,
        )

    def step_batch(self, obs: np.ndarray) -> np.ndarray:
        self.key, k = jax.random.split(self.key)
        obs = jnp.asarray(obs)[:, : self.policy.cfg.max_tokens]
        action, self.state = self._apply(self.params, obs, self.state, k)
        return np.asarray(action)
