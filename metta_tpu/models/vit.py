"""ViT-style default policy.

Parity: reference ``agent/src/metta/agent/policies/vit.py:17-121``
(``ViTDefaultConfig``): token shim → Fourier attr embedding → Perceiver latent
pooling → recurrent core → actor MLP(256) + critic MLP(512) + GTD aux head.

The core is selectable (``core`` field):
- ``"lstm"`` — a scan LSTM,
- any cortex pattern string (e.g. the reference default ``"Ag,A,S"``) — a
  CortexStack of Column layers built from the cell library
  (``metta_tpu/models/cells.py``), matching the reference's
  ``build_cortex_auto_config(d_hidden, num_layers=2, pattern="Ag,A,S")``
  (``policies/vit.py:44-45,86-91``).

Recurrent-state contract either way: persistent during rollout, zero per BPTT
segment in the learner (``pass_state_during_training=False``,
``policies/vit.py:38``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import jax
import jax.numpy as jnp
from metta_tpu.models import nn

from metta_tpu.models.cells import CortexStack, StackSpec
from metta_tpu.models.components import LSTMCore, MLP, PerceiverLatent, TokenEmbed


@dataclass
class ViTConfig:
    """Architecture hyperparameters (defaults match the reference)."""

    latent_dim: int = 128
    actor_hidden: int = 256
    critic_hidden: int = 512
    core_num_heads: int = 4
    max_tokens: int = 128
    core_num_latents: int = 12
    token_embed_dim: int = 8
    fourier_freqs: int = 3
    # "lstm", or a cortex pattern ("Ag,A,S", "AXMS", "X", ...). Default =
    # the reference's default core, the "Ag,A,S" Column stack
    # (``agent/src/metta/agent/policies/vit.py:17-121``); "lstm" is a
    # lighter core kept for benchmarks/tests that opt in explicitly.
    core: str = "Ag,A,S"
    core_layers: int = 2
    # activation/matmul dtype for the token/perceiver/head stack. bfloat16 is
    # the default (tensor-core rate); float32 exists for numerics tests — the
    # single-vs-multi-device gradient-equivalence test must isolate the
    # collective path from bf16 reduction-order noise (a batch-dim bias-grad
    # reduce over n bf16 terms carries O(n·ulp) error, so a 128-term single
    # -device sum and four 32-term shard sums legitimately differ by ~3% when
    # the sum nearly cancels).
    compute_dtype: str = "bfloat16"
    # >0: the critic head outputs this many quantiles (value = their mean);
    # required by the quantile_ppo_critic loss (reference quantile archs).
    num_quantiles: int = 0
    # observation encoder: "perceiver" (default) or "swin" (windowed
    # attention over a patch grid — components/swin_encoder.py parity).
    encoder: str = "perceiver"
    swin_window: int = 2
    swin_patch: int = 4
    swin_depth: int = 2
    obs_height: int = 11
    obs_width: int = 11
    # actor head: "dense" (default MLP+Dense) or "query_key" (tanh-query ·
    # action-embedding attention head — components/actor.py:17-105 parity).
    actor_head: str = "dense"
    actor_embed_dim: int = 16
    # add a future-latent prediction head from the core (reference
    # ``future_latent_pred`` component, used by the future_latent_ema loss).
    predict_future: bool = False
    name: str = "vit"

    def make(self, n_actions: int, feature_norms: dict) -> "ViTPolicy":
        return ViTPolicy(cfg=self, n_actions=n_actions,
                         feature_norms=tuple(sorted(feature_norms.items())))

    def stack_spec(self) -> Optional[StackSpec]:
        if self.core == "lstm":
            return None
        return StackSpec(d_hidden=self.latent_dim, num_layers=self.core_layers,
                         pattern=self.core)


class ViTPolicy(nn.Module):
    """Single-step policy network. Call semantics:

    ``(obs [B, T, 3] uint8, state) -> (logits [B, n_actions], value [B],
    h_value [B], new_state)``

    Recurrent state handling follows the reference's rollout/training split
    (``metta/rl/utils.py:79-98``): the trainer zeroes state per segment.
    """

    cfg: ViTConfig
    n_actions: int
    feature_norms: tuple

    # the learner may forward a whole [T, B, K, 3] segment in one apply
    # (token embed / perceiver / heads batch over T·B in large matmuls; the core
    # runs its sequence mode — chunkwise-parallel for mLSTM cells)
    supports_sequence = True

    def initial_state(self, batch: int):
        spec = self.cfg.stack_spec()
        if spec is not None:
            return spec.initial_state(batch)
        return (
            jnp.zeros((batch, self.cfg.latent_dim), jnp.float32),
            jnp.zeros((batch, self.cfg.latent_dim), jnp.float32),
        )

    @nn.compact
    def __call__(self, obs, state):
        c = self.cfg
        dtype = jnp.dtype(c.compute_dtype)
        seq = obs.ndim == 4                        # [T, B, K, 3] segment
        if seq:
            T, B = obs.shape[0], obs.shape[1]
            obs = obs.reshape(T * B, *obs.shape[2:])
        tokens, mask = TokenEmbed(
            attr_embed_dim=c.token_embed_dim,
            num_freqs=c.fourier_freqs,
            max_tokens=c.max_tokens,
            feature_norms=self.feature_norms,
            dtype=dtype,
            name="token_embed",
        )(obs)
        if c.encoder == "swin":
            from metta_tpu.models.swin import SwinEncoder

            latent = SwinEncoder(
                out_dim=c.latent_dim, embed_dim=c.latent_dim,
                depth=c.swin_depth, num_heads=c.core_num_heads,
                window_size=c.swin_window, patch_size=c.swin_patch,
                obs_height=c.obs_height, obs_width=c.obs_width,
                dtype=dtype, name="swin",
            )(tokens, mask, obs[:, : c.max_tokens, 0])
        else:
            latent = PerceiverLatent(
                latent_dim=c.latent_dim,
                num_latents=c.core_num_latents,
                num_heads=c.core_num_heads,
                dtype=dtype,
                name="perceiver",
            )(tokens, mask)
        if seq:
            latent = latent.reshape(T, B, latent.shape[-1])
        spec = c.stack_spec()
        if spec is not None:
            core_out, new_state = CortexStack(spec=spec, name="core")(
                latent.astype(jnp.float32), state)
        else:
            core_out, new_state = LSTMCore(hidden=c.latent_dim, name="core")(latent, state)
        x = core_out.astype(dtype)
        # Intermediates for auxiliary losses (reference TensorDict keys
        # obs_latent_attn / core / future_latent_pred); sow is a no-op unless
        # apply() requests mutable=["intermediates"].
        self.sow("intermediates", "latent_out", latent.astype(jnp.float32))
        self.sow("intermediates", "core_out", core_out.astype(jnp.float32))
        if c.predict_future:
            fut = MLP(hidden=(c.latent_dim,), out=c.latent_dim, dtype=dtype,
                      name="future_head")(x)
            self.sow("intermediates", "future_latent_pred", fut.astype(jnp.float32))
        actor_h = MLP(hidden=(c.actor_hidden,), out=c.actor_hidden, dtype=dtype,
                      name="actor_mlp")(x)
        if c.actor_head == "query_key":
            from metta_tpu.models.swin import ActorQueryKey

            logits = ActorQueryKey(
                n_actions=self.n_actions, embed_dim=c.actor_embed_dim,
                dtype=jnp.float32, name="actor_qk",
            )(nn.relu(actor_h).astype(jnp.float32))
        else:
            logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="actor_head")(
                nn.relu(actor_h).astype(dtype)
            )
        if c.num_quantiles > 0:
            value_q = MLP(hidden=(c.critic_hidden,), out=c.num_quantiles,
                          dtype=dtype, name="critic")(x)
            self.sow("intermediates", "value_q", value_q)
            value = jnp.mean(value_q, axis=-1)
        else:
            value = MLP(hidden=(c.critic_hidden,), out=1, dtype=dtype,
                        name="critic")(x)[..., 0]
        h_value = MLP(hidden=(c.critic_hidden,), out=1, dtype=dtype,
                      name="gtd_aux")(x)[..., 0]
        return logits, value, h_value, new_state
