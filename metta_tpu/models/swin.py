"""Swin-style observation encoder + attention actor head.

Parity: reference ``agent/src/metta/agent/components/swin_encoder.py``
(ObsSwinEncoder: token features scatter-meaned into a patch grid, windowed
self-attention blocks with optional shifted windows, pooled projection) and
``components/actor.py:17-105`` + ``components/action.py`` (ActionEmbedding →
ActorQuery → ActorKey: logits as dot products between a tanh query of the
core output and learned per-action embeddings).

Notes: the reference's ``index_add_`` scatter-mean becomes a one-hot
GEMM (no data-dependent scatters under jit); window partition is pure
reshape/transpose; shifted windows use ``jnp.roll`` + an additive mask that is
a compile-time constant.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from metta_tpu.models import nn


class WindowAttention(nn.Module):
    """MHSA within windows; ``mask`` is additive [nW, N, N] or None."""

    dim: int
    num_heads: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, mask=None):
        # x: [BW, N, C] (windows flattened into batch)
        BW, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = nn.Dense(3 * C, dtype=self.dtype, name="qkv")(x)
        qkv = qkv.reshape(BW, N, 3, H, hd).transpose(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]          # [BW, H, N, hd]
        attn = (q * (hd ** -0.5)) @ k.transpose(0, 1, 3, 2)  # [BW, H, N, N]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(BW // nW, nW, H, N, N) + mask[None, :, None]
            attn = attn.reshape(BW, H, N, N)
        attn = jax.nn.softmax(attn.astype(jnp.float32), axis=-1).astype(x.dtype)
        out = (attn @ v).transpose(0, 2, 1, 3).reshape(BW, N, C)
        return nn.Dense(C, dtype=self.dtype, name="proj")(out)


def _window_partition(x, ws):
    """[B, H, W, C] → [B * nW, ws*ws, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(win, ws, H, W):
    B = win.shape[0] // ((H // ws) * (W // ws))
    x = win.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _shift_mask(H, W, ws, shift) -> np.ndarray:
    """Additive attention mask for shifted windows (compile-time constant;
    reference ``SwinBlock._build_mask``)."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for i in range(0, H, ws):
        for j in range(0, W, ws):
            img[i:i + ws, j:j + ws] = cnt
            cnt += 1
    img = np.roll(img, (-shift, -shift), axis=(0, 1))
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class SwinBlock(nn.Module):
    dim: int
    num_heads: int
    window_size: int
    shift: int
    mlp_ratio: float = 4.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, H, W):
        # x: [B, H*W, C]
        B, N, C = x.shape
        ws = self.window_size
        shortcut = x
        x = nn.LayerNorm(dtype=self.dtype, name="norm1")(x).reshape(B, H, W, C)
        if self.shift > 0:
            x = jnp.roll(x, (-self.shift, -self.shift), axis=(1, 2))
            mask = jnp.asarray(_shift_mask(H, W, ws, self.shift))
        else:
            mask = None
        win = _window_partition(x, ws)
        win = WindowAttention(dim=C, num_heads=self.num_heads,
                              dtype=self.dtype, name="attn")(win, mask)
        x = _window_reverse(win, ws, H, W)
        if self.shift > 0:
            x = jnp.roll(x, (self.shift, self.shift), axis=(1, 2))
        x = shortcut + x.reshape(B, N, C)
        y = nn.LayerNorm(dtype=self.dtype, name="norm2")(x)
        y = nn.Dense(int(C * self.mlp_ratio), dtype=self.dtype, name="mlp_up")(y)
        y = nn.gelu(y)
        y = nn.Dense(C, dtype=self.dtype, name="mlp_down")(y)
        return x + y


class SwinEncoder(nn.Module):
    """Token observations → pooled feature via windowed attention.

    Tokens carry their window coordinates in the packed loc byte; they are
    scatter-MEANED into a ``patch_size``-downsampled grid with one one-hot
    GEMM (``swin_encoder.py:_tokens_to_patches``), then ``depth`` Swin blocks
    alternate plain/shifted windows.
    """

    out_dim: int = 128
    embed_dim: int = 64
    depth: int = 2
    num_heads: int = 4
    window_size: int = 2
    patch_size: int = 4
    obs_height: int = 11
    obs_width: int = 11
    mlp_ratio: float = 4.0
    pool: str = "mean"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, tokens, mask, loc):
        # tokens [B, M, F] embedded features; mask [B, M]; loc [B, M] uint8
        B, M, F = tokens.shape
        py = -(-self.obs_height // self.patch_size)   # ceil
        px = -(-self.obs_width // self.patch_size)
        ws = self.window_size
        # pad the patch grid up to a window multiple so any obs size works
        Hp = -(-py // ws) * ws
        Wp = -(-px // ws) * ws
        P = Hp * Wp

        x = nn.LayerNorm(dtype=self.dtype, name="token_norm")(tokens)
        x = nn.Dense(self.embed_dim, dtype=self.dtype, name="input_proj")(x)

        row = (loc.astype(jnp.int32) >> 4) & 0xF
        col = loc.astype(jnp.int32) & 0xF
        pr = jnp.minimum(row // self.patch_size, py - 1)
        pc = jnp.minimum(col // self.patch_size, px - 1)
        pid = pr * Wp + pc                                   # [B, M]
        # scatter-mean as one one-hot GEMM (index_add_ in the reference)
        oh = ((pid[:, :, None] == jnp.arange(P)[None, None, :])
              & mask[:, :, None]).astype(self.dtype)         # [B, M, P]
        agg = jnp.einsum("bmp,bmd->bpd", oh, x)
        cnt = jnp.maximum(jnp.sum(oh, axis=1), 1.0)[..., None]
        patches = agg / cnt                                  # [B, P, C]

        for i in range(self.depth):
            shift = ws // 2 if (i % 2 == 1 and ws > 1) else 0
            patches = SwinBlock(
                dim=self.embed_dim, num_heads=self.num_heads, window_size=ws,
                shift=shift, mlp_ratio=self.mlp_ratio, dtype=self.dtype,
                name=f"block_{i}",
            )(patches, Hp, Wp)
        patches = nn.LayerNorm(dtype=self.dtype, name="norm")(patches)
        if self.pool == "mean":
            pooled = patches.mean(axis=1)
        elif self.pool == "first":
            pooled = patches[:, 0]
        else:                                                # flatten
            pooled = patches.reshape(B, -1)
        return nn.Dense(self.out_dim, dtype=self.dtype, name="output_proj")(pooled)


class ActorQueryKey(nn.Module):
    """Attention actor head: logits[a] = tanh(h @ W) · E[a] + b.

    Parity: ``components/actor.py`` ActorQuery (tanh bilinear query) +
    ActorKey (dot-product scores with scalar bias) over ``action.py``
    ActionEmbedding rows (kept trainable, one per flattened action).
    """

    n_actions: int
    embed_dim: int = 16
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, h):
        # h: [B, H]
        Hd = h.shape[-1]
        W = self.param(
            "W", nn.initializers.uniform(scale=2.0 / np.sqrt(Hd)),
            (Hd, self.embed_dim),
        )
        query = jnp.tanh(h.astype(self.dtype) @ W.astype(self.dtype))
        emb = nn.Embed(self.n_actions, self.embed_dim, name="action_embed",
                       dtype=self.dtype)(jnp.arange(self.n_actions))
        bias = self.param("bias", nn.initializers.zeros, (1,))
        logits = query @ emb.T + bias
        return logits.astype(jnp.float32)
