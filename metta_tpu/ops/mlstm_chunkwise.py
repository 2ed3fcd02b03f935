"""Chunkwise-parallel mLSTM sequence kernel.

Parity: reference ``cortex/kernels/pytorch/mlstm.py:89``
``mlstm_chunkwise_simple`` (and the Triton kernels under
``kernels/triton/mlstm/`` it mirrors): instead of a length-S recurrent scan,
the sequence is processed in chunks of CS steps — within-chunk interactions
become causal attention-like einsums (matmul work), and only the NS = S/CS
chunk-boundary states recur. Same stabilized math (running max ``m``,
normalizer ``n``, matrix state ``C``), including reset-mask support for
episode boundaries inside a training segment.

It is plain JAX in place of the reference's Triton kernel: the einsums are
[CS, DH] × [DH, CS]-shaped matmuls that XLA compiles as it likes, and the
boundary recurrence is a length-NS ``lax.scan`` (vs length-S).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp


def mlstm_step(C, n, m, q, k, v, i_pre, f_pre, eps: float = 1e-6):
    """One stabilized recurrent step (kernels/pytorch/mlstm.py:16).

    C [B,NH,DH,DH], n [B,NH,DH], m [B,NH]; q/k/v [B,NH,DH]; gates [B,NH].
    Returns (h [B,NH,DH], (C,n,m)).
    """
    DH = q.shape[-1]
    log_f = jax.nn.log_sigmoid(f_pre)
    m_new = jnp.maximum(log_f + m, i_pre)
    fg = jnp.exp(log_f + m - m_new)
    ig = jnp.exp(i_pre - m_new)
    k_s = k / math.sqrt(DH)
    C_new = fg[..., None, None] * C + ig[..., None, None] * (
        k_s[..., :, None] * v[..., None, :]
    )
    n_new = fg[..., None] * n + ig[..., None] * k_s
    h_num = jnp.einsum("...d,...df->...f", q, C_new)
    qn = jnp.einsum("...d,...d->...", q, n_new)
    denom = jnp.maximum(jnp.abs(qn), jnp.exp(-m_new)) + eps
    return h_num / denom[..., None], (C_new, n_new, m_new)


def mlstm_recurrent(q, k, v, i_pre, f_pre, C0=None, n0=None, m0=None,
                    reset_mask=None, eps: float = 1e-6):
    """Step-by-step reference path (lax.scan over S). Shapes as chunkwise."""
    B, NH, S, DH = q.shape
    C = jnp.zeros((B, NH, DH, DH), q.dtype) if C0 is None else C0
    n = jnp.zeros((B, NH, DH), q.dtype) if n0 is None else n0
    m = jnp.zeros((B, NH), q.dtype) if m0 is None else m0

    def step(carry, xs):
        C, n, m = carry
        q_s, k_s, v_s, i_s, f_s, r_s = xs
        keep = (1.0 - r_s)[:, None]
        C = C * keep[..., None, None]
        n = n * keep[..., None]
        m = m * keep
        h, (C, n, m) = mlstm_step(C, n, m, q_s, k_s, v_s, i_s, f_s, eps)
        return (C, n, m), h

    r = (jnp.zeros((B, S)) if reset_mask is None
         else reset_mask.astype(q.dtype))
    xs = (
        jnp.moveaxis(q, 2, 0), jnp.moveaxis(k, 2, 0), jnp.moveaxis(v, 2, 0),
        jnp.moveaxis(i_pre, 2, 0), jnp.moveaxis(f_pre, 2, 0), r.T,
    )
    (C, n, m), h = jax.lax.scan(step, (C, n, m), xs)
    return jnp.moveaxis(h, 0, 2), (C, n, m)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, C0=None, n0=None, m0=None,
                    reset_mask=None, chunk_size: int = 64,
                    eps: float = 1e-6):
    """Chunkwise-parallel mLSTM (mlstm_chunkwise_simple semantics).

    q/k/v: [B, NH, S, DH]; gates: [B, NH, S]; reset_mask: [B, S] (state is
    zeroed BEFORE processing a masked step). S must be a multiple of
    chunk_size (training segments are; pad otherwise). Returns
    (h [B,NH,S,DH], (C,n,m) final states).
    """
    B, NH, S, DH = q.shape
    CS = min(chunk_size, S)
    assert S % CS == 0, "pad S to a multiple of chunk_size"
    NS = S // CS
    dtype = q.dtype
    NEG = jnp.asarray(-1e30, dtype)

    C0 = jnp.zeros((B, NH, DH, DH), dtype) if C0 is None else C0
    n0 = jnp.zeros((B, NH, DH), dtype) if n0 is None else n0
    m0 = jnp.zeros((B, NH), dtype) if m0 is None else m0

    qc = q.reshape(B, NH, NS, CS, DH)
    kc = k.reshape(B, NH, NS, CS, DH) / math.sqrt(DH)
    vc = v.reshape(B, NH, NS, CS, DH)
    ic = i_pre.reshape(B, NH, NS, CS)
    fc = f_pre.reshape(B, NH, NS, CS)

    log_f = jax.nn.log_sigmoid(fc)                      # [B,NH,NS,CS]
    cum = jnp.cumsum(log_f, axis=-1)
    cum_last = cum[..., -1]                             # [B,NH,NS]

    if reset_mask is not None:
        rm = reset_mask.reshape(B, 1, NS, CS).astype(jnp.int32)
        rm = jnp.broadcast_to(rm, (B, NH, NS, CS))
        prefix_inc = jnp.cumsum(rm, axis=-1)            # resets in [0..t]
        no_reset_prefix = prefix_inc == 0               # inter-chunk survives
        same_segment = prefix_inc[..., :, None] == prefix_inc[..., None, :]
        survive_to_end = (prefix_inc[..., -1:] - prefix_inc) == 0
        # the incoming boundary state survives a chunk only if the chunk has
        # no reset at all (the recurrent path zeroes state at each reset)
        chunk_keep = (prefix_inc[..., -1] == 0)         # [B, NH, NS]
        # Stabilizer chain: the recurrent path restarts its running max m at
        # zero on each reset, so every row t carries a pure-decay candidate
        # cum_t - cum_{t0-1} from the most recent reset t0 <= t. Recover
        # cum_{t0-1} per row with a one-hot over the (unique) reset position
        # that opened the row's segment.
        cum_prev = cum - log_f                          # cum_{t-1}, cum_{-1}=0
        is_reset = rm == 1
        opens = is_reset[..., None, :] & (
            prefix_inc[..., None, :] == prefix_inc[..., :, None]
        ) & (jnp.arange(CS)[None, :] <= jnp.arange(CS)[:, None])
        rst_exists = jnp.any(opens, axis=-1)            # [B,NH,NS,CS]
        rst_base = jnp.sum(jnp.where(opens, cum_prev[..., None, :], 0.0), axis=-1)
        rst_chain = jnp.where(rst_exists, cum - rst_base, NEG)
        chain_end = rst_chain[..., -1]                  # [B,NH,NS]
    else:
        no_reset_prefix = same_segment = survive_to_end = None
        chunk_keep = None
        rst_chain = None
        chain_end = None

    # end-of-chunk aggregation weights (for the boundary state updates)
    lg_full = (ic - cum) + cum_last[..., None]          # [B,NH,NS,CS]
    if survive_to_end is not None:
        lg_full = jnp.where(survive_to_end, lg_full, NEG)
    m_loc = jnp.max(lg_full, axis=-1)                   # [B,NH,NS]
    w = jnp.exp(lg_full - m_loc[..., None])             # [B,NH,NS,CS]
    kv = jnp.einsum("bhnsd,bhnsf->bhndf", kc, vc * w[..., None])
    ksum = jnp.sum(kc * w[..., None], axis=-2)          # [B,NH,NS,DH]

    # boundary recurrence over NS chunks (the only sequential part)
    def boundary(carry, xs):
        C, n, m = carry
        cum_l, m_l, kv_i, ks_i, keep, chain_l = xs      # per-chunk slices
        out = (C, n, m)                                 # state ENTERING chunk
        carry_l = jnp.where(keep, cum_l + m, NEG)
        m_new = jnp.maximum(jnp.maximum(carry_l, m_l), chain_l)
        wC = jnp.exp(carry_l - m_new)
        C_new = (C * wC[..., None, None]
                 + kv_i * jnp.exp(m_l - m_new)[..., None, None])
        n_new = (n * wC[..., None]
                 + ks_i * jnp.exp(m_l - m_new)[..., None])
        return (C_new, n_new, m_new), out

    xs = (
        jnp.moveaxis(cum_last, 2, 0), jnp.moveaxis(m_loc, 2, 0),
        jnp.moveaxis(kv, 2, 0), jnp.moveaxis(ksum, 2, 0),
        (jnp.moveaxis(chunk_keep, 2, 0)
         if chunk_keep is not None else
         jnp.ones((NS, B, NH), bool)),
        (jnp.moveaxis(chain_end, 2, 0)
         if chain_end is not None else
         jnp.full((NS, B, NH), NEG)),
    )
    (C_f, n_f, m_f), entering = jax.lax.scan(boundary, (C0, n0, m0), xs)
    C_prev = jnp.moveaxis(entering[0], 0, 2)            # [B,NH,NS,DH,DH]
    n_prev = jnp.moveaxis(entering[1], 0, 2)            # [B,NH,NS,DH]
    m_prev = jnp.moveaxis(entering[2], 0, 2)            # [B,NH,NS]

    # within-chunk causal matrix + inter-chunk carry
    log_fg = cum[..., :, None] - cum[..., None, :]      # [B,NH,NS,CS,CS]
    tri = jnp.triu(jnp.ones((CS, CS), bool), k=1)
    log_D = jnp.where(tri, NEG, log_fg + ic[..., None, :])
    if same_segment is not None:
        log_D = jnp.where(same_segment, log_D, NEG)
    D_max = jnp.max(log_D, axis=-1)                     # [B,NH,NS,CS]
    carry_log = m_prev[..., None] + cum                 # [B,NH,NS,CS]
    if no_reset_prefix is not None:
        # past-chunk carry is dead once any reset occurred in [0..t]; mask it
        # in log space so the stabilizer matches the recurrent path exactly
        carry_log = jnp.where(no_reset_prefix, carry_log, NEG)
    stab = jnp.maximum(D_max, carry_log)
    if rst_chain is not None:
        stab = jnp.maximum(stab, rst_chain)
    inter_factor = jnp.exp(carry_log - stab)
    inter_C = jnp.einsum(
        "bhnsd,bhndf->bhnsf", qc * inter_factor[..., None], C_prev)
    inter_n = jnp.einsum(
        "bhnsd,bhnd->bhns", qc * inter_factor[..., None], n_prev)

    E = jnp.einsum("bhnsd,bhntd->bhnst", qc, kc) * jnp.exp(
        log_D - stab[..., None])
    normalizer = jnp.maximum(
        jnp.abs(jnp.sum(E, axis=-1) + inter_n), jnp.exp(-stab)) + eps
    h = (jnp.einsum("bhnst,bhntf->bhnsf", E, vc)
         + inter_C) / normalizer[..., None]
    return h.reshape(B, NH, S, DH), (C_f, n_f, m_f)
