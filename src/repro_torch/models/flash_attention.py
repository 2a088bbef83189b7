"""Memory-efficient (flash-style) attention in plain PyTorch with its own
backward, the reference's ``models/flash_attention.py`` op for op.

  forward : an online softmax over key blocks; saves only (out, logsumexp),
            O(B·Sq·H·D), never the [Sq, Sk] scores
  backward: recomputes each block's scores and accumulates dq, and dk / dv
            per block (the FlashAttention-1 recurrence)

The block loop is Python over ``block_k``-wide key blocks; each block's
products are ``torch.einsum`` in fp32, whatever the input dtype, as in the
reference. Masked scores are ``NEG = -1e30``, not ``-inf``: a query row
whose first key blocks are all masked (a sliding window past them) sums
``exp(0) = 1`` there, and ``exp(NEG - m)`` = 0 wipes that at its first
block with a valid key, where ``-inf`` would give NaN.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _mask(q_pos, k_pos, causal, window, k_valid):
    """[B, 1, Sq, Sk] bool: key j visible to query i."""
    m = torch.ones((q_pos.shape[0], 1, q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    pq = q_pos[:, None, :, None]
    pk = k_pos[:, None, None, :]
    if causal:
        m &= pk <= pq
    if window is not None:
        m &= (pq - pk) < window
    if k_valid is not None:
        m &= k_valid[:, None, None, :]
    return m


def _blocks(x, bk, axis=1):
    """x split into ceil(S / bk) blocks of ``bk`` along ``axis``, the tail
    zero-padded (False for bool), stacked on a new leading axis."""
    S = x.shape[axis]
    nb = -(-S // bk)
    pad = nb * bk - S
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)
    return torch.movedim(x.reshape(x.shape[:axis] + (nb, bk) + x.shape[axis + 1:]), axis, 0)


def _flash_fwd_inner(q, k, v, q_pos, k_pos, k_valid, causal, window, scale, block_k):
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    sc = scale or 1.0 / math.sqrt(D)
    q32 = (q.to(torch.float32) * sc).permute(0, 2, 1, 3)        # [B,H,Sq,D]
    kb = _blocks(k.to(torch.float32), block_k)                  # [nb,B,bk,H,D]
    vb = _blocks(v.to(torch.float32), block_k)
    pkb = _blocks(k_pos, block_k)                               # [nb,B,bk]
    valid_b = _blocks(k_valid if k_valid is not None else
                      torch.ones(k.shape[:2], dtype=torch.bool, device=k.device), block_k)
    m = torch.full((B, H, Sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    for k_j, v_j, pk_j, ok_j in zip(kb, vb, pkb, valid_b):
        s = torch.einsum("bhqd,bjhd->bhqj", q32, k_j)           # [B,H,Sq,bk]
        s = torch.where(_mask(q_pos, pk_j, causal, window, ok_j), s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqj,bjhd->bhqd", p, v_j)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    lse = m + torch.log(l_safe)                                 # [B,H,Sq]
    return out, lse


def _unblocks(xb, S):
    """[nb, B, bk, ...] -> [B, S, ...] (the padded tail dropped)."""
    nb, B, bk = xb.shape[:3]
    return torch.movedim(xb, 0, 1).reshape(B, nb * bk, *xb.shape[3:])[:, :S]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, scale, block_k):
        out, lse = _flash_fwd_inner(q, k, v, q_pos, k_pos, None, causal, window,
                                    scale, block_k)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.opts = (causal, window, scale, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        causal, window, scale, block_k = ctx.opts
        D = q.shape[-1]
        sc = scale or 1.0 / math.sqrt(D)
        q32 = (q.to(torch.float32) * sc).permute(0, 2, 1, 3)     # [B,H,Sq,D]
        do = dout.to(torch.float32).permute(0, 2, 1, 3)         # [B,H,Sq,Dv]
        o32 = out.to(torch.float32).permute(0, 2, 1, 3)
        delta = torch.sum(do * o32, dim=-1)                     # [B,H,Sq]
        kb = _blocks(k.to(torch.float32), block_k)
        vb = _blocks(v.to(torch.float32), block_k)
        pkb = _blocks(k_pos, block_k)
        # as the reference's: the padded tail is masked, nothing else
        valid_b = _blocks(torch.ones(k.shape[:2], dtype=torch.bool, device=k.device), block_k)
        dq = torch.zeros_like(q32)
        dkb, dvb = [], []
        for k_j, v_j, pk_j, ok_j in zip(kb, vb, pkb, valid_b):
            s = torch.einsum("bhqd,bjhd->bhqj", q32, k_j)
            s = torch.where(_mask(q_pos, pk_j, causal, window, ok_j), s, NEG)
            p = torch.exp(s - lse[..., None])                   # [B,H,Sq,bk]
            dp = torch.einsum("bhqd,bjhd->bhqj", do, v_j)
            ds = p * (dp - delta[..., None])
            dvb.append(torch.einsum("bhqj,bhqd->bjhd", p, do))
            dkb.append(torch.einsum("bhqj,bhqd->bjhd", ds, q32))
            dq = dq + torch.einsum("bhqj,bjhd->bhqd", ds, k_j)
        dq = (dq * sc).permute(0, 2, 1, 3).to(q.dtype)
        dk = _unblocks(torch.stack(dkb), k.shape[1]).to(k.dtype)
        dv = _unblocks(torch.stack(dvb), v.shape[1]).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=None, scale=None,
                    block_k=512):
    """q: [B,Sq,H,D]; k/v: [B,Skv,H,Dk/Dv] (callers pre-repeat GQA KV).
    Returns [B,Sq,H,Dv]; differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window, scale, block_k)


def flash_sdpa(q, k, v, q_pos, k_pos, *, n_heads, causal=True, window=None,
               scale=None, block_k=512):
    """GQA front end: repeat KV to full heads (head h reads KV head
    h // g), then stream blocks."""
    g = n_heads // k.shape[2]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    return flash_attention(q, k, v, q_pos, k_pos, causal, window, scale, block_k)
