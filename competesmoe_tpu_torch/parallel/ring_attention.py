"""Ring attention: attention with the sequence split over the 'seq' axis
of a mesh (port of competesmoe_tpu/parallel/ring_attention.py).

Each rank holds its block [B, T/n, h, p] of q, k and v. The K/V blocks
travel round the ring (`collectives.ring_shift`, JAX's `lax.ppermute`
i -> i+1) for n steps, and every step folds one [B, h, T/n, T/n] block of
scores into the online softmax (JAX's `_online_block`), in float32
whatever the input dtype. The full [T, T] score matrix is never built and
K/V are never gathered: the score memory of a rank is O((T/n)^2).

Causal masking is by global block offset: at step s a rank holds the
block of rank (me - s) mod n, whose keys sit at positions
src * T/n + arange(T/n). A block whose every key is masked leaves the
state as it was: its maximum stays -inf, and a finite stand-in for it
(`m_use`) makes every exp term exactly 0. This is the ring without load
balancing that JAX has: the ranks late in the sequence do the work of
the masked blocks too.

The products are plain torch matmuls, as JAX's are XLA einsums outside
any Pallas kernel; each collective a gradient crosses is an autograd
function, so the backward is the single-device gradient.
"""

from __future__ import annotations

import math

import torch

from . import collectives as C
from .mesh import Mesh

NEG_INF = float("-inf")


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float32 (JAX's preferred_element_type)."""
    from ..models.decoder import _mm_f32 as mm
    return mm(a, b)


def _fold(qs, kb, vb, m, l, o, ok):
    """One online-softmax step over a K/V block. qs [B, h, Tq, p] (scaled),
    kb/vb [B, h, Tk, p], m/l [B, h, Tq] and o [B, h, Tq, p] float32, ok a
    bool mask broadcastable to [B, h, Tq, Tk] (None: all keys). Returns
    the new (m, l, o)."""
    B, h, Tq, p = qs.shape
    Tk = kb.shape[2]
    scores = _mm_f32(qs.reshape(B * h, Tq, p),
                     kb.reshape(B * h, Tk, p).transpose(1, 2)
                     ).view(B, h, Tq, Tk)
    if ok is not None:
        scores = scores.masked_fill(~ok, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a fully masked block leaves m_new at -inf: any finite stand-in
    # makes every exp below exactly 0
    m_use = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                        m_new)
    p_ = torch.exp(scores - m_use[..., None])
    alpha = torch.exp(m - m_use)
    l = l * alpha + p_.sum(dim=-1)
    pv = _mm_f32(p_.to(vb.dtype).reshape(B * h, Tq, Tk),
                 vb.reshape(B * h, Tk, p)).view(B, h, Tq, p)
    o = o * alpha[..., None] + pv
    return m_new, l, o


def _start(q):
    B, Tl, h, p = q.shape
    dev = q.device
    m = torch.full((B, h, Tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, h, Tl), dtype=torch.float32, device=dev)
    o = torch.zeros((B, h, Tl, p), dtype=torch.float32, device=dev)
    return m, l, o


def make_ring_attention(mesh: Mesh, seq_axis: str = "seq",
                        causal: bool = True):
    """fn(q, k, v) -> out, each this rank's block [B, T/n, h, p] of a
    [B, T, h, p] sequence split over `seq_axis` in rank order: exact full
    (causal) attention of the whole sequence, for this rank's queries."""
    axis = mesh.axis(seq_axis)
    n = axis.size

    def ring(q, k, v):
        B, Tl, h, p = q.shape
        me = axis.index
        scale = 1.0 / math.sqrt(p)
        qs = q.transpose(1, 2) * torch.tensor(scale, dtype=q.dtype)
        kb, vb = k.transpose(1, 2), v.transpose(1, 2)
        m, l, o = _start(q)
        loc = torch.arange(Tl, device=q.device)
        qpos = me * Tl + loc
        for s in range(n):
            src = (me - s) % n        # whose K/V block this rank holds
            ok = None
            if causal:
                kpos = src * Tl + loc
                ok = (kpos[None, :] <= qpos[:, None])[None, None]
            m, l, o = _fold(qs, kb, vb, m, l, o, ok)
            if s < n - 1:
                kb = C.ring_shift(kb.contiguous(), axis)
                vb = C.ring_shift(vb.contiguous(), axis)
        out = o / l[..., None]
        return out.to(q.dtype).transpose(1, 2)

    return ring


def make_ring_attention_masked(mesh: Mesh, seq_axis: str = "seq"):
    """Ring attention with per-token positions and validity (the padded
    batch of the multimodal decoder): fn(q, k, v, qpos, kpos, kvalid) ->
    out, q/k/v this rank's [B, T/n, h, p] blocks and qpos/kpos/kvalid its
    [B, T/n] blocks (int, int, bool). A key is attended iff
    `kvalid & (kpos <= qpos)`; kpos and kvalid travel with their K/V
    block. A row whose every key is masked outputs zeros (its sum is
    replaced by a safe 1)."""
    axis = mesh.axis(seq_axis)
    n = axis.size

    def ring(q, k, v, qpos, kpos, kvalid):
        B, Tl, h, p = q.shape
        scale = 1.0 / math.sqrt(p)
        qs = q.transpose(1, 2) * torch.tensor(scale, dtype=q.dtype)
        kb, vb = k.transpose(1, 2), v.transpose(1, 2)
        m, l, o = _start(q)
        qp = qpos.long()
        # kpos and kvalid ride one int64 block round the ring (gloo sends
        # no bool tensors)
        kinfo = torch.stack([kpos.long(), kvalid.long()])
        for s in range(n):
            kp, kv_ok = kinfo[0], kinfo[1].bool()
            ok = kv_ok[:, None, :] & (kp[:, None, :] <= qp[:, :, None])
            m, l, o = _fold(qs, kb, vb, m, l, o, ok[:, None])
            if s < n - 1:
                kb = C.ring_shift(kb.contiguous(), axis)
                vb = C.ring_shift(vb.contiguous(), axis)
                kinfo = C.raw_ring_shift(kinfo, axis)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out = o / l_safe[..., None]
        return out.to(q.dtype).transpose(1, 2)

    return ring
