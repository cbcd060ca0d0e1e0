"""Causal flash attention, forward and backward (kernel K2 of the port).

Replaces the Pallas TPU flash attention that JAX's `FastRopeAttention`
calls with attn_backend='flash' (`jax.experimental.pallas.ops.tpu.
flash_attention`: `_flash_attention_impl`, `_flash_attention_bwd_dkv`,
`_flash_attention_bwd_dq`). Layout [B, h, T, p], causal, with
`sm_scale = 1/sqrt(p)` by default.

Three wrappers, one per kernel of `csrc/flash_attn.cu` (built by
`_kernels.py`), each with its own launch count:

  flash_attention_fwd      (q, k, v)                  -> (o, lse)
  flash_attention_bwd_dkv  (q, k, v, do, lse, delta)  -> (dk, dv)
  flash_attention_bwd_dq   (q, k, v, do, lse, delta)  -> dq

where lse is the row log-sum-exp of the scaled, masked scores and
delta = rowsum(do * o) (plain PyTorch, as the TPU backward computes it
outside its kernels). CUDA tensors (bf16) go to the kernels; CPU tensors
take the plain versions below, which compute the same functions in
float32. `flash_attention` is the differentiable entry point.
`_fwd_tiled_model` and `_bwd_tiled_model` repeat the kernels' arithmetic
tile by tile (their rounding and masking plans) for the CPU tests.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _kernels


def _causal_scores(q, k, sm_scale):
    """float32 scaled scores with the positions above the diagonal at
    -inf."""
    T = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def flash_attention_fwd_reference(q, k, v, sm_scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: softmax in float32, the probabilities rounded to
    v's dtype before the product (as the einsum path rounds them), the
    product summed in float32. Returns (o in q's dtype, lse float32)."""
    s = _causal_scores(q, k, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(q.dtype)
    return o, lse


def _bwd_reference(q, k, v, do, lse, delta, sm_scale):
    """Plain backward from the saved lse, in float32:
    P = exp(S - lse), dV = P^T dO, dS = P * (dO V^T - delta) * scale,
    dQ = dS K, dK = dS^T Q."""
    p = torch.exp(_causal_scores(q, k, sm_scale) - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq, dk, dv


def _bwd_tiled_model(q, k, v, do, lse, delta, sm_scale, tile: int = 64):
    """The backward kernels' arithmetic in plain PyTorch, tile by tile
    (for tests; no wrapper takes it). As `csrc/flash_attn.cu` does it:
    rows padded with zeros to whole tiles of 64; dK/dV per key tile from
    the transposed scores S^T = K Q^T and dP^T = V dO^T over the query
    tiles at and below the diagonal, dQ per query tile over the key tiles
    up to it; P = 2^(S scale log2e - lse log2e); the causal comparison
    only on a diagonal tile or a last tile with rows beyond T; P and dS
    rounded to the inputs' dtype before dV += P^T dO, dK += dS^T Q and
    dQ += dS K; float32 sums in tile order; results rounded to the
    inputs' dtype. Returns (dq, dk, dv)."""
    T = q.shape[-2]
    nt = -(-T // tile)
    pad = nt * tile - T
    qf, kf, vf, dof = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                       for t in (q, k, v, do))
    lse2 = torch.nn.functional.pad(lse.float(), (0, pad)) * math.log2(math.e)
    dl = torch.nn.functional.pad(delta.float(), (0, pad))
    scale_log2 = sm_scale * math.log2(math.e)
    pos = torch.arange(nt * tile, device=q.device)

    def rows(t, i):
        return t[..., i * tile:(i + 1) * tile, :]

    def stats(t, i):
        return t[..., i * tile:(i + 1) * tile]

    def attends(kt, it):
        """[keys, queries] of key tile kt and query tile it."""
        kv, qi = stats(pos, kt)[:, None], stats(pos, it)[None, :]
        return (kv <= qi) & (qi < T) & (kv < T)

    def rounded(t):
        return t.to(q.dtype).float()

    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for kt in range(nt):                       # the dK/dV kernel's blocks
        for it in range(kt, nt):
            st = rows(kf, kt) @ rows(qf, it).transpose(-1, -2)
            dpt = rows(vf, kt) @ rows(dof, it).transpose(-1, -2)
            pt = torch.exp2(st * scale_log2 - stats(lse2, it)[..., None, :])
            dst = pt * (dpt - stats(dl, it)[..., None, :]) * sm_scale
            if it == kt or (it + 1) * tile > T:
                keep = attends(kt, it)
                pt, dst = pt.where(keep, 0.0), dst.where(keep, 0.0)
            rows(dv, kt).add_(rounded(pt) @ rows(dof, it))
            rows(dk, kt).add_(rounded(dst) @ rows(qf, it))
    for it in range(nt):                       # the dQ kernel's blocks
        for j in range(it + 1):
            s = rows(qf, it) @ rows(kf, j).transpose(-1, -2)
            dp = rows(dof, it) @ rows(vf, j).transpose(-1, -2)
            pv = torch.exp2(s * scale_log2 - stats(lse2, it)[..., None])
            ds = pv * (dp - stats(dl, it)[..., None]) * sm_scale
            if j == it:
                ds = ds.where(attends(j, it).transpose(-1, -2), 0.0)
            rows(dq, it).add_(rounded(ds) @ rows(kf, j))
    return tuple(t[..., :T, :].to(q.dtype) for t in (dq, dk, dv))


def _fwd_tiled_model(q, k, v, sm_scale, tile: int = 64):
    """The forward kernel's arithmetic in plain PyTorch, tile by tile (for
    tests; no wrapper takes it). As `csrc/flash_attn.cu` does it: rows
    padded with zeros to whole tiles of 64; per query tile, the key tiles
    up to the diagonal in order; S = Q K^T in float32; the causal
    comparison only on the diagonal tile (in the forward the only tile
    that can be ragged as well), masked scores -inf; an online softmax in
    base 2: the running max m of S scale log2e per row (a row with no key
    yet subtracts 0), alpha = 2^(m_old - m_new), P = 2^(S scale log2e -
    m_new), l = l alpha + rowsum(P), O = O alpha + bf16(P) V summed in
    float32; at the end o = O / l rounded to the inputs' dtype and the
    natural-log lse = (m + log2 l) ln 2. Returns (o, lse float32)."""
    T = q.shape[-2]
    nt = -(-T // tile)
    pad = nt * tile - T
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                  for t in (q, k, v))
    scale_log2 = sm_scale * math.log2(math.e)
    pos = torch.arange(nt * tile, device=q.device)
    o = torch.zeros_like(qf)
    lse = torch.zeros(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for it in range(nt):                       # the forward kernel's blocks
        rows = slice(it * tile, (it + 1) * tile)
        m = torch.full(qf.shape[:-2] + (tile,), -math.inf,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf[..., rows, :])
        for j in range(it + 1):
            cols = slice(j * tile, (j + 1) * tile)
            s = qf[..., rows, :] @ kf[..., cols, :].transpose(-1, -2)
            if j == it:
                qi, kv = pos[rows][:, None], pos[cols][None, :]
                s = s.where((kv <= qi) & (qi < T) & (kv < T), -math.inf)
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            mu = m_new.where(m_new > -math.inf, 0.0)
            alpha = torch.exp2(m - mu)
            pv = torch.exp2(s * scale_log2 - mu[..., None])
            l = l * alpha + pv.sum(-1)
            acc = acc * alpha[..., None] + (
                pv.to(v.dtype).float() @ vf[..., cols, :])
            m = m_new
        o[..., rows, :] = acc / l[..., None]
        lse[..., rows] = (m + torch.log2(l)) * math.log(2.0)
    return o[..., :T, :].to(q.dtype), lse[..., :T]


def rowsum_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o) in float32, [B, h, T]: plain PyTorch, as the
    TPU backward computes it outside its kernels."""
    return (do.float() * o.float()).sum(-1)


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, f, p]
    lib.flash_bwd_dkv_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f,
                                         p]
    lib.flash_bwd_dq_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, f, p]
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch,
               lib.flash_bwd_dq_launch):
        fn.restype = ctypes.c_int


def _check(tensors, rows=()):
    """CUDA operands: bf16 [B, h, T, p] of one shape (p <= 128) and
    float32 [B, h, T] rows, all contiguous on one device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (*tensors, *rows)):
        raise ValueError("flash attention operands must share one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in tensors) or any(
            r.dtype != torch.float32 for r in rows):
        raise TypeError(f"expected bf16 q/k/v/do and f32 lse/delta; got "
                        f"{[t.dtype for t in (*tensors, *rows)]}")
    shape = tensors[0].shape
    if len(shape) != 4 or shape[-1] > 128 or any(
            t.shape != shape for t in tensors) or any(
            r.shape != shape[:3] for r in rows):
        raise ValueError(f"expected [B, h, T, p] operands with p <= 128 "
                         f"and [B, h, T] rows; got "
                         f"{[tuple(t.shape) for t in (*tensors, *rows)]}")
    if not all(t.is_contiguous() for t in (*tensors, *rows)):
        raise ValueError("flash attention operands must be contiguous")
    B, h, T, p = shape
    return dev, B * h, T, p


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, h, T, p], lse [B, h, T] float32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, sm_scale)
    dev, bh, T, p = _check((q, k, v))
    lib = _kernels.load("flash_attn", _bind)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    rc = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), lse.data_ptr(), bh, T, p,
                              float(sm_scale),
                              torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, "flash attention forward")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in q's dtype."""
    if q.device.type == "cpu":
        _, dk, dv = _bwd_reference(q, k, v, do, lse, delta, sm_scale)
        return dk.to(k.dtype), dv.to(v.dtype)
    dev, bh, T, p = _check((q, k, v, do), (lse, delta))
    lib = _kernels.load("flash_attn", _bind)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = lib.flash_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        T, p, float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, "flash attention dK/dV")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, sm_scale: float
                           ) -> torch.Tensor:
    """dq in q's dtype."""
    if q.device.type == "cpu":
        dq, _, _ = _bwd_reference(q, k, v, do, lse, delta, sm_scale)
        return dq.to(q.dtype)
    dev, bh, T, p = _check((q, k, v, do), (lse, delta))
    lib = _kernels.load("flash_attn", _bind)
    dq = torch.empty_like(q)
    rc = lib.flash_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, T, p,
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, "flash attention dQ")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = rowsum_delta(do, o)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         ctx.sm_scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable causal attention on [B, h, T, p]."""
    if not causal:
        raise NotImplementedError("only causal flash attention is ported "
                                  "(the LM's only use)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), sm_scale)
