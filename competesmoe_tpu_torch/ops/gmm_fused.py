"""Fused grouped ReLU double GEMM for the MoE FFN (port of
competesmoe_tpu/ops/gmm_fused.py, kernel K1).

The slots of a top-k selection are sorted by expert and each expert's
group is padded to a multiple of TILE rows (`aligned_layout_full`), so
every
256-row tile belongs to one expert, `tile_expert[t]`. The kernel then
computes `relu(xs @ keys[e]) @ values[e]` tile by tile with the hidden
activation kept on chip; the combine gathers each slot's row back and
sums the k rows of a token with their routing weights.

`gmm2_fused_aligned` launches the Hopper kernel of `csrc/gmm2_fused.cu`
for CUDA tensors (built by `_kernels.py`; the f32 weights are rounded to
bf16 once per call, inside the wrapper) and runs its plain PyTorch
version, `gmm2_fused_aligned_reference`, for CPU tensors.
`fused_grouped_ffn_kv` is the differentiable pipeline. JAX's backward is
XLA's ragged_dot VJP (no Pallas backward exists); its contract (bf16
products with float32 accumulation, the weight gradients rounded to bf16
once) is `fused_grouped_ffn_kv_bwd_reference`, which the CPU runs. On
the card the backward launches the two kernels of `csrc/gmm2_bwd.cu`
(`gmm2_bwd_dx`, `gmm2_bwd_dw`) over the forward's layout and bf16
weights.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .. import _kernels

TILE = 256


def gmm2_fused_aligned_reference(xs: torch.Tensor, keys: torch.Tensor,
                                 values: torch.Tensor,
                                 tile_expert: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: per tile, h = relu(xs @ keys[e]) in
    float32 (xs promoted to the weights' type, as the TPU kernel's dot
    promotes), rounded to xs's dtype, then h @ values[e] in float32,
    stored in xs's dtype."""
    S, D = xs.shape
    e = tile_expert.long()
    x3 = xs.reshape(S // TILE, TILE, D).float()
    h = torch.relu(torch.bmm(x3, keys[e].float())).to(xs.dtype)
    o = torch.bmm(h.float(), values[e].float())
    return o.reshape(S, -1).to(xs.dtype)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm2_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.gmm2_launch.restype = ctypes.c_int


def gmm2_fused_aligned(xs: torch.Tensor, keys: torch.Tensor,
                       values: torch.Tensor,
                       tile_expert: torch.Tensor) -> torch.Tensor:
    """relu double GEMM over expert-aligned rows.

    xs: [S', D] with rows [t*TILE, (t+1)*TILE) all belonging to expert
    tile_expert[t]; keys: [E, D, ES]; values: [E, ES, D]; tile_expert:
    [S'/TILE] int32. Returns [S', D] in xs's dtype. On CUDA: bf16 xs,
    float32 keys/values, D and ES multiples of 128, ES <= 512; the
    kernel reads the weights rounded to bf16 (nearest even), cast here
    once per call."""
    if xs.device.type == "cpu":
        return gmm2_fused_aligned_reference(xs, keys, values, tile_expert)
    _check_k1(xs, keys, values, tile_expert)
    return _gmm2_launch(xs, keys.to(torch.bfloat16),
                        values.to(torch.bfloat16), tile_expert)


gmm2_fused_aligned.launches = 0


def _check_k1(xs, keys, values, tile_expert) -> None:
    """Raise unless K1 takes these operands (`gmm2_fused_aligned`)."""
    if xs.device.type != "cuda" or any(
            t.device != xs.device for t in (keys, values, tile_expert)):
        raise ValueError("xs, keys, values and tile_expert must share one "
                         "CUDA device")
    if (xs.dtype != torch.bfloat16 or keys.dtype != torch.float32
            or values.dtype != torch.float32
            or tile_expert.dtype != torch.int32):
        raise TypeError(f"expected bf16 xs, f32 keys/values, int32 "
                        f"tile_expert; got {xs.dtype}, {keys.dtype}, "
                        f"{values.dtype}, {tile_expert.dtype}")
    if xs.dim() != 2 or keys.dim() != 3 or values.dim() != 3:
        raise ValueError("expected xs [S, D], keys [E, D, ES], values "
                         "[E, ES, D]")
    S, D = xs.shape
    E, _, ES = keys.shape
    if (keys.shape[1] != D or tuple(values.shape) != (E, ES, D)
            or tuple(tile_expert.shape) != (S // TILE,) or S % TILE
            or D % 128 or ES % 128 or ES > 512):
        raise ValueError(f"bad shapes xs {tuple(xs.shape)}, keys "
                         f"{tuple(keys.shape)}, values "
                         f"{tuple(values.shape)}, tile_expert "
                         f"{tuple(tile_expert.shape)}")
    if not all(t.is_contiguous() for t in (xs, keys, values, tile_expert)) \
            or any(t.data_ptr() % 16 for t in (xs, keys, values)):
        raise ValueError("xs, keys, values and tile_expert must be "
                         "contiguous and 16-byte aligned")


def _gmm2_launch(xs, keys16, values16, tile_expert):
    """The kernel on operands `gmm2_fused_aligned` has checked, the
    weights already rounded to bf16; counts the launch."""
    S, D = xs.shape
    E, _, ES = keys16.shape
    lib = _kernels.load("gmm2_fused", _bind)
    out = torch.empty_like(xs)
    rc = lib.gmm2_launch(xs.data_ptr(), keys16.data_ptr(),
                         values16.data_ptr(), tile_expert.data_ptr(),
                         out.data_ptr(), S, D, ES, E,
                         torch.cuda.current_stream(xs.device).cuda_stream)
    _kernels.check(rc, "gmm2 fused")
    gmm2_fused_aligned.launches += 1
    return out


@dataclasses.dataclass(frozen=True)
class AlignedLayout:
    """Group-aligned dispatch metadata (JAX `_aligned_layout`), with the
    arrays K1's backward reads as well.

    gs:          the sorted dispatch (`expert_compute.GroupedSel`)
    tok_padded:  [S'] token row feeding padded slot p (an arbitrary valid
                 row on padding positions, never read back)
    tile_expert: [S'/TILE] int32, the expert of each 256-row tile
    shift:       [E] padded position - sorted position of expert e's rows
    and, int32 for the backward kernels:
    slot_padded: [S'] the flat top-k slot of padded row p (tok_padded =
                 slot_padded // k; an arbitrary valid slot on padding rows)
    aoff:        [E+1] aligned start of each expert's rows (aoff[E] is the
                 aligned total)
    gsize:       [E] each expert's rows (the group sizes)
    """

    gs: "object"
    tok_padded: torch.Tensor
    tile_expert: torch.Tensor
    shift: torch.Tensor
    slot_padded: torch.Tensor
    aoff: torch.Tensor
    gsize: torch.Tensor


def aligned_layout_full(sel: torch.Tensor, n_experts: int) -> AlignedLayout:
    """The aligned layout of a top-k selection `sel` [T, k]. S' = a
    TILE-aligned static bound on the padded slot count; the per-group
    rolls of JAX's layout are one gather here,
    s_ext[(p - shift[e_of_p[p]]) mod S']. No host synchronisation."""
    from .expert_compute import sort_by_expert

    S = sel.numel()
    k = sel.shape[-1]
    dev = sel.device
    gs = sort_by_expert(sel, n_experts)
    sizes = gs.group_sizes.to(torch.int64)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    bounds = torch.cat([zero, torch.cumsum(sizes, 0)])
    aligned = (sizes + TILE - 1) // TILE * TILE
    aoff = torch.cat([zero, torch.cumsum(aligned, 0)])
    s_pad = (S + TILE - 1) // TILE * TILE + n_experts * TILE
    shift = aoff[:n_experts] - bounds[:n_experts]
    # expert of every padded position: +1 at each group start
    steps = torch.zeros(s_pad, dtype=torch.int64, device=dev)
    steps.index_add_(0, aoff[1:n_experts],
                     torch.ones(n_experts - 1, dtype=torch.int64,
                                device=dev))
    e_of_p = torch.cumsum(steps, 0)
    tile_expert = e_of_p.reshape(-1, TILE)[:, 0].to(torch.int32)
    s_ext = torch.zeros(s_pad, dtype=torch.int64, device=dev)
    s_ext[:S] = gs.perm
    pos = torch.arange(s_pad, device=dev)
    slot_padded = s_ext[(pos - shift[e_of_p]) % s_pad]
    i32 = torch.int32
    return AlignedLayout(gs=gs, tok_padded=slot_padded // k,
                         tile_expert=tile_expert, shift=shift,
                         slot_padded=slot_padded.to(i32), aoff=aoff.to(i32),
                         gsize=sizes.to(i32))


def _forward(x, sel, weights, keys, values):
    """Aligned gather -> K1 -> combine: (out [T, D], the layout, the
    slots' expert outputs [T, k, D], the weights K1 read)."""
    T, D = x.shape
    k = sel.shape[-1]
    lay = aligned_layout_full(sel, keys.shape[0])
    xs = x[lay.tok_padded]
    if x.device.type == "cuda":
        _check_k1(xs, keys, values, lay.tile_expert)
        # rounded to bf16 once, here; the backward reads the same copies
        keys, values = keys.to(torch.bfloat16), values.to(torch.bfloat16)
        o = _gmm2_launch(xs, keys, values, lay.tile_expert)
    else:
        o = gmm2_fused_aligned_reference(xs, keys, values, lay.tile_expert)
    # flat slot j sits at padded position inv_perm[j] + shift[sel[j]]
    idx = lay.gs.inv_perm + lay.shift[sel.reshape(-1).long()]
    gathered = o[idx].reshape(T, k, -1)
    out = torch.einsum("tkv,tk->tv", gathered.float(),
                       weights.to(o.dtype).float())
    return out.to(x.dtype), lay, gathered, keys, values


def fused_grouped_ffn_kv_fwd(x: torch.Tensor, sel: torch.Tensor,
                             weights: torch.Tensor, keys: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """Aligned gather -> K1 -> combine: the contract of
    `expert_compute.grouped_ffn_kv` with relu experts. x: [T, D];
    sel/weights: [T, k] -> [T, D] in x's dtype."""
    return _forward(x, sel, weights, keys, values)[0]


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def fused_grouped_ffn_kv_bwd_reference(x, sel, weights, keys, values, g):
    """K1's backward in plain PyTorch, step for step the jaxpr of JAX's
    `jax.vjp` of `grouped_ffn_kv` (XLA's ragged_dot VJP; JAX's K1 takes it,
    competesmoe_tpu/ops/gmm_fused.py:223-237). With dt = x.dtype (bf16 in
    training):

      do       = dt(g * dt(w))               the slot gradient
      h        = dt(xs @ keys[e])            (the forward's, recomputed)
      dh       = dt(do @ values[e]^T) where h > 0, else 0
      dxs      = dt(dh @ keys[e]^T)
      dkeys[e] = dt(xs^T dh), dvalues[e] = dt(relu(h)^T do), both summed
                 in float32 over the whole group, rounded once and returned
                 in the weights' dtype (an expert with no rows: zeros)
      dx       = each token's k rows of dxs added in dt one at a time, in
                 sorted order (`token_sum`: JAX's bf16 scatter-add)
      dweights = dt(<o_slot, g>) in the weights' dtype, o = dt(relu(h) @
                 values[e]) the forward's expert output

    Every product takes its operands in dt, the f32 keys and values
    rounded to dt as XLA's ragged_dot rounds them against a bf16 x, and
    accumulates in float32 (so the kernels, which read the forward's bf16
    copies, compute the same function). Returns (dx, dweights, dkeys,
    dvalues)."""
    from .expert_compute import sort_by_expert

    T, k = sel.shape
    dt = x.dtype
    gs = sort_by_expert(sel, keys.shape[0])
    xs = x[gs.token_ids]
    gf = g.float()
    do = (gf[:, None, :] * weights.to(dt).float()[..., None]).to(dt)
    do = do.reshape(T * k, -1)[gs.perm]
    o = torch.empty(T * k, values.shape[-1], dtype=dt, device=x.device)
    dxs = torch.empty(T * k, x.shape[-1], dtype=dt, device=x.device)
    dkeys, dvalues = torch.zeros_like(keys), torch.zeros_like(values)
    start = 0
    for e, n in enumerate(gs.group_sizes.tolist()):
        if n:
            r = slice(start, start + n)
            ke, ve = keys[e].to(dt).float(), values[e].to(dt).float()
            h = (xs[r].float() @ ke).to(dt)
            a = torch.relu(h).float()
            o[r] = (a @ ve).to(dt)
            dh = (do[r].float() @ ve.t()).to(dt)
            dh = torch.where(h > 0, dh, torch.zeros_like(dh)).float()
            dvalues[e] = (a.t() @ do[r].float()).to(dt)
            dkeys[e] = (xs[r].float().t() @ dh).to(dt)
            dxs[r] = (dh @ ke.t()).to(dt)
        start += n
    o_slot = o[gs.inv_perm].reshape(T, k, -1)
    dweights = torch.einsum("tkv,tv->tk", o_slot.float(), gf).to(dt)
    dx = token_sum(dxs, gs.inv_perm.reshape(T, k))
    return dx, dweights.to(weights.dtype), dkeys, dvalues


def token_sum(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """dx: each token's k slot rows rows[pos[t, j]] added one at a time in
    rows' dtype, in the order of their positions, from 0 (the scatter-add
    of JAX's VJP, which XLA applies in update order)."""
    pos = torch.sort(pos, dim=1).values
    out = torch.zeros(pos.shape[0], rows.shape[-1], dtype=rows.dtype,
                      device=rows.device)
    for j in range(pos.shape[1]):
        out = out + rows[pos[:, j]]
    return out


def _valid_rows(S: int, tile_expert, aoff, gsize):
    """[S'] bool: padded row p holds a slot (is not padding)."""
    e = tile_expert.long().repeat_interleave(TILE)
    p = torch.arange(S, device=tile_expert.device)
    return p - aoff.long()[e] < gsize.long()[e]


def _slot_grads(S, g, slot, wflat, k, tile_expert, aoff, gsize, dt):
    """do [S', D]: dt(g[slot // k] * wflat[slot]), 0 on padding rows."""
    slot = slot.long()
    do = (g[slot // k].float() * wflat[slot].float()[:, None]).to(dt)
    valid = _valid_rows(S, tile_expert, aoff, gsize)
    return torch.where(valid[:, None], do, torch.zeros_like(do))


def gmm2_bwd_dx_reference(xs, g, slot, wflat, keys, values, tile_expert,
                          aoff, gsize, k: int):
    """Plain version of the dX kernel over the aligned layout: (dxs [S',
    D], hr = relu(h) [S', ES], dh [S', ES]) in xs's dtype, tile by tile
    (padding rows: do = 0, so dh = 0)."""
    S, D = xs.shape
    dt = xs.dtype
    n = S // TILE
    e = tile_expert.long()
    do = _slot_grads(S, g, slot, wflat, k, tile_expert, aoff, gsize, dt)
    kf = keys.to(dt)[e].float()
    h = torch.bmm(xs.reshape(n, TILE, D).float(), kf).to(dt)
    dh = torch.bmm(do.reshape(n, TILE, D).float(),
                   values.to(dt)[e].float().transpose(1, 2)).to(dt)
    dh = torch.where(h > 0, dh, torch.zeros_like(dh))
    dxs = torch.bmm(dh.float(), kf.transpose(1, 2)).to(dt)
    return (dxs.reshape(S, D), torch.relu(h).reshape(S, -1),
            dh.reshape(S, -1))


def gmm2_bwd_dw_reference(xs, hr, dh, g, slot, wflat, tile_expert, aoff,
                          gsize, k: int):
    """Plain version of the dW kernel: (dkeys [E, D, ES], dvalues [E, ES,
    D]) float32, each expert's tiles summed in float32 and rounded to xs's
    dtype once (zeros for an expert with no rows)."""
    S, D = xs.shape
    ES = hr.shape[-1]
    E = gsize.shape[0]
    n = S // TILE
    e = tile_expert.long()
    dt = xs.dtype
    do = _slot_grads(S, g, slot, wflat, k, tile_expert, aoff, gsize, dt)
    tile = lambda a: a.reshape(n, TILE, -1).float()  # noqa: E731
    dkeys = torch.zeros(E, D, ES, device=xs.device).index_add_(
        0, e, torch.bmm(tile(xs).transpose(1, 2), tile(dh)))
    dvalues = torch.zeros(E, ES, D, device=xs.device).index_add_(
        0, e, torch.bmm(tile(hr).transpose(1, 2), tile(do)))
    return dkeys.to(dt).float(), dvalues.to(dt).float()


def _bind_bwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm2_bwd_dx_launch.argtypes = [p] * 12 + [i] * 5 + [p]
    lib.gmm2_bwd_dx_launch.restype = i
    lib.gmm2_bwd_dw_launch.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.gmm2_bwd_dw_launch.restype = i


def _check_bwd(xs, g, slot, wflat, aoff, gsize, k, *more):
    """What both backward kernels take: one CUDA device, bf16 xs/g/wflat
    (and bf16 `more`), int32 slot/aoff/gsize, S' a multiple of TILE, D a
    multiple of 128, contiguous, 16-byte aligned."""
    tensors = (xs, g, slot, wflat, aoff, gsize) + more
    if xs.device.type != "cuda" or any(t.device != xs.device
                                       for t in tensors):
        raise ValueError("K1's backward takes tensors on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (xs, g, wflat) + more) or \
            any(t.dtype != torch.int32 for t in (slot, aoff, gsize)):
        raise TypeError(f"expected bf16 xs, g, wflat, weights and "
                        f"activations, int32 slot, aoff, gsize; got "
                        f"{[t.dtype for t in tensors]}")
    S, D = xs.shape
    E = gsize.shape[0]
    if (g.dim() != 2 or g.shape[1] != D or tuple(slot.shape) != (S,)
            or wflat.numel() != g.shape[0] * k
            or tuple(aoff.shape) != (E + 1,) or S % TILE or D % 128):
        raise ValueError(f"bad shapes xs {tuple(xs.shape)}, g "
                         f"{tuple(g.shape)}, slot {tuple(slot.shape)}, "
                         f"wflat {tuple(wflat.shape)} (k {k}), aoff "
                         f"{tuple(aoff.shape)}, gsize {tuple(gsize.shape)}")
    if not all(t.is_contiguous() for t in tensors) or \
            any(t.data_ptr() % 16 for t in (xs, g) + more):
        raise ValueError("K1's backward takes contiguous, 16-byte aligned "
                         "tensors")


def gmm2_bwd_dx(xs, g, slot, wflat, keys, values, tile_expert, aoff, gsize,
                k: int):
    """K1's backward, first kernel: (dxs [S', D], hr [S', ES], dh [S',
    ES]), all bf16, over the aligned layout (`AlignedLayout`: slot =
    slot_padded, aoff, gsize, int32). g [T, D] is the
    output gradient, wflat [T k] the routing weights in bf16. On CUDA:
    keys [E, D, ES] and values [E, ES, D] in bf16 (the copies K1's forward
    read), ES a multiple of 128 up to 512; on the CPU the plain version."""
    if xs.device.type == "cpu":
        return gmm2_bwd_dx_reference(xs, g, slot, wflat, keys, values,
                                     tile_expert, aoff, gsize, k)
    _check_bwd(xs, g, slot, wflat, aoff, gsize, k, keys, values)
    S, D = xs.shape
    E, _, ES = keys.shape
    if (keys.shape[1] != D or tuple(values.shape) != (E, ES, D)
            or tuple(gsize.shape) != (E,) or ES % 128 or ES > 512
            or tile_expert.dtype != torch.int32
            or tuple(tile_expert.shape) != (S // TILE,)
            or tile_expert.device != xs.device):
        raise ValueError(f"bad shapes keys {tuple(keys.shape)}, values "
                         f"{tuple(values.shape)}, tile_expert "
                         f"{tuple(tile_expert.shape)} for xs "
                         f"{tuple(xs.shape)}")
    lib = _kernels.load("gmm2_bwd", _bind_bwd)
    dxs = torch.empty_like(xs)
    hr = torch.empty(S, ES, dtype=xs.dtype, device=xs.device)
    dh = torch.empty_like(hr)
    rc = lib.gmm2_bwd_dx_launch(
        xs.data_ptr(), g.data_ptr(), slot.data_ptr(), wflat.data_ptr(),
        keys.data_ptr(), values.data_ptr(), tile_expert.data_ptr(),
        aoff.data_ptr(), gsize.data_ptr(), dxs.data_ptr(), hr.data_ptr(),
        dh.data_ptr(), S, D, ES, E, k,
        torch.cuda.current_stream(xs.device).cuda_stream)
    _kernels.check(rc, "gmm2 backward dX")
    gmm2_bwd_dx.launches += 1
    return dxs, hr, dh


gmm2_bwd_dx.launches = 0


def gmm2_bwd_dw(xs, hr, dh, g, slot, wflat, tile_expert, aoff, gsize,
                k: int):
    """K1's backward, second kernel: (dkeys [E, D, ES], dvalues [E, ES, D])
    float32, each expert's sums over its rows rounded to bf16 once
    (`gmm2_bwd_dx` gives hr and dh). Deterministic. On the CPU the plain
    version."""
    if xs.device.type == "cpu":
        return gmm2_bwd_dw_reference(xs, hr, dh, g, slot, wflat,
                                     tile_expert, aoff, gsize, k)
    _check_bwd(xs, g, slot, wflat, aoff, gsize, k, hr, dh)
    S, D = xs.shape
    ES = hr.shape[-1]
    E = gsize.shape[0]
    if (tuple(hr.shape) != (S, ES) or tuple(dh.shape) != (S, ES)
            or ES % 128 or ES > 512 or S < TILE):
        raise ValueError(f"bad shapes hr {tuple(hr.shape)}, dh "
                         f"{tuple(dh.shape)} for xs {tuple(xs.shape)}")
    lib = _kernels.load("gmm2_bwd", _bind_bwd)
    dkeys = torch.empty(E, D, ES, device=xs.device)
    dvalues = torch.empty(E, ES, D, device=xs.device)
    rc = lib.gmm2_bwd_dw_launch(
        xs.data_ptr(), hr.data_ptr(), dh.data_ptr(), g.data_ptr(),
        slot.data_ptr(), wflat.data_ptr(), aoff.data_ptr(),
        gsize.data_ptr(), dkeys.data_ptr(), dvalues.data_ptr(), S, D, ES,
        E, k, torch.cuda.current_stream(xs.device).cuda_stream)
    _kernels.check(rc, "gmm2 backward dW")
    gmm2_bwd_dw.launches += 1
    return dkeys, dvalues


gmm2_bwd_dw.launches = 0


def fused_grouped_ffn_kv_bwd(x, sel, weights, lay: AlignedLayout, gathered,
                             keys16, values16, g):
    """K1's backward on the card: the two kernels over the forward's
    layout and bf16 weights, then the per-token sums in PyTorch (JAX
    computes them in XLA too). No host synchronisation. Returns (dx,
    dweights, dkeys, dvalues) as `fused_grouped_ffn_kv_bwd_reference`."""
    T, k = sel.shape
    g = g.contiguous()
    slot, aoff, gsize = lay.slot_padded, lay.aoff, lay.gsize
    wflat = weights.to(x.dtype).reshape(-1).contiguous()
    xs = x[lay.tok_padded]
    dxs, hr, dh = gmm2_bwd_dx(xs, g, slot, wflat, keys16, values16,
                              lay.tile_expert, aoff, gsize, k)
    dkeys, dvalues = gmm2_bwd_dw(xs, hr, dh, g, slot, wflat,
                                 lay.tile_expert, aoff, gsize, k)
    # padded positions keep the sorted order: JAX's order of the adds
    idx = lay.gs.inv_perm + lay.shift[sel.reshape(-1).long()]
    dx = token_sum(dxs, idx.reshape(T, k))
    dweights = torch.einsum("tkv,tv->tk", gathered.float(),
                            g.float()).to(x.dtype)
    return dx, dweights.to(weights.dtype), dkeys, dvalues


class _FusedGroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sel, weights, keys, values):
        out, lay, gathered, k16, v16 = _forward(x, sel, weights, keys,
                                                values)
        if x.device.type == "cuda":
            ctx.lay = lay
            ctx.save_for_backward(x, sel, weights, gathered, k16, v16)
        else:
            ctx.save_for_backward(x, sel, weights, keys, values)
        ctx.dtypes = (keys.dtype, values.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        need = [ctx.needs_input_grad[i] for i in (0, 2, 3, 4)]
        if not any(need):
            return None, None, None, None, None
        if g.device.type == "cuda":
            x, sel, weights, gathered, k16, v16 = ctx.saved_tensors
            grads = fused_grouped_ffn_kv_bwd(x, sel, weights, ctx.lay,
                                             gathered, k16, v16, g)
        else:
            grads = fused_grouped_ffn_kv_bwd_reference(*ctx.saved_tensors,
                                                       g)
        dx, dw, dk, dv = (t if n else None for t, n in zip(grads, need))
        if dk is not None:
            dk = dk.to(ctx.dtypes[0])
        if dv is not None:
            dv = dv.to(ctx.dtypes[1])
        return dx, None, dw, dk, dv


def fused_grouped_ffn_kv(x: torch.Tensor, sel: torch.Tensor,
                         weights: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """Differentiable fused MoE FFN: forward through K1; backward through
    the two kernels of `csrc/gmm2_bwd.cu` on the card (one forward
    recompute of h inside them, as with remat; deterministic, no atomics),
    through `fused_grouped_ffn_kv_bwd_reference` on the CPU."""
    return _FusedGroupedFFN.apply(x, sel, weights, keys, values)


def fused_path_refusal(x: torch.Tensor, keys: torch.Tensor, activation,
                       b1=None) -> Optional[str]:
    """Why K1 cannot run these experts, or None when it can. JAX's rule:
    relu experts without a bias, D and ES multiples of 128."""
    if activation is not torch.relu:
        return (f"activation {getattr(activation, '__name__', activation)!r}"
                f" is not torch.relu")
    if b1 is not None:
        return "the experts have a bias (b1)"
    if x.shape[-1] % 128 or keys.shape[-1] % 128:
        return (f"d_model {x.shape[-1]} and expert size {keys.shape[-1]} "
                f"must both be multiples of 128")
    return None


def fused_path_available(x: torch.Tensor, keys: torch.Tensor,
                         activation) -> bool:
    """JAX's rule (`fused_path_refusal`), on the accelerator: here a CUDA
    tensor, where JAX asks for a TPU."""
    return (x.device.type == "cuda"
            and fused_path_refusal(x, keys, activation) is None)
