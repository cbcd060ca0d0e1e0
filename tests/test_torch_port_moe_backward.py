"""K1's backward on the CPU against JAX's.

JAX's K1 backward is XLA's ragged_dot VJP through `grouped_ffn_kv`
(competesmoe_tpu/ops/gmm_fused.py `_bwd`). `fused_grouped_ffn_kv_bwd_reference`
follows its jaxpr step for step; with bf16 x and f32 weights it equals
`jax.vjp` on all but a few elements: XLA and torch sum the same float32
products in other orders, so about one element in 10^4 rounds to the
neighbouring bf16 value, which its consumers carry on. The plain versions
of the two CUDA kernels (`gmm2_bwd_dx`,
`gmm2_bwd_dw` on CPU tensors), composed over the aligned layout, give the
same bits, padding rows and empty experts included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.ops import expert_compute as jec
from competesmoe_tpu_torch.ops import gmm_fused as tgmm


def _case(T=96, D=128, E=8, ES=128, k=2, seed=0, counts=None):
    """bf16 x and g, f32 weights; `counts` [E] fixes each expert's rows
    (k = 1), else a random top-k with expert 5 left empty."""
    rng = np.random.default_rng(seed)
    if counts is not None:
        T, k = int(sum(counts)), 1
        sel = rng.permutation(np.repeat(np.arange(E), counts))[:, None]
    else:
        sel = np.stack([rng.choice(E - 1, k, replace=False)
                        for _ in range(T)])
        sel[sel >= 5] += 1                   # expert 5 gets no rows
    x = jnp.asarray(rng.normal(size=(T, D)), jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=(T, D)), jnp.bfloat16)
    w = rng.uniform(0.1, 1.0, size=(T, k)).astype(np.float32)
    keys = (rng.normal(size=(E, D, ES)) * D ** -0.5).astype(np.float32)
    values = (rng.normal(size=(E, ES, D)) * ES ** -0.5).astype(np.float32)
    return x, sel.astype(np.int32), w, keys, values, g


def _torch(a):
    if isinstance(a, jax.Array) and a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _jax_vjp(x, sel, w, keys, values, g):
    _, vjp = jax.vjp(
        lambda a, b, c, d: jec.grouped_ffn_kv(a, jnp.asarray(sel), b, c, d,
                                              jax.nn.relu),
        x, jnp.asarray(w), jnp.asarray(keys), jnp.asarray(values))
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(g)]


CASES = {"random": {}, "k3": dict(k=3, seed=1),
         "edges": dict(counts=[0, 1, 255, 256, 257, 3, 40, 0], seed=2),
         "es256": dict(ES=256, D=128, seed=3)}


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case):
    """dx, dweights, dkeys and dvalues: at least 99% of the elements equal
    jax.vjp's bit for bit, and every element lies within 2^-6 of the
    tensor's largest |element| (a bf16 product rounded the other way
    upstream, from float32 sums taken in another order)."""
    x, sel, w, keys, values, g = _case(**CASES[case])
    want = _jax_vjp(x, sel, w, keys, values, g)
    got = tgmm.fused_grouped_ffn_kv_bwd_reference(
        *map(_torch, (x, sel, w, keys, values, g)))
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == got[3].dtype == torch.float32
    for name, a, b in zip(("dx", "dweights", "dkeys", "dvalues"), want,
                          got):
        b = b.float().numpy()
        assert np.mean(a == b) >= 0.99, (name, np.mean(a == b))
        np.testing.assert_allclose(b, a, rtol=0, err_msg=name,
                                   atol=2.0 ** -6 * np.abs(a).max())


def test_f32_operand_recompute_misses_jax_rounding():
    """The backward the port had before: autograd through a recompute with
    both operands of every product in float32. Its weight gradients are
    not bf16-rounded, while JAX's (ragged_dot_general writes bf16, then a
    convert to f32) and the port's now are."""
    x, sel, w, keys, values, g = _case(seed=4)
    want = _jax_vjp(x, sel, w, keys, values, g)
    tx, tsel, tw, tk, tv, tg = map(_torch, (x, sel, w, keys, values, g))
    tk.requires_grad_()
    tv.requires_grad_()
    order = torch.argsort(tsel.reshape(-1).long(), stable=True)
    xs = tx[order // tsel.shape[1]]
    sizes = torch.bincount(tsel.reshape(-1), minlength=8).tolist()
    parts = []
    for e, xe in enumerate(xs.split(sizes)):
        if sizes[e]:
            h = torch.relu((xe.float() @ tk[e]).to(xe.dtype))
            parts.append((h.float() @ tv[e]).to(xe.dtype))
    o = torch.cat(parts)[torch.argsort(order)].reshape(*tsel.shape, -1)
    out = torch.einsum("tkv,tk->tv", o.float(), tw.bfloat16().float())
    old_dk, old_dv = torch.autograd.grad(out.bfloat16(), [tk, tv], tg)
    new = tgmm.fused_grouped_ffn_kv_bwd_reference(tx, tsel, tw,
                                                  tk.detach(), tv.detach(),
                                                  tg)
    for jax_d, old, now in ((want[2], old_dk, new[2]),
                            (want[3], old_dv, new[3])):
        assert np.array_equal(np.asarray(jnp.asarray(jax_d, jnp.bfloat16)
                                         .astype(jnp.float32)), jax_d)
        assert not torch.equal(old, old.bfloat16().float())
        assert torch.equal(now, now.bfloat16().float())
        assert np.mean(now.numpy() == jax_d) >= 0.99
        assert np.mean(old.numpy() == jax_d) < 0.5


def _aligned_pieces(x, sel, w, keys, values, g):
    tx, tsel, tw, tk, tv, tg = map(_torch, (x, sel, w, keys, values, g))
    lay = tgmm.aligned_layout_full(tsel, tk.shape[0])
    args = dict(slot=lay.slot_padded, wflat=tw.bfloat16().reshape(-1),
                tile_expert=lay.tile_expert, aoff=lay.aoff, gsize=lay.gsize,
                k=tsel.shape[1])
    return tx, tsel, tw, tk, tv, tg, lay, tx[lay.tok_padded], args


@pytest.mark.parametrize("case", CASES)
def test_kernels_plain_versions_compose_to_the_reference(case):
    """The CPU wrappers of the two backward kernels (their plain versions)
    over the aligned layout, then the per-token sums: the reference's
    bits. Each wrapper counts launches only where it launches a kernel."""
    x, sel, w, keys, values, g = _case(**CASES[case])
    tx, tsel, tw, tk, tv, tg, lay, xs, a = _aligned_pieces(
        x, sel, w, keys, values, g)
    before = (tgmm.gmm2_bwd_dx.launches, tgmm.gmm2_bwd_dw.launches)
    dxs, hr, dh = tgmm.gmm2_bwd_dx(xs, tg, keys=tk.bfloat16(),
                                   values=tv.bfloat16(), **a)
    dk, dv = tgmm.gmm2_bwd_dw(xs, hr, dh, tg, **a)
    assert (tgmm.gmm2_bwd_dx.launches, tgmm.gmm2_bwd_dw.launches) == before
    T, k = tsel.shape
    idx = lay.gs.inv_perm + lay.shift[tsel.reshape(-1).long()]
    dx = tgmm.token_sum(dxs, idx.reshape(T, k))
    want = tgmm.fused_grouped_ffn_kv_bwd_reference(tx, tsel, tw, tk, tv, tg)
    assert torch.equal(dx, want[0])
    assert torch.equal(dk, want[2]) and torch.equal(dv, want[3])


def test_padding_rows_contribute_nothing():
    """Padding rows point at arbitrary slots and tokens (their weights are
    not 0): pointing them elsewhere and filling their xs and hr with
    large values changes no weight gradient, and their dh is 0."""
    x, sel, w, keys, values, g = _case(counts=[3, 300, 1, 0, 256, 17, 0,
                                               40])
    tx, tsel, tw, tk, tv, tg, lay, xs, a = _aligned_pieces(
        x, sel, w, keys, values, g)
    valid = tgmm._valid_rows(xs.shape[0], a["tile_expert"], a["aoff"],
                             a["gsize"])
    assert (~valid).sum() > 0
    assert (a["wflat"][a["slot"].long()[~valid]] != 0).all()
    k16, v16 = tk.bfloat16(), tv.bfloat16()
    dxs, hr, dh = tgmm.gmm2_bwd_dx(xs, tg, keys=k16, values=v16, **a)
    assert not dh[~valid].any()
    want = tgmm.gmm2_bwd_dw(xs, hr, dh, tg, **a)
    moved = dict(a, slot=torch.where(valid, a["slot"],
                                     a["slot"].flip(0)))
    xs2, hr2 = xs.clone(), hr.clone()
    xs2[~valid] = 100.0
    hr2[~valid] = 100.0
    dxs2, _, dh2 = tgmm.gmm2_bwd_dx(xs2, tg, keys=k16, values=v16, **moved)
    assert torch.equal(dh2, dh)
    assert torch.equal(dxs2[valid], dxs[valid])
    got = tgmm.gmm2_bwd_dw(xs2, hr2, dh, tg, **moved)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_an_expert_without_rows_gets_zero_gradients():
    x, sel, w, keys, values, g = _case(counts=[5, 0, 260, 0, 1, 9, 0, 30])
    tx, tsel, tw, tk, tv, tg, lay, xs, a = _aligned_pieces(
        x, sel, w, keys, values, g)
    ref = tgmm.fused_grouped_ffn_kv_bwd_reference(tx, tsel, tw, tk, tv, tg)
    dxs, hr, dh = tgmm.gmm2_bwd_dx(xs, tg, keys=tk.bfloat16(),
                                   values=tv.bfloat16(), **a)
    dk, dv = tgmm.gmm2_bwd_dw(xs, hr, dh, tg, **a)
    for e in (1, 3, 6):
        for t in (ref[2][e], ref[3][e], dk[e], dv[e]):
            assert not t.any()
    for e in (0, 2, 4, 5, 7):
        assert ref[2][e].any() and dk[e].any()


def test_fused_autograd_on_cpu_runs_the_reference():
    x, sel, w, keys, values, g = _case(seed=6)
    tx, tsel, tw, tk, tv, tg = map(_torch, (x, sel, w, keys, values, g))
    leaves = [t.clone().requires_grad_() for t in (tx, tw, tk, tv)]
    out = tgmm.fused_grouped_ffn_kv(leaves[0], tsel, *leaves[1:])
    got = torch.autograd.grad(out, leaves, tg)
    want = tgmm.fused_grouped_ffn_kv_bwd_reference(tx, tsel, tw, tk, tv, tg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
