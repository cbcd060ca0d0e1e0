"""K2 (causal flash attention) of the PyTorch port on the CPU.

(a) `flash_attention` on CPU tensors (the kernels' plain versions, through
    the autograd function the LM calls) against `jax.grad` of JAX's causal
    einsum attention as `competesmoe_tpu/models/lm.py` computes it (JAX's
    Pallas flash attention has no CPU path), on the same numpy inputs, at
    the shapes that take the CUDA kernels' separate paths: T below one
    64-row tile, odd head size, a ragged last tile, the widest head.
(b) `_bwd_tiled_model`, the backward kernels' arithmetic tile by tile in
    plain PyTorch (transposed scores for dK/dV, the causal comparison on
    diagonal and ragged tiles only, exp2 against the saved lse, P and dS
    rounded to bf16), against the plain float32 backward on the same bf16
    inputs, judged by the rule the card check applies to the kernels
    (`chip_smoke.tile_tolerance`): the rounding scheme and the masking
    plan meet that tolerance before any card is involved.
(c) `_fwd_tiled_model`, the forward kernel's arithmetic tile by tile
    (online softmax in base 2, P rounded to bf16 before P V, the causal
    comparison on the diagonal tile only, the natural-log lse), against
    JAX's einsum attention on the same bf16 values under the same rule.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from competesmoe_tpu_torch.ops import flash_attention as tfa

# (T, p): below one tile; odd p; ragged last tile; widest head
SHAPES = [(40, 82), (130, 33), (200, 82), (96, 128)]


def _inputs(T, p, B=2, h=2, seed=0):
    rng = np.random.default_rng(seed + 1000 * T + p)
    return [rng.standard_normal((B, h, T, p)).astype(np.float32)
            for _ in range(4)]


def _jax_einsum_attention(q, k, v):
    """Causal attention as `FastRopeAttention`'s einsum path computes it
    on [B, h, T, p]."""
    T, p = q.shape[-2:]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    scores = scores / np.sqrt(p)
    causal = jnp.arange(T)[None, :] <= jnp.arange(T)[:, None]
    scores = jnp.where(causal[None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


@pytest.mark.parametrize("T,p", SHAPES)
def test_flash_attention_cpu_matches_jax_einsum(T, p):
    """o, dQ, dK and dV in float32. Tolerance 1e-5 |want| + 1e-5 max|want|:
    both sides are float32 throughout and differ in the order of their
    sums (the port's backward works from lse and delta = rowsum(dO * o),
    JAX differentiates the softmax) and in their exp."""
    q, k, v, g = _inputs(T, p)
    want_o, vjp = jax.vjp(_jax_einsum_attention, *(jnp.asarray(t)
                                                   for t in (q, k, v)))
    wants = [want_o, *vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    counts = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dkv,
                                   tfa.flash_attention_bwd_dq)]
    o = tfa.flash_attention(*leaves)
    gots = [o, *torch.autograd.grad(o, leaves, torch.from_numpy(g))]
    for name, got, want in zip(("o", "dq", "dk", "dv"), gots, wants):
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape == (2, 2, T, p)
        tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert (np.abs(got - want) <= tol).all(), (
            name, float((np.abs(got - want) / tol).max()))
    # CPU tensors take the plain versions: no kernel was launched
    assert counts == [f.launches for f in (tfa.flash_attention_fwd,
                                           tfa.flash_attention_bwd_dkv,
                                           tfa.flash_attention_bwd_dq)]


def _bf16_case(T, p):
    q, k, v, do = (torch.from_numpy(t).to(torch.bfloat16)
                   for t in _inputs(T, p, seed=7))
    scale = p ** -0.5
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, scale)
    return q, k, v, do, lse, tfa.rowsum_delta(do, o), scale


@pytest.mark.parametrize("T,p", SHAPES + [(256, 64)])
def test_tiled_model_of_the_backward_kernels_meets_the_card_tolerance(T, p):
    """The kernels' scheme on bf16 inputs against the plain float32
    backward: |model - plain| <= 2^-6 |plain| + 2^-5 rms(plain over the
    element's 64-row tile), the card check's rule (P and dS are rounded
    to bf16, 2^-9 relative each, before products summed in float32)."""
    args = _bf16_case(T, p)
    wants = tfa._bwd_reference(*args)
    gots = tfa._bwd_tiled_model(*args)
    for name, got, want in zip(("dq", "dk", "dv"), gots, wants):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        diff = (got.float() - want).abs()
        worst = float((diff / chip_smoke.tile_tolerance(want)).max())
        assert worst <= 1.0, (name, worst)


def test_tiled_model_needs_its_diagonal_mask(monkeypatch):
    """With the comparison dropped (every tile takes the path without it)
    the model leaves the tolerance, so the test above would see a masking
    plan that skips a tile it must not."""
    args = _bf16_case(200, 82)
    monkeypatch.setattr(torch.Tensor, "where",
                        lambda self, keep, other: self)
    gots = tfa._bwd_tiled_model(*args)
    monkeypatch.undo()
    for got, want in zip(gots, tfa._bwd_reference(*args)):
        diff = (got.float() - want).abs()
        worst = float((diff / chip_smoke.tile_tolerance(want)).max())
        assert not worst <= 1.0


def _jax_bf16_forward(q, k, v):
    """JAX's einsum attention on bf16 inputs, as the LM runs it under
    -amp (float32 scores, probabilities rounded to bf16, output bf16),
    with the lse of its scaled, masked scores in float32."""
    qj, kj, vj = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    T, p = q.shape[-2:]
    scores = jnp.einsum("bhqd,bhkd->bhqk", qj, kj,
                        preferred_element_type=jnp.float32) / np.sqrt(p)
    causal = jnp.arange(T)[None, :] <= jnp.arange(T)[:, None]
    scores = jnp.where(causal[None, None], scores, -jnp.inf)
    o = _jax_einsum_attention(qj, kj, vj)
    return (torch.from_numpy(np.array(o.astype(jnp.float32))),
            torch.from_numpy(np.array(jax.nn.logsumexp(scores, axis=-1))))


@pytest.mark.parametrize("T,p", SHAPES + [(256, 64)])
def test_tiled_model_of_the_forward_kernel_matches_jax_einsum(T, p):
    """The forward kernel's scheme (`_fwd_tiled_model`: online softmax in
    base 2 over 64-row tiles, P rounded to bf16 before P V, the causal
    comparison on the diagonal tile only) on bf16 inputs against JAX's
    einsum attention on the same values: o within the card check's tile
    rule, |model - JAX| <= 2^-6 |JAX| + 2^-5 rms(JAX over the element's
    64-row tile) (both round P, at different points, and o to bf16); lse
    within 1e-3 (absolute, the card check's bound; float32 on both
    sides)."""
    q, k, v, _, _, _, scale = _bf16_case(T, p)
    o, lse = tfa._fwd_tiled_model(q, k, v, scale)
    want_o, want_lse = _jax_bf16_forward(q, k, v)
    assert o.dtype == torch.bfloat16 and o.shape == want_o.shape
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    diff = (o.float() - want_o).abs()
    worst = float((diff / chip_smoke.tile_tolerance(want_o)).max())
    assert worst <= 1.0, worst
    assert float((lse - want_lse).abs().max()) <= 1e-3


def test_tiled_forward_model_needs_its_diagonal_mask(monkeypatch):
    """With the comparison dropped on the diagonal tile the forward model
    attends to later keys and leaves the tolerance, so the test above
    would see a masking plan that skips a tile it must not."""
    q, k, v, _, _, _, scale = _bf16_case(200, 82)
    where = torch.Tensor.where
    monkeypatch.setattr(torch.Tensor, "where", lambda self, keep, other:
                        self if other == -math.inf else where(self, keep,
                                                              other))
    o, _ = tfa._fwd_tiled_model(q, k, v, scale)
    monkeypatch.undo()
    want_o, _ = _jax_bf16_forward(q, k, v)
    diff = (o.float() - want_o).abs()
    assert not float((diff / chip_smoke.tile_tolerance(want_o)).max()) <= 1.0


def test_rowsum_delta_is_float32_rowsum():
    q, k, v, do, lse, delta, scale = _bf16_case(40, 82)
    o, _ = tfa.flash_attention_fwd_reference(q, k, v, scale)
    assert delta.dtype == torch.float32 and delta.shape == q.shape[:3]
    want = (do.double() * o.double()).sum(-1)
    assert float((delta.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
