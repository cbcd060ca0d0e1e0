"""The port's CUDA kernels on the card against their plain PyTorch
versions, with the wrappers' input checks: K5 (packed-int4 decode matmul)
and the decode-shape routing of the int4 `QuantDense`; K3 and K4 (bf16
and int8 small-M matmuls) and the routing of `PallasDense` and the int8
`QuantDense` with `matvec_kernel`; K1 (fused grouped ReLU double GEMM) and
its pipeline's gradients; K1's two backward kernels against the plain
backward (edge groups, every ES, the 154M layer), bit-for-bit repeats
without a host sync, and their input checks; K2 (causal flash attention, forward, dK/dV and
dQ) at small shapes and the 154M shape; a checkpoint loaded on the card
(the golden tiny checkpoint's digests, and K5 under --load-4bit); and
serving's decode programs captured as CUDA graphs against the eager path
on small int4 and int8 models (engine and solo streams token for token,
launches through replays, a capture that fails raising).

Every test needs a CUDA GPU and skips without one. The file imports no
JAX, so it also runs where only PyTorch is installed, without the JAX
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

K5, K3 and K4 tolerance: one bf16 ulp at the largest output,
2^-7 * max|plain|. Both sides sum exact products of bf16 and bf16, int8
or int4 values in float32, in different orders. K1's and K2's tolerances
are stated with their tests.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.ops import expert_compute as tec
from competesmoe_tpu_torch.ops import flash_attention as tfa
from competesmoe_tpu_torch.ops import gmm_fused as tgmm
from competesmoe_tpu_torch.ops import matvec as tmatvec

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(g, m, k, n):
    """x, int4 weights holding every nibble value (-8 and 7 too), packed
    split-half, and a scale."""
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-8, 8, (k, n), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    q.view(-1)[:16] = torch.arange(-8, 8, device="cuda").to(torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, tdec.pack_int4(q), scale


def _assert_close(got, want):
    tol = 2.0 ** -7 * float(want.float().abs().max())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got.float() - want.float()).abs().max()) <= tol


# decode projections of the 5.1B decoder at the rows of a solo decode
# step (1), an engine tick (8), a verify tick (40) and prefill groups (32,
# 128); then other row counts (every wgmma width, ragged last rows) at
# o_proj, smaller shapes, a ragged last block of outputs (N % 128 != 0)
# and a ragged last stage (K / 2 % 64 != 0)
@pytest.mark.parametrize("m,k,n", [
    (1, 3072, 9216), (1, 3072, 3072), (1, 3072, 16384), (1, 8192, 3072),
    (2, 3072, 3072), (3, 1024, 256), (8, 8192, 3072), (40, 1024, 256),
    (128, 3072, 512)]
    + [(m, k, n) for m in (8, 32, 40, 128)
       for k, n in ((3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072))
       if (m, k, n) != (8, 8192, 3072)]
    + [(m, 3072, 3072) for m in (3, 9, 17, 33, 64)]
    + [(17, 1040, 400), (64, 2064, 208), (128, 2064, 3088)])
def test_int4_kernel_matches_plain(gen, m, k, n):
    x, w, scale = _operands(gen, m, k, n)
    before = tmatvec.quant_small_m_matmul_int4.launches
    got = tmatvec.quant_small_m_matmul_int4(x, w, scale)
    torch.cuda.synchronize()
    assert tmatvec.quant_small_m_matmul_int4.launches == before + 1
    _assert_close(got, tmatvec.quant_small_m_matmul_int4_reference(
        x, w, scale))


@pytest.mark.parametrize("m", [1, 8, 40, 128])
def test_int4_kernel_repeats_bit_for_bit(gen, m):
    """K5's splits are summed across the cluster in rank order (no
    atomics): two runs give the same bytes, at o_proj and down_proj (8
    splits) and at qkv (4)."""
    for k, n in ((3072, 3072), (8192, 3072), (3072, 9216)):
        x, w, scale = _operands(gen, m, k, n)
        a = tmatvec.quant_small_m_matmul_int4(x, w, scale)
        b = tmatvec.quant_small_m_matmul_int4(x, w, scale)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("m", [1, 8, 40, 128])
def test_int4_kernel_is_one_launch_a_call(gen, m):
    """One call is one CUDA kernel at every M (no second pass over split
    partials, no launch per 8 rows of x), at o_proj, which splits K."""
    from torch.profiler import ProfilerActivity, profile
    x, w, scale = _operands(gen, m, 3072, 3072)
    tmatvec.quant_small_m_matmul_int4(x, w, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tmatvec.quant_small_m_matmul_int4(x, w, scale)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "qmm4_kernel" in names[0], names


def test_int4_kernel_rejects_what_it_does_not_take(gen):
    x, w, scale = _operands(gen, 1, 1024, 256)
    with pytest.raises(TypeError):
        tmatvec.quant_small_m_matmul_int4(x.float(), w, scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul_int4(x, w.t().contiguous().t(), scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul_int4(x[:, :512], w, scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul_int4(x, w, scale.cpu())
    x8, w8, s8 = _operands(gen, 129, 1024, 256)
    with pytest.raises(ValueError):           # more rows than one pass takes
        tmatvec.quant_small_m_matmul_int4(x8, w8, s8)
    with pytest.raises(ValueError):           # N % 16 != 0
        tmatvec.quant_small_m_matmul_int4(x, w[:, :248].contiguous(),
                                          scale[:248].contiguous())


def test_quant_dense_sends_decode_shapes_to_the_kernel(gen):
    """int4 QuantDense on the card: decode rows (M <= 128) launch K5,
    prefill rows (M > 128) take the plain halves contraction; both agree
    with the same layer on the CPU."""
    layer = tdec.QuantDense(1024, 512, mode="int4", device="cuda")
    _, w, scale = _operands(gen, 1, 1024, 512)
    layer.kernel_q.copy_(w)
    layer.scale.copy_(scale)
    cpu = tdec.QuantDense(1024, 512, mode="int4", device="cpu")
    cpu.load_state_dict(layer.state_dict())
    for rows, launched in ((1, 1), (8, 1), (319, 0)):
        x = torch.randn(1, rows, 1024, generator=gen,
                        device="cuda").to(torch.bfloat16)
        before = tmatvec.quant_small_m_matmul_int4.launches
        with torch.no_grad():
            got = layer(x)
            want = cpu(x.cpu())
        torch.cuda.synchronize()
        assert (tmatvec.quant_small_m_matmul_int4.launches - before
                == launched)
        _assert_close(got.cpu(), want)


# ---------------------------------------------------------------------------
# K3 and K4: bf16 and int8 small-M matmuls (csrc/matvec_small_m.cu)
# ---------------------------------------------------------------------------

def _k3_operands(g, m, k, n):
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    wt = torch.randn(n, k, generator=g, device="cuda").to(torch.bfloat16)
    return x, wt.t()              # the decoder passes weight.t()


def _k4_operands(g, m, k, n):
    """x, int8 weights holding every int8 value (-128 too: `kernel_q` may
    hold any byte, and K4 converts each one to bf16), with a last column
    on which -128 counts beyond the tolerance (-128 where x's first row is
    positive, -127 elsewhere: the product mostly cancels), and a
    scale."""
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    q.view(-1)[:256] = torch.arange(-128, 128, device="cuda").to(torch.int8)
    q[:, -1] = torch.where(x[0] > 0, -128, -127).to(torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, q, scale


_DECODE_KN = [(3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072)]


# the decode projections at M 1, 8 and 32, other row counts at o_proj,
# and shapes with a ragged last stage (K % 128 == 8: a half k-step) and
# a ragged last block of weight rows
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 8, 32)
                                   for k, n in _DECODE_KN]
                         + [(m, 3072, 3072) for m in (2, 3, 17)]
                         + [(3, 1024, 256), (17, 128, 384), (5, 1000, 200),
                            (32, 2056, 100)])
def test_k3_kernel_matches_plain(gen, m, k, n):
    x, w = _k3_operands(gen, m, k, n)
    before = tmatvec.small_m_matmul.launches
    got = tmatvec.small_m_matmul(x, w)
    torch.cuda.synchronize()
    assert tmatvec.small_m_matmul.launches == before + 1
    _assert_close(got, tmatvec.small_m_matmul_reference(x, w))


@pytest.mark.parametrize("m", [1, 2, 3, 8, 17, 32])
def test_k3_repeats_bit_for_bit(gen, m):
    """K3's splits are summed across the cluster in rank order (no
    atomics): two runs give the same bytes, at o_proj and down_proj,
    which both take clusters of 4."""
    for k, n in ((3072, 3072), (8192, 3072)):
        x, w = _k3_operands(gen, m, k, n)
        a = tmatvec.small_m_matmul(x, w)
        b = tmatvec.small_m_matmul(x, w)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# the decode projections at every M that pads to another wgmma width
# (8, 16, 40, 64, 128; 9 and 33 pad up) or takes the kernel's edge
# (M 1, 8), then a ragged last block of outputs (N 208), a ragged last
# stage (K 1000), and both with K split across a cluster (K 2056)
@pytest.mark.parametrize("m,k,n", [(m, k, n)
                                   for m in (1, 8, 9, 16, 33, 40, 64, 128)
                                   for k, n in _DECODE_KN]
                         + [(3, 1024, 256), (128, 3072, 512),
                            (32, 128, 384), (24, 3072, 208),
                            (40, 1000, 3072), (17, 2056, 3088)])
def test_k4_kernel_matches_plain(gen, m, k, n):
    x, q, scale = _k4_operands(gen, m, k, n)
    before = tmatvec.quant_small_m_matmul.launches
    got = tmatvec.quant_small_m_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert tmatvec.quant_small_m_matmul.launches == before + 1
    _assert_close(got, tmatvec.quant_small_m_matmul_reference(x, q, scale))


@pytest.mark.parametrize("m", [1, 8, 40, 128])
def test_k4_repeats_bit_for_bit(gen, m):
    """K4's splits are summed across the cluster in rank order (no
    atomics): two runs give the same bytes, at o_proj and down_proj,
    which both take clusters of 4, and at qkv, unsplit."""
    for k, n in ((3072, 3072), (8192, 3072), (3072, 9216)):
        x, q, scale = _k4_operands(gen, m, k, n)
        a = tmatvec.quant_small_m_matmul(x, q, scale)
        b = tmatvec.quant_small_m_matmul(x, q, scale)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_k3_k4_reject_what_they_do_not_take(gen):
    x, w = _k3_operands(gen, 2, 1024, 256)
    with pytest.raises(TypeError):
        tmatvec.small_m_matmul(x.float(), w)
    with pytest.raises(ValueError):       # a contiguous [K, N] copy
        tmatvec.small_m_matmul(x, w.contiguous())
    with pytest.raises(ValueError):
        tmatvec.small_m_matmul(x[:, :512], w)
    with pytest.raises(ValueError):
        tmatvec.small_m_matmul(x, w.cpu())
    with pytest.raises(ValueError):       # more rows than K3 takes
        tmatvec.small_m_matmul(_k3_operands(gen, 40, 1024, 256)[0], w)
    x, q, scale = _k4_operands(gen, 2, 1024, 256)
    with pytest.raises(TypeError):
        tmatvec.quant_small_m_matmul(x, q.float(), scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul(x, q.t().contiguous().t(), scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul(x, q[:, :250], scale[:250])
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul(x, q, scale.cpu())
    with pytest.raises(ValueError):       # more rows than K4 takes
        tmatvec.quant_small_m_matmul(_k4_operands(gen, 129, 1024, 256)[0],
                                     q, scale)


def test_matvec_layers_send_decode_shapes_to_the_kernels(gen):
    """PallasDense (bf16) and the int8 QuantDense with matvec_kernel on
    the card: rows the kernels take launch K3 (M <= 32) or K4 (M <= 32 or
    a multiple of 8 up to 128), other rows take the plain formula; both
    agree with the same layer on the CPU."""
    dense = tdec.PallasDense(1024, 512, device="cuda", dtype=torch.bfloat16)
    quant = tdec.QuantDense(1024, 512, mode="int8", device="cuda",
                            matvec_kernel=True)
    _, q, scale = _k4_operands(gen, 1, 1024, 512)
    with torch.no_grad():
        dense.weight.copy_(_k3_operands(gen, 1, 1024, 512)[1].t())
        quant.kernel_q.copy_(q)
        quant.scale.copy_(scale)
    for layer, fn, cases in (
            (dense, tmatvec.small_m_matmul, ((1, 1), (8, 1), (32, 1),
                                             (40, 0), (319, 0))),
            (quant, tmatvec.quant_small_m_matmul, ((1, 1), (8, 1), (40, 1),
                                                   (41, 0), (319, 0)))):
        cpu = type(layer)(1024, 512, device="cpu", dtype=torch.bfloat16)
        cpu.load_state_dict(layer.state_dict())
        for rows, launched in cases:
            x = torch.randn(1, rows, 1024, generator=gen,
                            device="cuda").to(torch.bfloat16)
            before = fn.launches
            with torch.no_grad():
                got = layer(x)
                want = cpu(x.cpu())
            torch.cuda.synchronize()
            assert fn.launches - before == launched, (type(layer), rows)
            _assert_close(got.cpu(), want)


# ---------------------------------------------------------------------------
# K1: fused grouped ReLU double GEMM (csrc/gmm2_fused.cu)
#
# Tolerance 2^-6 * max|plain|: the kernel rounds the f32 weights to bf16
# for the tensor cores (relative 2^-9 per product) where the plain
# version keeps them f32; both round h and the output to bf16.
# ---------------------------------------------------------------------------

def _close_rel(got, want, frac):
    err = float((got.float() - want.float()).abs().max().detach())
    tol = frac * float(want.float().abs().max().detach())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    assert err <= tol, (err, tol)


def _k1_case(g, T, D, E, ES, k, skew):
    x = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    keys = torch.randn(E, D, ES, generator=g, device="cuda") * D ** -0.5
    values = torch.randn(E, ES, D, generator=g, device="cuda") * (
        E * ES) ** -0.5
    if skew:     # most slots on two experts, experts 1..E-3 left empty
        sel = torch.zeros(T, k, dtype=torch.int64, device="cuda")
        sel[:, 1:] = E - 1
        sel[: T // 16, 0] = E - 2
    else:
        sel = torch.rand(T, E, generator=g, device="cuda").argsort(
            -1)[:, :k]
    w = torch.rand(T, k, generator=g, device="cuda") + 0.1
    w = (w / w.sum(-1, keepdim=True)).to(torch.bfloat16)
    return x, sel, w, keys, values


# each instantiation of the kernel (ES 128, 256, 384, 512), the 154M
# layer shape
@pytest.mark.parametrize("T,D,E,ES,k,skew", [
    (300, 128, 8, 128, 2, False), (512, 256, 8, 256, 2, True),
    (256, 128, 8, 384, 2, False), (768, 256, 8, 512, 2, True),
    (65536, 512, 64, 128, 8, False)])
def test_k1_kernel_matches_plain(gen, T, D, E, ES, k, skew):
    x, sel, w, keys, values = _k1_case(gen, T, D, E, ES, k, skew)
    lay = tgmm.aligned_layout_full(sel, E)
    xs, tile_expert = x[lay.tok_padded], lay.tile_expert
    before = tgmm.gmm2_fused_aligned.launches
    got = tgmm.gmm2_fused_aligned(xs, keys, values, tile_expert)
    torch.cuda.synchronize()
    assert tgmm.gmm2_fused_aligned.launches == before + 1
    _close_rel(got, tgmm.gmm2_fused_aligned_reference(
        xs, keys, values, tile_expert), 2.0 ** -6)


@pytest.mark.parametrize("T,D,E,ES,k,skew", [
    (512, 256, 8, 256, 2, True), (65536, 512, 64, 128, 8, False)])
def test_k1_repeats_bit_for_bit(gen, T, D, E, ES, k, skew):
    """K1 sums in a fixed order (no atomics): two runs give the same
    bytes, in the skewed case (ES 256) and at the 154M layer shape."""
    x, sel, w, keys, values = _k1_case(gen, T, D, E, ES, k, skew)
    lay = tgmm.aligned_layout_full(sel, E)
    xs, tile_expert = x[lay.tok_padded], lay.tile_expert
    a = tgmm.gmm2_fused_aligned(xs, keys, values, tile_expert)
    b = tgmm.gmm2_fused_aligned(xs, keys, values, tile_expert)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_k1_pipeline_and_gradients_match_the_cpu(gen):
    """The fused MoE FFN on the card (K1) against the grouped path on the
    CPU from the same bf16 inputs; its backward (the two kernels of
    csrc/gmm2_bwd.cu) against the grouped path's gradients."""
    x, sel, w, keys, values = _k1_case(gen, 384, 128, 8, 128, 2, False)
    leaves = [t.clone().requires_grad_() for t in (x, w, keys, values)]
    out = tgmm.fused_grouped_ffn_kv(leaves[0], sel, *leaves[1:])
    want = tec.grouped_ffn_kv(x.cpu(), sel.cpu(), w.cpu(), keys.cpu(),
                              values.cpu(), torch.relu)
    _close_rel(out.cpu(), want, 2.0 ** -6)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, leaves, g)
    cpu = [t.cpu().requires_grad_() for t in (x, w, keys, values)]
    ref = tec.grouped_ffn_kv(cpu[0], sel.cpu(), *cpu[1:], torch.relu)
    wants = torch.autograd.grad(ref, cpu, g.cpu())
    for a, b in zip(got, wants):
        _close_rel(a.cpu(), b, 2.0 ** -6)


def test_fused_moe_ffn_refuses_experts_k1_cannot_run(gen):
    """impl='fused' on CUDA tensors runs K1 or raises, naming the reason;
    it never slips to the grouped path on the card."""
    x, sel, w, keys, values = _k1_case(gen, 256, 128, 8, 128, 2, False)
    before = tgmm.gmm2_fused_aligned.launches
    tec.moe_ffn_kv(x, sel, w, keys, values, torch.relu, impl="fused")
    assert tgmm.gmm2_fused_aligned.launches == before + 1
    x_odd, _, _, keys_odd, values_odd = _k1_case(gen, 256, 160, 8, 128, 2,
                                                 False)
    for args, why in (
            ((x, sel, w, keys, values, tec.gelu_tanh), "activation"),
            ((x, sel, w, keys, values, torch.relu,
              torch.zeros(8, 128, device="cuda")), "bias"),
            ((x_odd, sel, w, keys_odd, values_odd, torch.relu),
             "multiples of 128")):
        with pytest.raises(NotImplementedError, match=why):
            tec.moe_ffn_kv(*args, impl="fused")
    assert tgmm.gmm2_fused_aligned.launches == before + 1


def test_k1_rejects_what_it_does_not_take(gen):
    x, sel, w, keys, values = _k1_case(gen, 256, 128, 4, 128, 2, False)
    lay = tgmm.aligned_layout_full(sel, 4)
    xs, te = x[lay.tok_padded], lay.tile_expert
    with pytest.raises(TypeError):
        tgmm.gmm2_fused_aligned(xs.float(), keys, values, te)
    with pytest.raises(TypeError):
        tgmm.gmm2_fused_aligned(xs, keys.bfloat16(), values, te)
    with pytest.raises(ValueError):
        tgmm.gmm2_fused_aligned(xs[:200], keys, values, te)
    with pytest.raises(ValueError):
        tgmm.gmm2_fused_aligned(xs, keys[..., :64].contiguous(),
                                values[:, :64].contiguous(), te)
    with pytest.raises(ValueError):
        tgmm.gmm2_fused_aligned(xs, keys, values, te.cpu())


# ---------------------------------------------------------------------------
# K1's backward (csrc/gmm2_bwd.cu) against fused_grouped_ffn_kv_bwd_reference
#
# Both sides compute the same bf16 roundings with float32 sums in other
# orders: at most 1e-4 of a gradient's elements may be off by more than
# 2^-7 |plain| + 2^-9 max|plain|, none by more than 2^-4 max|plain|
# (chip_smoke.py's K1_BWD_OFF_SHARE rule); dkeys and dvalues hold bf16
# values.
# ---------------------------------------------------------------------------

def _bwd_case(g, T, D, E, ES, k, counts=None):
    x, sel, w, keys, values = _k1_case(g, T, D, E, ES, k, False)
    if counts is not None:
        ids = torch.repeat_interleave(torch.arange(E, device="cuda"),
                                      torch.tensor(counts, device="cuda"))
        sel = ids[torch.randperm(T * k, generator=g, device="cuda")]
        sel = sel.reshape(T, k)
    gout = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    return x, sel, w.float(), keys, values, gout


def _card_backward(x, sel, w, keys, values, gout):
    leaves = [t.clone().requires_grad_() for t in (x, w, keys, values)]
    out = tgmm.fused_grouped_ffn_kv(leaves[0], sel, *leaves[1:])
    return torch.autograd.grad(out, leaves, gout)


@pytest.mark.parametrize("T,D,E,ES,k,counts", [
    (1025, 256, 8, 128, 1, (0, 1, 255, 256, 257, 0, 128, 128)),
    (512, 256, 8, 256, 2, None), (256, 128, 8, 384, 2, None),
    (768, 256, 8, 512, 2, None), (65536, 512, 64, 128, 8, None)])
def test_k1_backward_kernels_match_plain(gen, T, D, E, ES, k, counts):
    case = _bwd_case(gen, T, D, E, ES, k, counts)
    before = (tgmm.gmm2_bwd_dx.launches, tgmm.gmm2_bwd_dw.launches)
    got = _card_backward(*case)
    torch.cuda.synchronize()
    assert (tgmm.gmm2_bwd_dx.launches, tgmm.gmm2_bwd_dw.launches) == (
        before[0] + 1, before[1] + 1)
    want = tgmm.fused_grouped_ffn_kv_bwd_reference(*case)
    for name, a, b in zip(("dx", "dweights", "dkeys", "dvalues"), got,
                          want):
        assert a.dtype == b.dtype, name
        a, b = a.float(), b.float()
        top = float(b.abs().max())
        diff = (a - b).abs()
        off = float((diff > 2.0 ** -7 * b.abs() + 2.0 ** -9 * top)
                    .float().mean())
        assert off <= 1e-4 and float(diff.max()) <= 2.0 ** -4 * top, (
            name, off, float(diff.max()), top)
    for t in got[2:]:
        assert torch.equal(t, t.bfloat16().float())
    if counts is not None:       # experts without rows: zero gradients
        for e in (0, 5):
            assert not got[2][e].any() and not got[3][e].any()


def test_k1_backward_repeats_and_does_not_sync(gen):
    """No atomics: two backward passes give the same bytes. The backward
    on the card asks the host to wait for nothing (a synchronising call
    raises under the sync debug mode)."""
    x, sel, w, keys, values, gout = _bwd_case(gen, 65536, 512, 64, 128, 8)
    leaves = [t.clone().requires_grad_() for t in (x, w, keys, values)]
    out = tgmm.fused_grouped_ffn_kv(leaves[0], sel, *leaves[1:])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = torch.autograd.grad(out, leaves, gout, retain_graph=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    b = torch.autograd.grad(out, leaves, gout)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k1_backward_rejects_what_it_does_not_take(gen):
    x, sel, w, keys, values, gout = _bwd_case(gen, 256, 128, 4, 128, 2)
    lay = tgmm.aligned_layout_full(sel, 4)
    slot, aoff, gsize = lay.slot_padded, lay.aoff, lay.gsize
    wflat = w.bfloat16().reshape(-1).contiguous()
    xs = x[lay.tok_padded]
    k16, v16 = keys.bfloat16(), values.bfloat16()
    ok = dict(xs=xs, g=gout, slot=slot, wflat=wflat, keys=k16, values=v16,
              tile_expert=lay.tile_expert, aoff=aoff, gsize=gsize, k=2)
    dxs, hr, dh = tgmm.gmm2_bwd_dx(**ok)
    for bad, err in ((dict(xs=xs.float()), TypeError),
                     (dict(keys=keys), TypeError),
                     (dict(slot=slot.long()), TypeError),
                     (dict(xs=xs[:200]), ValueError),
                     (dict(tile_expert=lay.tile_expert.cpu()), ValueError),
                     (dict(keys=k16[..., :64].contiguous(),
                           values=v16[:, :64].contiguous()), ValueError)):
        with pytest.raises(err):
            tgmm.gmm2_bwd_dx(**dict(ok, **bad))
    dw = dict(xs=xs, hr=hr, dh=dh, g=gout, slot=slot, wflat=wflat,
              tile_expert=lay.tile_expert, aoff=aoff, gsize=gsize, k=2)
    tgmm.gmm2_bwd_dw(**dw)
    for bad, err in ((dict(hr=hr.float()), TypeError),
                     (dict(dh=dh[:, :64].contiguous()), ValueError),
                     (dict(g=gout[:, :64].contiguous()), ValueError),
                     (dict(aoff=aoff.cpu()), ValueError)):
        with pytest.raises(err):
            tgmm.gmm2_bwd_dw(**dict(dw, **bad))


# ---------------------------------------------------------------------------
# K2: causal flash attention (csrc/flash_attn.cu), forward and backward
#
# Tolerances against the plain float32 version on the same bf16 inputs,
# element by element for o, dQ, dK and dV: 2^-6 * |plain| + 2^-5 * the
# rms of plain over the element's (b, h, 64-row tile) (the kernels round
# P and dS to bf16 before their products, as flash attention does; rows
# of causal attention differ in scale by orders of magnitude, so a bound
# from the largest element would hide a wrong tile of small rows); lse
# 1e-3 (absolute, f32 with fast exp).
# ---------------------------------------------------------------------------

def _close_tiles(got, want, tile=64):
    w = want.float()
    B, h, T, p = w.shape
    nt = -(-T // tile)
    pad = nt * tile - T
    sq = torch.nn.functional.pad(w.square(), (0, 0, 0, pad))
    rows = torch.full((nt,), tile, device=w.device)
    rows[-1] -= pad
    rms = (sq.reshape(B, h, nt, tile * p).sum(-1) / (rows * p)).sqrt()
    rms = rms.repeat_interleave(tile, dim=-1)[..., :T, None]
    tol = 2.0 ** -6 * w.abs() + 2.0 ** -5 * rms
    diff = (got.float() - w).abs()
    assert got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert bool((diff <= tol).all()), float((diff / tol).max())


def _qkv(g, B, h, T, p):
    return [torch.randn(B, h, T, p, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3)]


# a ragged last tile; 16-byte copies; odd p (plain loads); the widest
# head; T below one tile; one tile exactly; the 154M shape
K2_SHAPES = [(2, 2, 200, 82), (1, 2, 256, 64), (2, 1, 130, 33),
             (1, 2, 320, 128), (1, 1, 40, 82), (1, 3, 64, 16),
             (64, 4, 1024, 82)]


@pytest.mark.parametrize("B,h,T,p", K2_SHAPES)
def test_k2_kernels_match_plain(gen, B, h, T, p):
    q, k, v = _qkv(gen, B, h, T, p)
    scale = p ** -0.5
    counts = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dkv,
                                   tfa.flash_attention_bwd_dq)]
    o, lse = tfa.flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = tfa.flash_attention_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    _close_tiles(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    delta = tfa.rowsum_delta(do, o)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    dq_ref, dk_ref, dv_ref = tfa._bwd_reference(q, k, v, do, lse, delta,
                                                scale)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close_tiles(got, want)
    assert [f.launches for f in (tfa.flash_attention_fwd,
                                 tfa.flash_attention_bwd_dkv,
                                 tfa.flash_attention_bwd_dq)] == [
        c + 1 for c in counts]


@pytest.mark.parametrize("B,h,T,p", [(2, 2, 200, 82), (2, 1, 130, 33),
                                     (16, 4, 1024, 82)])
def test_k2_backward_kernels_repeat_bit_for_bit(gen, B, h, T, p):
    """Each gradient is summed by one warp in a fixed order (no atomics):
    two runs on the same inputs give the same bytes, and so does a run
    that follows other work on the card."""
    q, k, v = _qkv(gen, B, h, T, p)
    scale = p ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, scale)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    delta = tfa.rowsum_delta(do, o)
    args = (q, k, v, do, lse, delta, scale)
    dk, dv = tfa.flash_attention_bwd_dkv(*args)
    dq = tfa.flash_attention_bwd_dq(*args)
    tfa.flash_attention_fwd(v, q, k, scale)          # other work between
    dq2 = tfa.flash_attention_bwd_dq(*args)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("B,h,T,p", [(2, 2, 200, 82), (2, 1, 130, 33),
                                     (16, 4, 1024, 82)])
def test_k2_forward_repeats_bit_for_bit(gen, B, h, T, p):
    """One block per query tile walks its key tiles in a fixed order: two
    runs of the forward give the same o and lse bytes, also after other
    work on the card."""
    q, k, v = _qkv(gen, B, h, T, p)
    o, lse = tfa.flash_attention_fwd(q, k, v, p ** -0.5)
    tfa.flash_attention_fwd(v, q, k, p ** -0.5)      # other work between
    o2, lse2 = tfa.flash_attention_fwd(q, k, v, p ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(o.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))


def test_k2_forward_takes_pointers_that_are_only_2_byte_aligned(gen):
    """Operands that start 2 bytes into their storage (p even) take the
    forward's plain-load path and agree with the aligned run bit for
    bit."""
    q, k, v = _qkv(gen, 1, 2, 150, 82)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda", dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 4 == 2 and out.is_contiguous()
        return out

    o, lse = tfa.flash_attention_fwd(q, k, v, 82 ** -0.5)
    o2, lse2 = tfa.flash_attention_fwd(*(shifted(t) for t in (q, k, v)),
                                       82 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(o.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))


def test_k2_backward_takes_pointers_that_are_only_2_byte_aligned(gen):
    """Operands that start 2 bytes into their storage (p even) take the
    kernels' plain-load path and agree with the aligned run bit for bit."""
    B, h, T, p = 1, 2, 150, 82
    q, k, v = _qkv(gen, B, h, T, p)
    scale = p ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, scale)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    delta = tfa.rowsum_delta(do, o)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda", dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 4 == 2 and out.is_contiguous()
        return out

    want_dkv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    want_dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    sq, sk, sv, sdo = (shifted(t) for t in (q, k, v, do))
    got_dkv = tfa.flash_attention_bwd_dkv(sq, sk, sv, sdo, lse, delta, scale)
    got_dq = tfa.flash_attention_bwd_dq(sq, sk, sv, sdo, lse, delta, scale)
    torch.cuda.synchronize()
    for a, b in zip((*got_dkv, got_dq), (*want_dkv, want_dq)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_k2_autograd_matches_the_cpu(gen):
    """`flash_attention` on the card (three kernels) against autograd
    through the plain forward on the CPU."""
    q, k, v = _qkv(gen, 2, 2, 150, 82)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.flash_attention(*leaves)
    g = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    got = torch.autograd.grad(o, leaves, g)
    cpu = [t.detach().cpu().float().requires_grad_() for t in (q, k, v)]
    o_ref, _ = tfa.flash_attention_fwd_reference(*cpu, 82 ** -0.5)
    wants = torch.autograd.grad(o_ref, cpu, g.cpu().float())
    _close_tiles(o.detach().cpu(), o_ref.detach())
    for a, b in zip(got, wants):
        _close_tiles(a.cpu(), b)


def test_k2_rejects_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 2, 64, 82)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q.float(), k, v, 0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q.transpose(1, 2), k, v, 0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q[..., :40], k, v, 0.1)
    big = torch.zeros(1, 1, 64, 160, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(big, big, big, 0.1)
    o, lse = tfa.flash_attention_fwd(q, k, v, 0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(q, k, v, o, lse.cpu(), lse, 0.1)


# ---------------------------------------------------------------------------
# The batched engine on the card
# ---------------------------------------------------------------------------

def test_pipelined_engine_ticks_do_not_synchronise(gen):
    """DecodeEngine(pipeline_depth=2) on a small bf16 model with
    matvec_kernel: once admitted, a tick issues its K3 forward and starts
    the tokens' copy to the host without a synchronising call (a .cpu()
    or .item() there would make the pipeline a no-op); the tokens are read
    one tick later, after an event."""
    import dataclasses

    from competesmoe_tpu_torch.models.builder import (HF_5P1B, build_llava,
                                                      llava_config_from_hf)
    from competesmoe_tpu_torch.serve.engine import DecodeEngine
    small = dict(HF_5P1B, vocab_size=512, hidden_size=256,
                 intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4,
                 mm_hidden_size=64,
                 vision_config=dict(hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=2,
                                    num_attention_heads=2, image_size=28,
                                    patch_size=14))
    cfg = llava_config_from_hf(small, "llava_phi", torch.bfloat16)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, matvec_kernel=True))
    engine = DecodeEngine(build_llava(cfg, device="cuda"), n_slots=4,
                          max_len=64, pipeline_depth=2, run_thread=False)
    reqs = [engine._make_request(np.arange(3, 3 + n, dtype=np.int32),
                                 max_new_tokens=12) for n in (5, 9, 17)]
    engine._tick()                           # admission and a first step
    engine._tick()
    before = tmatvec.small_m_matmul.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            engine._tick()
        with pytest.raises(RuntimeError):   # the detector itself works
            engine._cur.sum().item()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tmatvec.small_m_matmul.launches - before == 4 * 4 * 2
    for _ in range(20):
        engine._tick()
    assert all(r.done and len(r.emitted) == 12 for r in reqs)


# ---------------------------------------------------------------------------
# checkpoints on the card
# ---------------------------------------------------------------------------

FIXTURES = Path(__file__).parent / "fixtures"


def test_golden_checkpoint_on_the_card_reproduces_the_digests(gen):
    """The released-layout tiny checkpoint loaded on cuda in float32 gives
    the recorded greedy tokens of its image and text prompts (drawn as
    tests/test_golden_layout.py draws them; TF32 off, as on the CPU)."""
    from competesmoe_tpu_torch.models.builder import load_pretrained_model
    from competesmoe_tpu_torch.models.llava import IMAGE_TOKEN_INDEX, generate

    digests = json.loads((FIXTURES / "golden_tiny_digests.json")
                         .read_text())
    rng = np.random.default_rng(4)
    vocab = digests["geometry"]["vocab_size"]
    ids_img = rng.integers(2, vocab, (1, 7)).astype(np.int32)
    ids_img[0, 1] = IMAGE_TOKEN_INDEX
    px = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    ids_txt = rng.integers(2, vocab, (1, 9)).astype(np.int32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = load_pretrained_model(FIXTURES / "golden_tiny_ckpt",
                                      dtype=torch.float32, device="cuda")[1]
        assert {t.device.type for t in model.state_dict().values()} == \
            {"cuda"}
        got_img = generate(model, ids_img, px, max_new_tokens=8)[0]
        got_txt = generate(model, ids_txt, None, max_new_tokens=8)[0]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert got_img[0].tolist() == digests["greedy_tokens_image"]
    assert got_txt[0].tolist() == digests["greedy_tokens_text"]


def test_load_4bit_of_a_written_checkpoint_launches_k5(gen, tmp_path):
    """A small bf16 model (projections K5 tiles) written with
    save_hf_checkpoint and loaded with --load-4bit: every tensor equals the
    writer quantized in place, and a prefill of 8 rows and a decode step
    launch K5 at each of the 2 layers' 4 projections."""
    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, llava_config_from_hf,
        load_pretrained_model)
    from competesmoe_tpu_torch.models.hf_export import save_hf_checkpoint

    small = dict(HF_5P1B, vocab_size=512, hidden_size=256,
                 intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4,
                 mm_hidden_size=64,
                 vision_config=dict(hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=2,
                                    num_attention_heads=2, image_size=28,
                                    patch_size=14))
    cfg = llava_config_from_hf(small, "llava_phi", torch.bfloat16)
    writer = build_llava(cfg, seed=1, device="cuda")
    save_hf_checkpoint(writer, cfg, tmp_path, hf_config=small)
    model = load_pretrained_model(tmp_path, load_4bit=True,
                                  device="cuda")[1]
    apply_load_4bit(writer)
    got, want = model.state_dict(), writer.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    ids = torch.arange(3, 11, device="cuda")[None]
    before = tmatvec.quant_small_m_matmul_int4.launches
    with torch.no_grad():
        cache = tdec.KVCache.create(model.language_model.cfg, 1, 16, "cuda")
        out = model(ids, None, cache=cache)
        out = model(out.logits[:, -1].argmax(-1)[:, None], None,
                    cache=out.cache)
    torch.cuda.synchronize()
    assert tmatvec.quant_small_m_matmul_int4.launches - before == 2 * 4 * 2
    assert torch.isfinite(out.logits).all()


# ---------------------------------------------------------------------------
# The engine's chunked prefill and prefix cache on the card
# ---------------------------------------------------------------------------

def _small_cfg(dtype=torch.float32, **decoder):
    import dataclasses

    from competesmoe_tpu_torch.models.builder import (HF_5P1B,
                                                      llava_config_from_hf)
    small = dict(HF_5P1B, vocab_size=512, hidden_size=256,
                 intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4,
                 mm_hidden_size=64,
                 vision_config=dict(hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=2,
                                    num_attention_heads=2, image_size=28,
                                    patch_size=14))
    cfg = llava_config_from_hf(small, "llava_phi", dtype)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, **decoder))


def _drive_engine(engine, prompts, max_new):
    reqs = [engine._make_request(p, max_new_tokens=max_new)
            for p in prompts]
    for _ in range(50 * max_new):
        if all(r.done for r in reqs):
            break
        engine._tick()
    assert all(r.done for r in reqs)
    return [list(r.emitted) for r in reqs]


def test_chunked_prefill_and_unpark_equal_cold_admission(gen):
    """A small float32 model on the card (TF32 off): prompts of 40 and 45
    tokens prefilled in chunks of 16 (the last one partial), and turn-2
    follow-ups admitted through the prefix cache (the parked row, then
    the suffix alone), each give the greedy tokens of a cold, unchunked
    admission."""
    from competesmoe_tpu_torch.models.builder import build_llava
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = build_llava(_small_cfg(), seed=2, device="cuda")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(3, 512, n).astype(np.int32)
                   for n in (40, 45, 9)]

        def engine(**kw):
            return DecodeEngine(model, n_slots=3, max_len=160,
                                run_thread=False, **kw)

        chunked = engine(prefill_chunk=16)
        calls, chunk_prefill = [], chunked._chunk_prefill
        chunked._chunk_prefill = lambda ids, mask: (
            calls.append(int(mask.sum())) or chunk_prefill(ids, mask))
        assert _drive_engine(chunked, prompts, 8) == \
            _drive_engine(engine(), prompts, 8)
        assert sorted(calls) == sorted([16, 16, 8, 16, 16, 13])

        parked = engine(prefix_cache_slots=3)
        first = _drive_engine(parked, prompts, 6)
        follow = [np.concatenate([p, np.asarray(o, np.int32),
                                  rng.integers(3, 512, 4).astype(np.int32)])
                  for p, o in zip(prompts, first)]
        got = _drive_engine(parked, follow, 8)
        assert parked.stats()["engine_prefix_cache_hits"] == 3
        assert got == _drive_engine(engine(), follow, 8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_a_chunk_of_128_rows_launches_k5_at_every_projection(gen):
    """A small --load-4bit model (int8 KV): each chunk forward of a
    300-token prompt at chunk 128 (the last one partial, still 128 rows)
    launches K5 once at each of the 2 layers' 4 projections."""
    from competesmoe_tpu_torch.models.builder import (apply_load_4bit,
                                                      build_llava)
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    model = apply_load_4bit(build_llava(
        _small_cfg(torch.bfloat16, kv_quant="int8"), seed=4, device="cuda"))
    engine = DecodeEngine(model, n_slots=2, max_len=512, prefill_chunk=128,
                          run_thread=False)
    launches, chunk_prefill = [], engine._chunk_prefill
    k5 = tmatvec.quant_small_m_matmul_int4

    def counted(ids, mask):
        before = k5.launches
        out = chunk_prefill(ids, mask)
        launches.append(k5.launches - before)
        return out

    engine._chunk_prefill = counted
    prompt = np.random.default_rng(5).integers(3, 512, 300).astype(np.int32)
    toks = _drive_engine(engine, [prompt], 4)[0]
    assert launches == [4 * 2] * 3
    assert len(toks) == 4 and all(0 <= t < 512 for t in toks)


# ---------------------------------------------------------------------------
# Serving's decode programs as captured CUDA graphs, against the eager path
# ---------------------------------------------------------------------------

def _served_small(kind: str):
    """A small model as the worker serves it: --load-4bit (K5) or
    --load-8bit with matvec_kernel (K4), both with an int8 KV cache."""
    from competesmoe_tpu_torch.models.builder import (apply_load_4bit,
                                                      apply_load_8bit,
                                                      build_llava)
    if kind == "int4":
        return apply_load_4bit(build_llava(
            _small_cfg(torch.bfloat16, kv_quant="int8"), seed=6,
            device="cuda"))
    return apply_load_8bit(build_llava(
        _small_cfg(torch.bfloat16, kv_quant="int8", matvec_kernel=True),
        seed=6, device="cuda"))


# greedy, temperature and nucleus rows in one engine
SAMPLING = ((0.0, 1.0), (0.8, 1.0), (0.0, 1.0), (0.9, 0.8), (0.0, 1.0),
            (1.0, 1.0))


def _prompts(seed: int, lengths):
    """Prompts whose n-grams recur (the drafts hit)."""
    rng = np.random.default_rng(seed)
    return [np.resize(rng.integers(3, 512, int(rng.integers(3, 6))), n)
            .astype(np.int32) for n in lengths]


def _engine_streams(model, graphs: bool, rounds, max_new: int = 10, **kw):
    """Each round's prompts through one DecodeEngine(run_thread=False),
    ticked until every request is done; returns (streams, engine)."""
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    engine = DecodeEngine(model, run_thread=False, cuda_graphs=graphs,
                          rng_seed=3, **kw)
    ptrs = _static_ptrs(engine)
    streams = []
    for prompts in rounds:
        prompts = prompts(streams) if callable(prompts) else prompts
        reqs = [engine._make_request(p, max_new_tokens=max_new,
                                     temperature=t, top_p=tp)
                for p, (t, tp) in zip(prompts, SAMPLING)]
        for _ in range(60 * max_new):
            if all(r.done for r in reqs):
                break
            engine._tick()
        assert all(r.done for r in reqs)
        streams += [list(r.emitted) for r in reqs]
    assert _static_ptrs(engine) == ptrs
    return streams, engine


def _static_ptrs(engine):
    return [t.data_ptr() for t in (engine._cur, engine._temps_dev,
                                   engine._topps_dev, engine._cache.pos)]


def _follow_ups(prompts):
    """A round of turn-2 prompts: each first-round prompt, its answer and
    4 more tokens (a prefix-cache hit)."""
    def make(streams):
        return [np.concatenate([p, np.asarray(s, np.int32),
                                np.asarray([7, 8, 9, 10], np.int32)])
                for p, s in zip(prompts, streams[:len(prompts)])]
    return make


ENGINE_CASES = {
    "plain": dict(n_slots=4, max_len=160),
    "verify": dict(n_slots=4, max_len=160, spec_k=3),
    "pipeline2": dict(n_slots=4, max_len=160, pipeline_depth=2),
    "chunks_and_unparks": dict(n_slots=4, max_len=256, prefill_chunk=16,
                               prefix_cache_slots=4),
}


@pytest.mark.parametrize("kind", ["int4", "int8"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_captured_engine_streams_equal_eager(gen, kind, case):
    """The engine replaying its captured step programs gives the eager
    engine's streams token for token on the same card and seed: greedy,
    temperature and nucleus rows; verify ticks; pipeline depth 2; and
    chunked prefill (prompts of 40 tokens at chunk 16) and prefix-cache
    unparks (turn-2 follow-ups) between captured ticks. The cache
    positions, current tokens and sampling buffers keep their storage."""
    model = _served_small(kind)
    kw = ENGINE_CASES[case]
    rounds = [_prompts(1, (12, 30, 9, 21, 17, 25))]
    if case == "chunks_and_unparks":
        rounds = [_prompts(2, (40, 12, 45, 9)),
                  _follow_ups(_prompts(2, (40, 12, 45, 9)))]
    eager, _ = _engine_streams(model, False, rounds, **kw)
    got, engine = _engine_streams(model, True, rounds, **kw)
    assert got == eager
    assert ("spec_nucleus" if case == "verify" else "step_nucleus") \
        in engine._programs
    if case == "chunks_and_unparks":
        assert engine.stats()["engine_prefix_cache_hits"] == 4


@pytest.mark.parametrize("kind", ["int4", "int8"])
@pytest.mark.parametrize("temperature,top_p,spec", [
    (0.0, 1.0, 0), (0.8, 1.0, 0), (0.9, 0.8, 0), (0.0, 1.0, 3),
    (0.8, 0.9, 3)])
def test_captured_solo_streams_equal_eager(gen, kind, temperature, top_p,
                                           spec):
    """stream_generate replaying its captured scan and verify programs
    gives the eager tokens under the same seeded generator, on the first
    request of a bucket (which captures) and on the next (which only
    replays)."""
    from competesmoe_tpu_torch.models.llava import stream_generate

    model = _served_small(kind)
    ids = _prompts(4, (23,))[0][None]
    runs = []
    for graphs in (False, True, True):
        g = torch.Generator(device="cuda").manual_seed(11)
        runs.append(np.concatenate(list(stream_generate(
            model, ids, None, max_new_tokens=20, temperature=temperature,
            top_p=top_p, generator=g, speculative=spec,
            cuda_graphs=graphs)), axis=1))
    assert runs[0].shape == (1, 20)
    assert np.array_equal(runs[1], runs[0])
    assert np.array_equal(runs[2], runs[0])


def test_replays_count_their_launches(gen):
    """A captured tick adds the launches its graph holds to the kernel's
    count at every replay (4 projections x 2 layers of K5), and the
    capture itself adds none."""
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    model = _served_small("int4")
    engine = DecodeEngine(model, n_slots=2, max_len=64, run_thread=False)
    for p in _prompts(5, (10, 12)):
        engine._make_request(p, max_new_tokens=12)
    k5 = tmatvec.quant_small_m_matmul_int4
    before = k5.launches
    engine._tick()                       # admission, then the capture
    program = engine._programs["step_plain"]
    assert program.launches == [(k5, 4 * 2)]
    # the admission's prefill (2 x 32 rows), the warm-up step and one
    # replay: the capture itself launched nothing
    assert k5.launches - before == 3 * 4 * 2
    before = k5.launches
    for _ in range(5):
        engine._tick()
    torch.cuda.synchronize()
    assert k5.launches - before == 5 * 4 * 2


def test_a_capture_that_fails_raises(gen, monkeypatch):
    """A kernel wrapper that fails under capture makes the engine's tick
    and the solo decode raise: no step runs eagerly instead (the request
    has its first token, from the eager admission, and no other)."""
    from competesmoe_tpu_torch.models.llava import stream_generate
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    model = _served_small("int4")
    real = tdec.quant_small_m_matmul_int4

    def failing(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted capture failure")
        return real(*args)

    monkeypatch.setattr(tdec, "quant_small_m_matmul_int4", failing)
    engine = DecodeEngine(model, n_slots=2, max_len=64, run_thread=False)
    req = engine._make_request(_prompts(6, (10,))[0], max_new_tokens=8)
    with pytest.raises(RuntimeError, match="planted capture failure"):
        for _ in range(3):
            engine._tick()
    assert len(req.emitted) == 1 and not engine._programs
    chunks = stream_generate(model, _prompts(6, (10,))[0][None], None,
                             max_new_tokens=8)
    next(chunks)                         # the eager prefill's token
    with pytest.raises(RuntimeError, match="planted capture failure"):
        next(chunks)
