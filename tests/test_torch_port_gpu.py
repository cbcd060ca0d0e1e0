"""The port's CUDA kernels on the card against their plain PyTorch
versions, with the wrappers' input checks: K5 (packed-int4 decode matmul)
and the decode-shape routing of the int4 `QuantDense`; K3 and K4 (bf16
and int8 small-M matmuls) and the routing of `PallasDense` and the int8
`QuantDense` with `matvec_kernel`; K1 (fused grouped ReLU double GEMM) and
its pipeline's gradients; K2 (causal flash attention, forward, dK/dV and
dQ) at small shapes and the 154M shape.

Every test needs a CUDA GPU and skips without one. The file imports no
JAX, so it also runs where only PyTorch is installed, without the JAX
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

K5, K3 and K4 tolerance: one bf16 ulp at the largest output,
2^-7 * max|plain|. Both sides sum exact products of bf16 and bf16, int8
or int4 values in float32, in different orders. K1's and K2's tolerances
are stated with their tests.
"""

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
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-8, 8, (k, n), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, tdec.pack_int4(q), scale


def _assert_close(got, want):
    tol = 2.0 ** -7 * float(want.float().abs().max())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got.float() - want.float()).abs().max()) <= tol


# decode projections of the 5.1B decoder, then the other row groupings
@pytest.mark.parametrize("m,k,n", [
    (1, 3072, 9216), (1, 3072, 3072), (1, 3072, 16384), (1, 8192, 3072),
    (2, 3072, 3072), (3, 1024, 256), (8, 8192, 3072), (40, 1024, 256),
    (128, 3072, 512)])
def test_int4_kernel_matches_plain(gen, m, k, n):
    x, w, scale = _operands(gen, m, k, n)
    before = tmatvec.quant_small_m_matmul_int4.launches
    got = tmatvec.quant_small_m_matmul_int4(x, w, scale)
    torch.cuda.synchronize()
    assert tmatvec.quant_small_m_matmul_int4.launches == before + 1
    _assert_close(got, tmatvec.quant_small_m_matmul_int4_reference(
        x, w, scale))


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
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, q, scale


_DECODE_KN = [(3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072)]


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 8, 32)
                                   for k, n in _DECODE_KN]
                         + [(3, 1024, 256), (17, 128, 384)])
def test_k3_kernel_matches_plain(gen, m, k, n):
    x, w = _k3_operands(gen, m, k, n)
    before = tmatvec.small_m_matmul.launches
    got = tmatvec.small_m_matmul(x, w)
    torch.cuda.synchronize()
    assert tmatvec.small_m_matmul.launches == before + 1
    _assert_close(got, tmatvec.small_m_matmul_reference(x, w))


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 8, 40)
                                   for k, n in _DECODE_KN]
                         + [(3, 1024, 256), (128, 3072, 512),
                            (32, 128, 384)])
def test_k4_kernel_matches_plain(gen, m, k, n):
    x, q, scale = _k4_operands(gen, m, k, n)
    before = tmatvec.quant_small_m_matmul.launches
    got = tmatvec.quant_small_m_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert tmatvec.quant_small_m_matmul.launches == before + 1
    _assert_close(got, tmatvec.quant_small_m_matmul_reference(x, q, scale))


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
    x, q, scale = _k4_operands(gen, 2, 1024, 256)
    with pytest.raises(TypeError):
        tmatvec.quant_small_m_matmul(x, q.float(), scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul(x, q.t().contiguous().t(), scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul(x, q[:, :250], scale[:250])
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul(x, q, scale.cpu())


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


@pytest.mark.parametrize("T,D,E,ES,k,skew", [
    (300, 128, 8, 128, 2, False), (512, 256, 8, 256, 2, True),
    (65536, 512, 64, 128, 8, False)])          # the 154M layer shape
def test_k1_kernel_matches_plain(gen, T, D, E, ES, k, skew):
    x, sel, w, keys, values = _k1_case(gen, T, D, E, ES, k, skew)
    _, tok, tile_expert, _ = tgmm.aligned_layout(sel, E)
    xs = x[tok]
    before = tgmm.gmm2_fused_aligned.launches
    got = tgmm.gmm2_fused_aligned(xs, keys, values, tile_expert)
    torch.cuda.synchronize()
    assert tgmm.gmm2_fused_aligned.launches == before + 1
    _close_rel(got, tgmm.gmm2_fused_aligned_reference(
        xs, keys, values, tile_expert), 2.0 ** -6)


def test_k1_pipeline_and_gradients_match_the_cpu(gen):
    """The fused MoE FFN on the card (K1) against the grouped path on the
    CPU from the same bf16 inputs; its backward (a plain recompute)
    against the grouped path's gradients."""
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
    _, tok, te, _ = tgmm.aligned_layout(sel, 4)
    xs = x[tok]
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


@pytest.mark.parametrize("B,h,T,p", [(2, 2, 200, 82), (1, 2, 256, 64),
                                     (2, 1, 130, 33), (64, 4, 1024, 82)])
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
    delta = (do.float() * o.float()).sum(-1)
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

    import numpy as np

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
