"""The state a captured decode step reads stays where it is, on the CPU.

A CUDA graph freezes the addresses it saw during capture, so the engine's
step state lives in buffers written in place and never rebound: the
current tokens, the per-slot temperature and top_p, the cache positions
(and the drafts). An engine driven through admission, plain and verify
ticks, retirement, park and unpark keeps the storage of each of those
tensors at every tick and still matches JAX's engine tick by tick (the
same weights through `convert.from_jax_params`, the same numpy traffic).
The decoder advances positions in place on request, to the values of
its functional form. The launch accounting of `utils/cuda_graph.py` adds
a capture's counts once per replay (with a stub graph: the CPU has no
CUDA graphs). On the CPU the engine's step runs eagerly and captures
nothing.
"""

import numpy as np
import pytest
import torch

from competesmoe_tpu.serve import engine as jengine
from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.serve import engine as tengine
from competesmoe_tpu_torch.utils import cuda_graph
from tests.test_torch_port_engine_features import (  # noqa: F401 fixtures
    _multiturn, tiny_engine_model, tiny_engine_model_int4)


def _static(engine):
    return [t.data_ptr() for t in (engine._cur, engine._temps_dev,
                                   engine._topps_dev, engine._cache.pos)]


@pytest.mark.parametrize("opts", [
    dict(spec_k=2, prefix_cache_slots=2),
    dict(prefix_cache_slots=2, pipeline_depth=2, prefill_chunk=8),
    dict(spec_k=2, prefix_cache_slots=2, load_4bit=True)],
    ids=["spec2-park2", "park2-pipeline2-chunk8", "int4-spec2-park2"])
def test_step_state_keeps_its_storage_and_matches_jax(request, opts):
    """Three two-turn conversations (one with an image) through two slots:
    every tick keeps the storage of _cur, _temps_dev, _topps_dev and
    cache.pos (and the drafts buffer), the prefix cache hits, and the
    greedy streams equal JAX's engine token for token."""
    opts = dict(opts)
    jm, params, model = request.getfixturevalue(
        "tiny_engine_model_int4" if opts.pop("load_4bit", False)
        else "tiny_engine_model")
    je = jengine.DecodeEngine(jm, params, n_slots=2, max_len=96,
                              run_thread=False, **opts)
    te = tengine.DecodeEngine(model, n_slots=2, max_len=96,
                              run_thread=False, **opts)
    ptrs = _static(te) + ([te._drafts_dev.data_ptr()] if opts.get("spec_k")
                          else [])
    tick, ticks = te._tick, []

    def checked_tick():
        tick()
        ticks.append(_static(te) + ([te._drafts_dev.data_ptr()]
                                    if opts.get("spec_k") else []))

    te._tick = checked_tick
    want = _multiturn(je)
    got = _multiturn(te)
    assert got == want
    assert len(ticks) > 10 and all(p == ptrs for p in ticks)
    assert te.stats()["engine_prefix_cache_hits"] == 2
    if opts.get("spec_k"):
        assert te.stats()["engine_spec_verify_calls"] > 0
    assert not te._programs


def test_decoder_advances_pos_in_place_to_the_functional_values():
    """pos_in_place=True writes the advanced positions into the cache's
    own pos tensor and returns that cache; the logits and positions equal
    the functional form's."""
    cfg = tdec.DecoderConfig(vocab_size=64, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             fused_qkv=True)
    torch.manual_seed(0)
    model = tdec.DecoderLM(cfg, device="cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.2)
    ids = torch.as_tensor(np.random.default_rng(1).integers(1, 64, (2, 5)))
    mask = torch.ones((2, 5), dtype=torch.long)
    mask[0, 3:] = 0
    functional = tdec.KVCache.create(cfg, 2, 16, "cpu")
    in_place = tdec.KVCache.create(cfg, 2, 16, "cpu")
    storage = in_place.pos.data_ptr()
    with torch.no_grad():
        for step in range(3):
            kw = dict(attention_mask=mask) if step == 0 else {}
            want, functional, _ = model(ids, cache=functional, **kw)
            got, back, _ = model(ids, cache=in_place, pos_in_place=True,
                                 **kw)
            assert back is in_place and in_place.pos.data_ptr() == storage
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert torch.equal(in_place.pos, functional.pos)
            ids = want[:, -1:].argmax(-1)
    assert in_place.pos.tolist() == [5, 7]


def test_replays_add_the_captured_launches_once_each():
    """A capture's wrapper calls are taken back off the counts (it
    launched nothing); every replay adds them again and runs the
    callbacks registered during the capture."""
    def k5(n=1):
        k5.launches += n

    def k3():
        k3.launches += 1

    k5.launches, k3.launches = 0, 7

    def fake_capture():
        k5()
        k5()
        k3()
        return "outputs"

    outputs, counted = cuda_graph.take_back_launches(fake_capture, [k5, k3])
    assert outputs == "outputs" and counted == [(k5, 2), (k3, 1)]
    assert (k5.launches, k3.launches) == (0, 7)

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    seen = []
    program = cuda_graph.Program(Graph(), outputs, counted,
                                 [lambda: seen.append("forward")])
    for _ in range(3):
        assert program() == "outputs"
    assert Graph.replays == 3 and seen == ["forward"] * 3
    assert (k5.launches, k3.launches) == (6, 10)
    assert not cuda_graph.on_replay(lambda: None)


def test_every_kernel_wrapper_is_accounted():
    """The capture accounts for every kernel wrapper of the port."""
    from competesmoe_tpu_torch.ops import flash_attention, gmm_fused, matvec
    wrappers = cuda_graph.kernel_wrappers()
    assert set(wrappers.values()) == {
        matvec.quant_small_m_matmul_int4, matvec.small_m_matmul,
        matvec.quant_small_m_matmul, gmm_fused.gmm2_fused_aligned,
        gmm_fused.gmm2_bwd_dx, gmm_fused.gmm2_bwd_dw,
        flash_attention.flash_attention_fwd,
        flash_attention.flash_attention_bwd_dkv,
        flash_attention.flash_attention_bwd_dq}
    assert all(isinstance(w.launches, int) for w in wrappers.values())
