"""Tensor- and expert-parallel serving against JAX: the tiny decoder of
tests/test_tp_decode.py decoded tensor parallel on 1 x 2 and 2 x 2 ranks
(MHA with a fused qkv_proj, GQA with split projections, an int8 KV cache,
and --load-8bit / --load-4bit, whose quantized projections replicate as
JAX's spec leaves them) with the greedy tokens of JAX's decode; the MoE
decoders of tests/test_ep_decode.py (smoe, mixtral) decoded with their
banks over 2 and 4 expert ranks, and the MoE tower's prefill through
`generate`, token for token with JAX; then the port's DecodeEngine (TP 1
x 2 and 2 x 2, int4 replicated, EP 2; rank 0's requests broadcast to the
followers), the model worker over HTTP (`--mesh 1x2 --engine-slots 4`,
`--ep-shards 2` on the solo path) and `cli/eval_mm --mesh 1x2`, each
against the port's one process.

The ranks are gloo processes on the CPU (`torch_parallel_ranks.spawn`):
one world of 2 and one of 4 for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.models.decoder import DecoderConfig as JDec
from competesmoe_tpu.models.decoder import DecoderLM as JDecoderLM
from competesmoe_tpu.models.decoder import KVCache as JKVCache
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.parallel import mesh as tmesh
from tests.test_llava import tiny_llava_cfg
from tests.test_torch_port_models import port_llava_cfg

# name: (the port's config fields, --load-Nbit)
TP_CASES = {"mha": ({}, None),
            "gqa_split": (dict(fused_qkv=False, num_key_value_heads=2), None),
            "int8kv": (dict(kv_quant="int8"), None),
            "load8": ({}, 8), "load4": ({}, 4)}
EP_CASES = ("smoe", "mixtral")
LOGITS = dict(rtol=2e-5, atol=1e-5)     # tests/test_tp_decode.py


def jax_cfg(**kw):
    base = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=128,
                original_max_position_embeddings=128, fused_qkv=True,
                dtype=jnp.float32)
    base.update(kw)
    return JDec(**base)


def jax_decode(cfg, params, ids, kvlen=32, n=4):
    """tests/test_tp_decode.py's greedy loop: tokens [n + 1, B] and each
    step's logits."""
    model = JDecoderLM(cfg)
    logits, cache, _ = model.apply(params, jnp.asarray(ids),
                                   cache=JKVCache.create(cfg, ids.shape[0],
                                                         kvlen))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    toks, lgs = [tok], [logits[:, -1]]
    for _ in range(n):
        logits, cache, _ = model.apply(params, tok[:, None], cache=cache)
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        toks.append(tok)
        lgs.append(logits[:, 0])
    return np.stack([np.asarray(t) for t in toks]), np.stack(
        [np.asarray(x) for x in lgs])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    paths, want = {}, {}
    for name, (kw, bits) in TP_CASES.items():
        cfg = jax_cfg(**kw)
        ids = np.random.default_rng(0).integers(1, 64, (4, 8))
        params = JDecoderLM(cfg).init(jax.random.PRNGKey(1),
                                      jnp.asarray(ids))
        torch.save(from_jax_params(params), tmp / f"{name}.pt")
        paths[name] = (str(tmp / f"{name}.pt"), kw, bits)
        if bits:
            q = jbuilder.quantize_decoder_to_int8(
                jax.tree_util.tree_map(np.asarray, params["params"]),
                bits=bits)
            cfg = dataclasses.replace(cfg, quant="int4" if bits == 4
                                      else "int8")
            params = {"params": q}
        want[name] = jax_decode(cfg, params, ids)
    for moe_name in EP_CASES:
        cfg = jax_cfg(moe_name=moe_name, num_experts=8, num_selected=2)
        ids = np.random.default_rng(0).integers(1, 64, (8, 8))
        params = JDecoderLM(cfg).init(jax.random.PRNGKey(1),
                                      jnp.asarray(ids))
        torch.save(from_jax_params(params), tmp / f"ep_{moe_name}.pt")
        paths[f"ep_{moe_name}"] = (str(tmp / f"ep_{moe_name}.pt"), moe_name,
                                   None)
        want[f"ep_{moe_name}"] = jax_decode(cfg, params, ids)
    lcfg = tiny_llava_cfg(moe=True)
    ids, px = R.tower_prompts()
    model = jllava.LlavaModel(lcfg)
    lparams = model.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                         jnp.asarray(px))
    want["tower"] = np.asarray(jllava.generate(model, lparams, ids, px,
                                               max_new_tokens=4)[0])
    torch.save(from_jax_params(lparams), tmp / "tower.pt")

    single = dict(
        engine=R.engine_tokens(None),
        engine_int4=R.engine_tokens(None, quant="int4", spec_k=0),
        engine_features=R.engine_tokens(None, features=True),
        worker_engine=R.worker_texts(["--engine-slots", "4"]),
        worker_solo=R.worker_texts(),
        eval=R.eval_results(tmp / "eval1.json"))
    two = R.spawn(R.tp_world2, 2, tmp / "w2", str(tmp), paths,
                  str(tmp / "tower.pt"), port_llava_cfg(lcfg))
    four = R.spawn(R.tp_world4, 4, tmp / "w4", paths)
    return dict(want=want, single=single, two=two, four=four)


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_decode_matches_jax(runs, world, name):
    """1 x 2 and 2 x 2 ranks: every rank's greedy tokens equal JAX's
    decode's; the logits within tests/test_tp_decode.py's bound. Heads
    and the KV cache shard by heads in bf16/f32 projections; quantized
    ones replicate (JAX's spec shards only `kernel` and `bias`)."""
    toks, logits = runs["want"][name]
    kw, bits = TP_CASES[name]
    for rank in runs[world]:
        got = rank["tp"][name]
        np.testing.assert_array_equal(got["tokens"].numpy(), toks)
        np.testing.assert_allclose(got["logits"].numpy(), logits, **LOGITS)
        hk = kw.get("num_key_value_heads", 4)
        if bits:
            assert got["heads"] == (4, hk) and got["cache_heads"] == hk
        else:
            assert got["heads"] == (2, hk // 2)
            assert got["cache_heads"] == hk // 2
            assert got["head_rows"] == 32
        # 2 x 2: the cache's 4 rows split over 'data'
        assert got["cache_rows"] == (4 if world == "two" else 2)


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("moe_name", EP_CASES)
def test_ep_decode_matches_jax(runs, world, moe_name):
    """The MoE decoder's banks over 2 (data 1) and 4 expert ranks: the
    greedy tokens of JAX's decode, the banks genuinely sharded and the
    tokens moved by all-to-all at every step."""
    toks, logits = runs["want"][f"ep_{moe_name}"]
    n = 2 if world == "two" else 4
    for rank in runs[world]:
        got = rank["ep"][f"ep_{moe_name}"]
        np.testing.assert_array_equal(got["tokens"].numpy(), toks)
        np.testing.assert_allclose(got["logits"].numpy(), logits, **LOGITS)
        assert got["a2a"] > 0
        if got["bank_rows"] is not None:
            assert got["bank_rows"] == 8 // n


def test_ep_tower_prefill_matches_jax(runs):
    """--ep-shards 2 on the MoE tower and projector: generate's tokens
    equal JAX's, and the prefill's tokens went by all-to-all."""
    for rank in runs["two"]:
        toks, a2a = rank["tower"]
        np.testing.assert_array_equal(toks, runs["want"]["tower"])
        assert a2a > 0


@pytest.mark.parametrize("key,world,ref", [
    ("engine_tp", "two", "engine"), ("engine_tp", "four", "engine"),
    ("engine_ep", "two", "engine"), ("engine_tp_int4", "two",
                                     "engine_int4"),
    ("engine_tp_features", "four", "engine_features")])
def test_parallel_engines_match_one_process(runs, key, world, ref):
    """Three concurrent requests (one with an image, speculation 2 but
    for int4) through the engine with rank 0's admissions broadcast
    (on 2 x 2 the slots split over 'data'; with the prefix cache and
    chunked prefill, second turns unparking their rows): the tokens of
    one process's engine, exactly; the followers end with rank 0's
    stop."""
    assert runs[world][0][key] == runs["single"][ref]
    if key == "engine_tp_features":
        assert runs[world][0][key][-1] == 2     # both text turns hit
    assert all(r[key] is None for r in runs[world][1:])


@pytest.mark.parametrize("key,ref", [("worker_tp", "worker_engine"),
                                     ("worker_ep", "worker_solo")])
def test_worker_mesh_flags_serve_over_http(runs, key, ref):
    """The worker's `--mesh 1x2 --engine-slots 4` and `--ep-shards 2`
    (the solo path in lockstep): rank 0 answers the three requests over
    HTTP with one process's texts."""
    got = runs["two"][0][key]
    assert got == runs["single"][ref] and len(got) == 3


def test_eval_cli_mesh_matches_one_process(runs):
    """cli/eval_mm --mesh 1x2: rank 0 scores every document (the other
    rank's model calls in lockstep) with one process's metrics and
    responses."""
    got, want = runs["two"][0]["eval"], runs["single"]["eval"]
    assert got[1]["tp_gen"] == want[1]["tp_gen"]
    # loglikelihoods: the tensor-parallel sums round in another order
    for g, w in zip(got[1]["tp_ll"], want[1]["tp_ll"]):
        assert g[0][1] == w[0][1]
        np.testing.assert_allclose(g[0][0], w[0][0], rtol=1e-5)
    for task, m in want[0].items():
        for k, v in m.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[0][task][k], v, rtol=1e-5)
    assert runs["two"][1]["eval"] is None


def test_serving_specs_follow_jax():
    """The placements JAX's serving specs give the port's modules, as
    `tensor_parallel.shard_decoder` applies them: Megatron column/row
    rules on the decoder with fused projections split part by part,
    a module's projections sharded together or replicated (quantized,
    a dim that does not divide, heads that do not), expert banks over
    'expert', the KV cache over heads."""
    from types import SimpleNamespace

    from competesmoe_tpu_torch.models import builder as tbuilder
    from competesmoe_tpu_torch.models.decoder import DecoderLM
    two = SimpleNamespace(shape={"data": 1, "model": 2})
    dec = DecoderLM(R.tp_decoder_cfg(), device="meta")
    specs = tmesh.decoder_param_shardings(two, dec)
    assert specs["layers.0.self_attn.qkv_proj.weight"] == (
        tmesh.Parts("model", (32, 32, 32)), None)
    assert specs["layers.0.mlp.gate_up_proj.weight"] == (
        tmesh.Parts("model", (64, 64)), None)
    assert specs["layers.0.self_attn.o_proj.weight"] == (None, "model")
    assert specs["layers.0.mlp.down_proj.weight"] == (None, "model")
    assert specs["lm_head.weight"] == ("model", None)
    assert specs["embed_tokens.weight"] == ()
    # rank 1 keeps the second half of each part: q, k and v
    axis = tmesh.Axis("model", 2, 1, (0, 1), None)
    got = tmesh.split_entry(torch.arange(96).reshape(96, 1), 0,
                            specs["layers.0.self_attn.qkv_proj.weight"][0],
                            axis)
    assert got.ravel().tolist() == (list(range(16, 32)) + list(range(48, 64))
                                    + list(range(80, 96)))
    # one KV head over 2 ranks: the attention replicates, the MLP shards
    gqa = tmesh.decoder_param_shardings(two, DecoderLM(R.tp_decoder_cfg(
        fused_qkv=False, num_key_value_heads=1), device="meta"))
    assert all(gqa[f"layers.1.self_attn.{n}_proj.weight"] == ()
               for n in "qkvo")
    assert gqa["layers.1.mlp.gate_proj.weight"] == ("model", None)
    # 3 ranks: 64 features, 4 heads and 64 words do not divide
    three = tmesh.decoder_param_shardings(
        SimpleNamespace(shape={"data": 1, "model": 3}), dec)
    assert all(v == () for v in three.values())
    q = DecoderLM(R.tp_decoder_cfg(), device="cpu")
    tbuilder.quantize_decoder_to_int8(q, bits=8)
    qspecs = tmesh.decoder_param_shardings(two, q)
    assert qspecs["layers.0.self_attn.qkv_proj.kernel_q"] == ()
    assert qspecs["layers.0.self_attn.qkv_proj.scale"] == ()
    assert all(v == () for k, v in qspecs.items() if "_proj" in k)
    mesh = tmesh.make_tp_mesh(1)
    llava = R.serving_llava()
    ep = tmesh.ep_param_shardings(tmesh.make_mesh(), llava)
    banks = [k for k, v in ep.items() if v]
    assert banks and all(k.rsplit(".", 1)[1].startswith("experts_")
                         for k in banks)
    lp = tmesh.llava_param_shardings(mesh, llava)
    assert all(v == () for k, v in lp.items()
               if not k.startswith("language_model"))
    assert tmesh.kv_cache_sharding(mesh) == (None, "data", None, "model",
                                             None)
