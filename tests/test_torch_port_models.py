"""Parity of the PyTorch port's LLaVA pieces with the JAX package: image
splice, vision tower, projector, and decoder logits in float32 (KV cache
plain and int8, int4 and int8 projections), the Phi-3.5 geometry and
longrope tables, and the decoder options that are not ported yet
(`matvec_kernel` is ported: tests/test_torch_port_serving.py).

Weights come from the JAX module's init and cross through
`convert.from_jax_params`; inputs are numpy from a seed. Tolerance:
float32 rtol/atol 1e-4 unless a test states another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.models.projector import ProjectorConfig as JProj
from competesmoe_tpu.models.projector import VisionProjector as JProjector
from competesmoe_tpu.models.vision import SiglipSMoEVisionTower as JTower
from competesmoe_tpu.models.vision import VisionConfig as JVis
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.models.projector import ProjectorConfig as TProj
from competesmoe_tpu_torch.models.projector import VisionProjector
from competesmoe_tpu_torch.models.vision import SiglipSMoEVisionTower
from competesmoe_tpu_torch.models.vision import VisionConfig as TVis
from tests.test_torch_port_ops import close, port_config

IMG = jllava.IMAGE_TOKEN_INDEX


def jax_llava_cfg(quant=None, kv_quant=None):
    """The tiny geometry of tests/test_llava.py with CompeteSMoE routing."""
    vis = JVis(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
               num_attention_heads=2, image_size=28, patch_size=14,
               moe_name="competesmoe", num_experts=4, num_selected=2)
    proj = JProj(projector_type="moe", mm_hidden_size=16, hidden_size=24,
                 moe_name="competesmoe", num_experts=4, num_selected=2)
    dec = jdec.DecoderConfig(vocab_size=64, hidden_size=24,
                             intermediate_size=48, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=2,
                             fused_qkv=True, max_position_embeddings=128,
                             original_max_position_embeddings=128,
                             dtype=jnp.float32, quant=quant,
                             kv_quant=kv_quant)
    return jllava.LlavaConfig(vision=vis, projector=proj, decoder=dec,
                              tokenizer_model_max_length=None)


def port_llava_cfg(jcfg):
    return tllava.LlavaConfig(
        vision=port_config(jcfg.vision, TVis),
        projector=port_config(jcfg.projector, TProj),
        decoder=port_config(jcfg.decoder, tdec.DecoderConfig),
        image_token_index=jcfg.image_token_index,
        tokenizer_model_max_length=jcfg.tokenizer_model_max_length)


def _prompt(seed=0, B=1, L=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 64, (B, L)).astype(np.int32)
    ids[:, 2] = IMG
    px = rng.uniform(-1, 1, (B, 28, 28, 3)).astype(np.float32)
    return ids, px


# ---------------------------------------------------------------------------
# pieces of the model
# ---------------------------------------------------------------------------

def test_splice_matches_jax():
    rng = np.random.default_rng(1)
    B, L, M, P, D = 3, 10, 2, 4, 5
    ids = rng.integers(1, 50, (B, L))
    ids[0, [1, 6]] = IMG          # two images
    ids[1, 4] = IMG               # one image, row padded to M
    mask = np.ones((B, L), np.int32)
    mask[2, 7:] = 0               # no image, right padding
    labels = rng.integers(0, 50, (B, L))
    text = rng.normal(size=(B, L, D)).astype(np.float32)
    feats = rng.normal(size=(B, M, P, D)).astype(np.float32)
    want = jllava.splice_image_tokens(*map(jnp.asarray,
                                           (ids, text, feats, labels,
                                            mask)))
    got = tllava.splice_image_tokens(*map(torch.as_tensor,
                                          (ids, text, feats, labels, mask)))
    assert set(want) == set(got)
    for key in want:
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      got[key].numpy(), key)


@pytest.mark.parametrize("return_ids", [True, False])
def test_vision_tower_matches_jax(return_ids):
    jcfg = jax_llava_cfg().vision
    px = _prompt(2, B=2)[1]
    tower = JTower(jcfg)
    params = tower.init(jax.random.PRNGKey(1), px)
    jf, jaux, jauxes = tower.apply(params, px,
                                   return_id_experts=return_ids)
    pt = SiglipSMoEVisionTower(port_config(jcfg, TVis), device="cpu")
    pt.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        tf, taux, tauxes = pt(torch.as_tensor(px),
                              return_id_experts=return_ids)
    close(jf, tf)
    close(jaux, taux)
    for ja, ta in zip(jauxes, tauxes):
        np.testing.assert_array_equal(np.asarray(ja.selected_experts),
                                      ta.selected_experts.numpy())
        for key in ja.losses:
            close(ja.losses[key], ta.losses[key])


@pytest.mark.parametrize("ptype", ["moe", "linear"])
def test_projector_matches_jax(ptype):
    jcfg = dataclasses.replace(jax_llava_cfg().projector,
                               projector_type=ptype)
    x = np.random.default_rng(3).normal(size=(2, 4, 16)).astype(np.float32)
    proj = JProjector(jcfg)
    params = proj.init(jax.random.PRNGKey(2), x)
    jy, jaux = proj.apply(params, x, return_id_experts=True)
    pp = VisionProjector(port_config(jcfg, TProj), device="cpu")
    pp.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        ty, taux = pp(torch.as_tensor(x), return_id_experts=True)
    close(jy, ty)
    close(jaux.aux_loss, taux.aux_loss)


@pytest.mark.parametrize("change", [
    {}, dict(kv_quant="int8"), dict(kv_quant="int8", quant="int4"),
    # llama-style split projections, GQA, tied embeddings, partial rotary
    dict(fused_qkv=False, num_attention_heads=4, num_key_value_heads=2,
         tie_word_embeddings=True, partial_rotary_factor=0.5,
         attention_bias=True, quant="int8")],
    ids=["f32", "kv8", "int4-kv8", "split-gqa-tied-int8"])
def test_decoder_logits_match_jax(change):
    """Prefill of a right-padded batch into the cache, then three decode
    steps, plus the cache-free full-sequence forward."""
    jcfg = dataclasses.replace(jax_llava_cfg().decoder, **change)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    jm = jdec.DecoderLM(jcfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    pm = tdec.DecoderLM(port_config(jcfg, tdec.DecoderConfig), device="cpu")
    pm.load_state_dict(from_jax_params(params))

    jl, _, _ = jm.apply(params, jnp.asarray(ids), attention_mask=mask)
    with torch.no_grad():
        tl, _, _ = pm(torch.as_tensor(ids).long(),
                      attention_mask=torch.as_tensor(mask))
    close(jl, tl)

    jcache = jdec.KVCache.create(jcfg, 2, 16)
    tcache = tdec.KVCache.create(pm.cfg, 2, 16, "cpu")
    jl, jcache, _ = jm.apply(params, jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask), cache=jcache)
    with torch.no_grad():
        tl, tcache, _ = pm(torch.as_tensor(ids).long(),
                           attention_mask=torch.as_tensor(mask),
                           cache=tcache)
    close(jl, tl)
    for step in range(3):
        tok = rng.integers(0, 64, (2, 1)).astype(np.int32)
        jl, jcache, _ = jm.apply(params, jnp.asarray(tok), cache=jcache)
        with torch.no_grad():
            tl, tcache, _ = pm(torch.as_tensor(tok).long(), cache=tcache)
        close(jl, tl)
    np.testing.assert_array_equal(np.asarray(jcache.pos), tcache.pos.numpy())


def test_phi35_geometry_and_longrope_match_jax():
    jcfg = jdec.phi35_mini_config(jnp.float32)
    tcfg = tdec.phi35_mini_config(torch.float32)
    assert port_config(jcfg, tdec.DecoderConfig) == tcfg
    pos = np.arange(0, 5000, 37)[None]
    for cap in (2048, 8192):               # short and long factors
        jc, js = jdec.rope_tables(jcfg, jnp.asarray(pos), cap)
        tc, ts = tdec.rope_tables(tcfg, torch.as_tensor(pos), cap)
        close(jc, tc, rtol=1e-5, atol=1e-5)
        close(js, ts, rtol=1e-5, atol=1e-5)


def test_unported_decoder_options_raise():
    cfg = port_config(jax_llava_cfg().decoder, tdec.DecoderConfig)
    # every option builds, the MoE decoder too (held to JAX in
    # tests/test_torch_port_mixtral.py, the others in
    # tests/test_torch_port_decoder_opts.py); unknown values raise
    moe = tdec.DecoderLM(dataclasses.replace(cfg, moe_name="mixtral"),
                         device="cpu")
    assert hasattr(moe.layers[0], "moe") and not hasattr(moe.layers[0],
                                                         "mlp")
    with pytest.raises(ValueError, match="Unknown multimodal MoE"):
        tdec.DecoderLM(dataclasses.replace(cfg, moe_name="switch"),
                       device="cpu")
    for change in (dict(use_alibi=True), dict(sliding_window=8),
                   dict(deferred_decode=True),
                   dict(cache_layout="per_layer"), dict(quant="w8a8"),
                   dict(norm_folded=True),
                   dict(norm_type="layernorm_nobias", mlp_type="gelu")):
        tdec.DecoderLM(dataclasses.replace(cfg, **change), device="cpu")
    for change in (dict(quant="int2"), dict(cache_layout="paged"),
                   dict(norm_type="batchnorm")):
        with pytest.raises(ValueError):
            tdec.DecoderLM(dataclasses.replace(cfg, **change), device="cpu")
    # remat is ported: the same logits and gradients as without it
    torch.manual_seed(0)
    plain = tdec.DecoderLM(cfg, device="cpu")
    for p in plain.parameters():
        torch.nn.init.normal_(p, std=0.1)
    remat = tdec.DecoderLM(dataclasses.replace(cfg, remat=True),
                           device="cpu")
    remat.load_state_dict(plain.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 7))
    outs = []
    for model in (plain, remat):
        logits = model(ids)[0]
        logits.square().sum().backward()
        outs.append((logits.detach(), [p.grad for p in model.parameters()]))
    close(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        close(a, b, rtol=1e-5, atol=1e-6)
