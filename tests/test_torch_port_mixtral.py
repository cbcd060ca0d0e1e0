"""Mixtral's MoE decoder in the port against the JAX package, and the four
places where the JAX package cannot do what its API offers.

- `grouped_ffn_swiglu` and `MixtralMoELayer` (float32: outputs, aux losses
  and every gradient within rtol 1e-4, atol 1e-5; bf16: within 2^-6 of
  max|JAX| with the same selections);
- a 2-layer MoE decoder's no-cache logits and summed aux loss, and a small
  LLaVA with it: 8 cached greedy tokens, `aux_llm` in the loss, one sft
  step of `train/mm_task`;
- a Mixtral-layout checkpoint written here (HF `block_sparse_moe` names),
  loaded by both `load_pretrained_model`s (and under `--load-4bit`, which
  leaves the experts and the gate as they are in both);
- JAX's behaviours that the port matches or refuses (ROADMAP §3): a
  checkpoint routed by xmoe, smoe_perturbed, smoe_share or deepseekv3
  loads in JAX and fails at its first forward (the port refuses to load
  it; smoe_sigmoidgating loads and runs in both); JAX's `export_decoder`
  fails on a Mixtral tree (the port refuses); JAX's `cli/train_mm` parses
  `--moe-name` and reads it nowhere (the port's CLI does the same,
  `test_torch_port_mm_data.py::test_train_mm_cli_refusals`).
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu.models import hf_export as jexport
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.moe.layers import MixtralMoELayer as JMixtral
from competesmoe_tpu.ops import expert_compute as jec
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.models import hf_export as texport
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.models import safetensors_io as sio
from competesmoe_tpu_torch.moe.layers import MixtralMoELayer
from competesmoe_tpu_torch.ops import expert_compute as tec
from tests.test_torch_port_models import IMG, port_llava_cfg
from tests.test_torch_port_mm_routers import (close, np32, random_params)
from tests.test_torch_port_ops import port_config

BF16_REL = 2.0 ** -6
GOLDEN = Path(__file__).parent / "fixtures" / "golden_tiny_ckpt"

# a Mixtral-8x7B-shaped LLaVA at a tiny width: 8 experts top-2, GQA,
# split projections, untied head; SigLIP tower and projector with SMoE
MIXTRAL_TINY = dict(
    model_type="mixtral", vocab_size=64, hidden_size=32,
    intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=1e6,
    max_position_embeddings=256, sliding_window=None, num_local_experts=8,
    num_experts_per_tok=2, tie_word_embeddings=False, mm_hidden_size=16,
    mm_projector_type="moe", moe_name="smoe", num_experts=4,
    num_selected=2, clip_smoe=True, mlp_smoe=True, scales=[1],
    vision_config=dict(hidden_size=16, intermediate_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       image_size=28, patch_size=14),
    tokenizer_model_max_length=256)


def swiglu_inputs(seed=0, T=10, d=16, h=24, E=8, k=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    sel = np.stack([rng.choice(E - 1, k, replace=False)
                    for _ in range(T)]).astype(np.int32)   # expert E-1 empty
    w = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    ws = [rng.normal(0, 0.2, s).astype(np.float32)
          for s in ((E, d, h), (E, d, h), (E, h, d))]
    return x, sel, w, ws


def test_grouped_ffn_swiglu_matches_jax():
    """float32 with every gradient (an expert without rows among them),
    then bf16 activations against float32 weights."""
    x, sel, w, ws = swiglu_inputs()
    r = np.random.default_rng(1).standard_normal((10, 16)).astype(np.float32)

    def jf(x, w, w1, w3, w2):
        return jnp.sum(jec.grouped_ffn_swiglu(x, sel, w, w1, w3, w2) * r)
    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4))(x, w, *ws)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, *ws)]
    got = tec.grouped_ffn_swiglu(ts[0], torch.as_tensor(sel), ts[1],
                                 *ts[2:])
    (got * torch.as_tensor(r)).sum().backward()
    close(float((got * torch.as_tensor(r)).sum()), float(jv))
    for t, g in zip(ts, jg):
        close(np32(t.grad), g)
    assert not ts[2].grad[-1].any()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jec.grouped_ffn_swiglu(xb, sel, w, *ws), np.float32)
    got = tec.moe_ffn_swiglu(torch.as_tensor(x).to(torch.bfloat16),
                             torch.as_tensor(sel), torch.as_tensor(w),
                             *map(torch.as_tensor, ws))
    assert got.dtype == torch.bfloat16
    assert np.abs(np32(got) - want).max() <= BF16_REL * np.abs(want).max()
    with pytest.raises(ValueError, match="expert-parallel mesh"):
        tec.moe_ffn_swiglu(torch.as_tensor(x), torch.as_tensor(sel),
                           torch.as_tensor(w), *map(torch.as_tensor, ws),
                           impl="ep")


def test_mixtral_layer_matches_jax():
    """MixtralMoELayer in training: output, selections, the flattened
    balance and z-loss, every gradient (float32); bf16 outputs."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    r = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jl = JMixtral(in_dim=16, out_dim=16, n_experts=8, n_selected=2,
                  expert_hidden_dim=24)
    params = random_params(jl, jnp.asarray(x), seed=3)
    tl = MixtralMoELayer(16, 16, n_experts=8, n_selected=2,
                         expert_hidden_dim=24, device="cpu")
    tl.load_state_dict(from_jax_params(params))

    def jloss(p):
        out, aux = jl.apply(p, jnp.asarray(x), train=True)
        return jnp.sum(out * r) + aux.aux_loss, (out, aux)
    (_, (jo, ja)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    to, ta = tl(torch.as_tensor(x), train=True)
    (torch.sum(to * torch.as_tensor(r)) + ta.aux_loss).backward()
    close(np32(to), jo)
    np.testing.assert_array_equal(ta.selected_experts.numpy(),
                                  np.asarray(ja.selected_experts))
    for k in ("balance_loss", "router_z_loss"):
        close(float(ta.losses[k]), float(ja.losses[k]), k)
    close(float(ta.aux_loss), float(ja.aux_loss))
    want = from_jax_params(jg)
    for k, p in tl.named_parameters():
        close(np32(p.grad), want[k].numpy(), k)
    jo, ja = jl.apply(params, jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        to, _ = tl(torch.as_tensor(x).to(torch.bfloat16))
    want = np.asarray(jo, np.float32)
    assert np.abs(np32(to) - want).max() <= BF16_REL * np.abs(want).max()


def tiny_cfgs():
    jcfg = jbuilder.llava_config_from_hf(MIXTRAL_TINY, "llava-mixtral",
                                         jnp.float32)
    return jcfg, port_llava_cfg(jcfg)


def test_moe_decoder_logits_match_jax():
    """A 2-layer Mixtral decoder without a cache: logits and the summed
    aux loss in training, and the same gradients under remat."""
    jcfg = tiny_cfgs()[0].decoder
    assert jcfg.moe_name == "mixtral" and jcfg.num_experts == 8
    ids = np.random.default_rng(4).integers(0, 64, (2, 7))
    jm = jdec.DecoderLM(jcfg)
    params = random_params(jm, jnp.asarray(ids), train=True)

    def jloss(p):
        logits, _, aux = jm.apply(p, jnp.asarray(ids), train=True)
        return jnp.sum(logits[:, -1]) + aux["total_aux_loss"], (logits, aux)
    (_, (jlog, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    want = from_jax_params(jg)
    for remat in (False, True):
        model = tdec.DecoderLM(dataclasses.replace(
            port_config(jcfg, tdec.DecoderConfig), remat=remat),
            device="cpu")
        model.load_state_dict(from_jax_params(params))
        assert not hasattr(model.layers[0], "mlp")
        logits, _, aux = model(torch.as_tensor(ids), train=True)
        (logits[:, -1].sum() + aux["total_aux_loss"]).backward()
        close(np32(logits), jlog, "logits")
        close(float(aux["total_aux_loss"]), float(jaux["total_aux_loss"]))
        for k, p in model.named_parameters():
            close(np32(p.grad), want[k].numpy(), f"remat {remat} {k}")


# ---------------------------------------------------------------------------
# a small LLaVA with the Mixtral decoder
# ---------------------------------------------------------------------------

def mixtral_decoder_hf(decoder):
    """A Mixtral `DecoderLM`'s weights under HF Mixtral's names, each
    layer's by chip_smoke.py's writer (the port's export refuses a MoE
    decoder, as JAX's fails on one)."""
    from chip_smoke import mixtral_layer_hf
    sd = decoder.state_dict()
    out = {"model.embed_tokens.weight": sd["embed_tokens.weight"],
           "model.norm.weight": sd["norm.weight"],
           "lm_head.weight": sd["lm_head.weight"]}
    for li, layer in enumerate(decoder.layers):
        out.update(mixtral_layer_hf(layer, f"model.layers.{li}."))
    return out


def write_mixtral_checkpoint(path: Path, seed=0, hf=MIXTRAL_TINY) -> Path:
    cfg = tbuilder.llava_config_from_hf(hf, "llava-mixtral", torch.float32)
    model = tbuilder.build_llava(cfg, seed=seed, device="cpu")
    sd = texport.export_siglip_tower(model.vision_tower, cfg.vision,
                                     "model.vision_tower.vision_tower.")
    sd.update(texport.export_mlpmoe_projector(model.mm_projector,
                                              "model.mm_projector."))
    sd.update(mixtral_decoder_hf(model.language_model))
    path.mkdir(parents=True, exist_ok=True)
    sio.save_file({k: v.contiguous() for k, v in sd.items()},
                  path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(hf))
    return path


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    return write_mixtral_checkpoint(
        tmp_path_factory.mktemp("ckpt") / "llava-mixtral-tiny")


@pytest.fixture(scope="module")
def loaded(mixtral_ckpt):
    jm, jv = jbuilder.load_pretrained_model(mixtral_ckpt,
                                            dtype=jnp.float32)[1:3]
    model = tbuilder.load_pretrained_model(mixtral_ckpt, dtype=torch.float32,
                                           device="cpu")[1]
    return jm, jax.tree_util.tree_map(np.asarray, jv), model


def prompt(seed=5, L=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 64, (1, L)).astype(np.int32)
    ids[0, 3] = IMG
    px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
    return ids, px


def test_mixtral_checkpoint_loads_like_jax(loaded):
    """Both builders load the Mixtral-layout checkpoint: the same config,
    the port's tensors equal `from_jax_params` of JAX's, no checkpoint
    tensor left unread."""
    jm, jv, model = loaded
    assert port_llava_cfg(jm.cfg) == model.cfg
    assert model.cfg.decoder.moe_name == "mixtral"
    want = from_jax_params(jv)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_mixtral_llava_greedy_matches_jax(loaded):
    """8 cached greedy tokens of an image prompt and of a text prompt."""
    jm, jv, model = loaded
    ids, px = prompt()
    for p_ids, p_px in ((ids, px), (ids[:, 4:], None)):
        a = tllava.generate(model, p_ids, p_px, max_new_tokens=8)[0]
        b = jllava.generate(jm, jv, p_ids, p_px, max_new_tokens=8)[0]
        np.testing.assert_array_equal(a, np.asarray(b))


def test_mixtral_load_4bit_keeps_experts_like_jax(mixtral_ckpt, loaded):
    """--load-4bit quantizes the attention projections (and the lm_head to
    int8) and leaves the gate and the experts as they are, as JAX's
    quantize_decoder_to_int8 touches only its projection names."""
    jm, jv, _ = loaded
    model = tbuilder.load_pretrained_model(mixtral_ckpt, load_4bit=True,
                                           dtype=torch.float32,
                                           device="cpu")[1]
    jq = jbuilder.quantize_decoder_to_int8(jv["params"]["language_model"],
                                           bits=4)
    want = from_jax_params(jq)
    got = model.language_model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if "moe." in k:
            assert torch.equal(got[k], v), k
        elif k.endswith("kernel_q"):
            assert torch.equal(got[k], v), k
    assert isinstance(model.language_model.layers[0].self_attn.q_proj,
                      tdec.QuantDense)


def test_aux_llm_and_mm_step_match_jax(loaded):
    """The loss's aux_llm (the mean over layers of each MoE layer's
    coefficient-scaled aux loss), then one sft step of train/mm_task:
    metrics and every parameter after the update."""
    from competesmoe_tpu.train import mm_task as jmm
    from competesmoe_tpu.train.lm_trainer import TrainState
    from competesmoe_tpu_torch.train import mm_task as tmm
    from tests.test_torch_port_mm_train import (_metrics_close,
                                                _params_close, tcfg_for)
    jm, jv, model = loaded
    model = tllava.LlavaModel(model.cfg, device="cpu")
    model.load_state_dict(from_jax_params(jv))
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 64, (2, 12)).astype(np.int32)
    ids[:, 2] = IMG
    labels = ids.copy()
    labels[:, :3] = -100
    px = rng.uniform(-1, 1, (2, 28, 28, 3)).astype(np.float32)
    jout = jax.jit(lambda p: jm.apply(p, ids, px, labels=labels, train=True,
                                      step=0))(jv)
    with torch.no_grad():
        out = model(torch.as_tensor(ids, dtype=torch.long),
                    torch.as_tensor(px),
                    labels=torch.as_tensor(labels, dtype=torch.long),
                    train=True, step=0)
    assert float(jout.aux_llm) > 0
    close(float(out.aux_llm), float(jout.aux_llm), "aux_llm")
    close(float(out.loss), float(jout.loss), "loss")
    batch = {"input_ids": ids, "labels": labels,
             "attention_mask": np.ones_like(ids), "images": px}
    jt = jmm.MMTrainConfig(**tcfg_for("sft", False))
    jopt = jmm.make_mm_optimizer(jt, jv["params"])
    jstate = TrainState.create(jv["params"], jopt)
    jstate, jmet = jmm.make_mm_train_step(jm, jopt, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = tmm.make_mm_optimizer(tmm.MMTrainConfig(**tcfg_for("sft", False)))
    state = tmm.MMTrainState.create(model, opt)
    state, met = tmm.make_mm_train_step(model, opt)(
        state, tmm.batch_to(batch, "cpu"))
    _metrics_close(met, jmet, "mixtral sft step")
    _params_close(model, jstate.params, "mixtral sft step")


# ---------------------------------------------------------------------------
# what the JAX package cannot do, and the port's answer
# ---------------------------------------------------------------------------

def _golden_with(tmp_path, moe_name) -> Path:
    d = tmp_path / f"golden-{moe_name}"
    shutil.copytree(GOLDEN, d)
    cfg = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps(dict(cfg, moe_name=moe_name)))
    return d


@pytest.mark.parametrize("name", ["xmoe", "smoe_perturbed", "smoe_share",
                                  "deepseekv3"])
def test_unloadable_router_checkpoints_fail_in_jax_refused_in_port(
        tmp_path, name):
    """The released layout with `moe_name` changed: JAX's builder loads
    it and its first forward fails (no `inp_reduction` for the cosine
    routers; a [in, E] gate where the shared-expert ones take [in, E-1]);
    the port refuses the load, citing ROADMAP §3."""
    from flax.errors import ScopeParamNotFoundError, ScopeParamShapeError
    ckpt = _golden_with(tmp_path, name)
    jm, jv = jbuilder.load_pretrained_model(ckpt, dtype=jnp.float32)[1:3]
    ids, px = prompt(L=9)
    err = (ScopeParamNotFoundError if name in ("xmoe", "smoe_perturbed")
           else ScopeParamShapeError)
    with pytest.raises(err):
        jax.jit(lambda p: jm.apply(p, ids, px))(jv)
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        tbuilder.load_pretrained_model(ckpt, dtype=torch.float32,
                                       device="cpu")


def test_sigmoidgating_checkpoint_loads_and_runs_in_both(tmp_path):
    ckpt = _golden_with(tmp_path, "smoe_sigmoidgating")
    jm, jv = jbuilder.load_pretrained_model(ckpt, dtype=jnp.float32)[1:3]
    model = tbuilder.load_pretrained_model(ckpt, dtype=torch.float32,
                                           device="cpu")[1]
    assert model.cfg.projector.moe_name == "smoe_sigmoidgating"
    ids, px = prompt(L=9)
    want = jax.jit(lambda p: jm.apply(p, ids, px).logits)(jv)
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long),
                    torch.as_tensor(px)).logits
    close(np32(got), want, rtol=1e-4, atol=1e-4)


def test_mixtral_export_fails_in_jax_refused_in_port(loaded):
    jm, jv, model = loaded
    with pytest.raises(KeyError, match="mlp"):
        jexport.export_decoder(jv["params"]["language_model"],
                               jm.cfg.decoder)
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        texport.export_decoder(model.language_model, model.cfg.decoder)


def test_moe_name_flag_is_read_nowhere_in_jax_cli():
    """JAX's cli/train_mm parses --moe-name and reads it nowhere: the
    router is config.json's `moe_name`. The port's CLI parses it the same
    way and reads it nowhere either."""
    from competesmoe_tpu.cli import train_mm as jcli
    from competesmoe_tpu_torch.cli import train_mm as tcli
    for mod in (jcli, tcli):
        src = inspect.getsource(mod)
        assert src.count('"--moe-name"') == 1
        assert "a.moe_name" not in src and "args.moe_name" not in src


def test_param_groups_and_lora_targets_match_jax(loaded):
    """The Mixtral decoder's `moe.*` parameters and an XMoE tower's and
    projector's `inp_reduction` / `expert_embeddings` fall into JAX's
    optimizer groups, and LoRA adapts the same modules as JAX's default
    filter (linear kernels outside the tower, the projector and the
    lm_head: no MoE parameter)."""
    from competesmoe_tpu.train import lora as jlora
    from competesmoe_tpu.train import mm_task as jmm
    from competesmoe_tpu_torch.convert import from_jax_lora
    from competesmoe_tpu_torch.train import lora as tlora
    from competesmoe_tpu_torch.train import mm_task as tmm
    from tests.test_torch_port_mm_routers import router_llava_cfg
    jm, jv, model = loaded
    xcfg = router_llava_cfg("xmoe")
    ids, px = prompt(L=9)
    xparams = random_params(jllava.LlavaModel(xcfg), ids, px)
    xmodel = tllava.LlavaModel(port_llava_cfg(xcfg), device="cpu")
    xmodel.load_state_dict(from_jax_params(xparams))
    groups = ("projector", "vision", "decoder")
    for params, port in ((jv, model), (xparams, xmodel)):
        # JAX's label of each parameter as a constant array of its shape,
        # carried to the port's names the way its weights are
        codes = jax.tree_util.tree_map(
            lambda lab, a: np.full(np.shape(a), groups.index(lab),
                                   np.float32),
            jmm.param_labels(params["params"]), params["params"])
        want = {k: groups[int(v.reshape(-1)[0])]
                for k, v in from_jax_params(codes).items()}
        assert tmm.param_labels(port) == want
        jl = jlora.init_lora_params(params["params"], 4,
                                    jax.random.PRNGKey(0))
        tl = tlora.init_lora_params(port, 4, torch.Generator())
        assert sorted(from_jax_lora(jl)) == sorted(tl.names)
        assert not any("moe" in n or "inp_reduction" in n
                       for n in tl.names)
