"""Parity of the port's CLIP tower, S² functions and mlpNx_gelu projector
with the JAX package: the tower (MoE, 'patch' and 'cls_patch' features),
`convert_clip_tower` of one HF-layout state dict, a CLIP LLaVA (CLIP
tower, mlp2x_gelu projector, a Mistral-style GQA decoder with a sliding
window) loaded from a checkpoint directory by both packages' builders and
decoded greedily, the mlpNx_gelu projector's load and export, S²'s split
and merge, `multiscale_features`, two training steps of the CLIP LLaVA,
and JAX's export of a CLIP tree, which fails.

Weights come from the JAX module's init and cross through
`convert.from_jax_params`; inputs are numpy from a seed. Tolerance:
float32 rtol/atol 1e-5 unless a test states another.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu.models import hf_export as jexport
from competesmoe_tpu.models import hf_loader as jloader
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.models import projector as jproj
from competesmoe_tpu.models import vision as jvision
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import hf_export as texport
from competesmoe_tpu_torch.models import hf_loader as tloader
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.models import projector as tproj
from competesmoe_tpu_torch.models import safetensors_io as sio
from competesmoe_tpu_torch.models import vision as tvision
from tests.test_torch_port_models import IMG, port_llava_cfg
from tests.test_torch_port_ops import port_config

TOL = dict(rtol=1e-5, atol=1e-5)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def clip_cfg(moe_name="competesmoe"):
    return jvision.VisionConfig(
        hidden_size=16, intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=2, image_size=28, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu", use_cls_token=True,
        tower_type="clip", moe_name=moe_name, num_experts=4, num_selected=2)


def pixels(seed=0, B=2, size=28):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, size, size, 3)).astype(np.float32)


def hf_clip_sd(cfg, seed=0, moe=True):
    """A CLIP vision state dict in HF's layout (`vision_model.` names;
    trained MoE `moelayer.experts.<i>` or dense `mlp.fc1/fc2`)."""
    rng = np.random.default_rng(seed)
    d, i = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return rng.normal(0, 0.2, shape).astype(np.float32)

    p = "vision_model."
    sd = {p + "embeddings.patch_embedding.weight": r(d, 3, 14, 14),
          p + "embeddings.class_embedding": r(d),
          p + "embeddings.position_embedding.weight":
              r(cfg.num_patches + 1, d),
          p + "pre_layrnorm.weight": 1 + r(d), p + "pre_layrnorm.bias": r(d)}
    for li in range(cfg.num_hidden_layers):
        q = f"{p}encoder.layers.{li}."
        for n in ("layer_norm1", "layer_norm2"):
            sd[q + n + ".weight"] = 1 + r(d)
            sd[q + n + ".bias"] = r(d)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[q + f"self_attn.{n}.weight"] = r(d, d)
            sd[q + f"self_attn.{n}.bias"] = r(d)
        mlps = ([f"moelayer.experts.{e}." for e in range(cfg.num_experts)]
                if moe else ["mlp."])
        for m in mlps:
            sd[q + m + "fc1.weight"] = r(i, d)
            sd[q + m + "fc1.bias"] = r(i)
            sd[q + m + "fc2.weight"] = r(d, i)
            sd[q + m + "fc2.bias"] = r(d)
        if moe:
            sd[q + "moelayer.gate.weight"] = r(cfg.num_experts, d)
    return sd


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select", ["patch", "cls_patch"])
def test_clip_tower_matches_jax(select):
    """Class token, pre_layrnorm, quick_gelu MoE experts, the state
    entering the last layer; 'patch' drops the class token. Features,
    aux loss and each layer's routing equal JAX's."""
    jc = clip_cfg()
    px = pixels()
    tower = jvision.CLIPSMoEVisionTower(jc, select_feature=select)
    params = tower.init(jax.random.PRNGKey(1), px)
    jf, jaux, jauxes = tower.apply(params, px, return_id_experts=True)
    pt = tvision.CLIPSMoEVisionTower(port_config(jc, tvision.VisionConfig),
                                     device="cpu", select_feature=select)
    pt.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        tf, taux, tauxes = pt(torch.as_tensor(px), return_id_experts=True)
    assert tf.shape == (2, 4 + (select == "cls_patch"), 16)
    close(jf, tf)
    close(jaux, taux)
    for ja, ta in zip(jauxes, tauxes):
        np.testing.assert_array_equal(np.asarray(ja.selected_experts),
                                      ta.selected_experts.numpy())


@pytest.mark.parametrize("case", ["trained", "upcycle", "dense"])
def test_convert_clip_tower_matches_jax(case):
    """One HF-layout CLIP state dict through both converters: the port's
    tensors equal `from_jax_params` of JAX's tree, bit for bit (upcycling
    draws the same fresh gates), and the towers' features agree; the
    state dict nested under `vision_model.` with no prefix given reads
    the same."""
    jc = clip_cfg(None if case == "dense" else "smoe")
    sd = hf_clip_sd(jc, moe=case == "trained")
    up = case == "upcycle"
    jtree = jloader.convert_clip_tower(sd, jc, upcycle=up)
    tcfg = port_config(jc, tvision.VisionConfig)
    tsd = {k: torch.as_tensor(v) for k, v in sd.items()}
    got = tloader.convert_clip_tower(tsd, tcfg, upcycle=up)
    want = from_jax_params(jtree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k
    nested = tloader.convert_clip_tower(tsd, tcfg, prefix="", upcycle=up)
    assert all(torch.equal(nested[k], got[k]) for k in got)
    pt = tvision.CLIPSMoEVisionTower(tcfg, device="cpu")
    pt.load_state_dict(got)
    px = pixels(3)
    jf = jvision.CLIPSMoEVisionTower(jc).apply({"params": jtree}, px)[0]
    with torch.no_grad():
        close(jf, pt(torch.as_tensor(px))[0])


# ---------------------------------------------------------------------------
# the projector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 3])
def test_mlp_gelu_projector_load_export_match_jax(depth):
    """mlpNx_gelu: N Linears with an exact GELU between them. Outputs
    equal JAX's; the reference-layout Sequential state dict (JAX's
    export) loads in both builders to equal tensors, and the port's
    export equals JAX's key for key."""
    jc = jproj.ProjectorConfig(projector_type=f"mlp{depth}x_gelu",
                               mm_hidden_size=16, hidden_size=24)
    x = np.random.default_rng(4).normal(size=(2, 5, 16)).astype(np.float32)
    module = jproj.VisionProjector(jc)
    params = module.init(jax.random.PRNGKey(2), x)
    pt = tproj.VisionProjector(port_config(jc, tproj.ProjectorConfig),
                               device="cpu")
    pt.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        close(module.apply(params, x)[0], pt(torch.as_tensor(x))[0])
    sd = {k: np.asarray(v) for k, v in jexport.export_plain_projector(
        params["params"], prefix="").items()}
    assert sorted(sd) == sorted(f"{2 * i}.{w}" for i in range(depth)
                                for w in ("weight", "bias"))
    want = from_jax_params(jbuilder._convert_plain_projector(sd, jc))
    got = tbuilder._convert_plain_projector(
        {k: torch.as_tensor(v) for k, v in sd.items()},
        port_config(jc, tproj.ProjectorConfig))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    out = texport.export_plain_projector(pt, prefix="")
    assert sorted(out) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(out[k].numpy(), sd[k], k)


# ---------------------------------------------------------------------------
# S²
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_chessboard_split_and_merge_match_jax(n):
    x = np.random.default_rng(5).normal(size=(2, 12, 12, 3)).astype(
        np.float32)
    js = np.asarray(jvision.split_chessboard(jnp.asarray(x), n))
    ts = tvision.split_chessboard(torch.as_tensor(x), n)
    np.testing.assert_array_equal(js, ts.numpy())
    np.testing.assert_array_equal(
        np.asarray(jvision.merge_chessboard(jnp.asarray(js), n)),
        tvision.merge_chessboard(ts, n).numpy())
    np.testing.assert_array_equal(tvision.merge_chessboard(ts, n).numpy(),
                                  x)


def _patch_means(px):
    """A stand-in tower over [N, H, W, C]: the mean of each 7 x 7 patch's
    pixels times a fixed [C, 5] matrix, [N, (H/7)^2, 5]."""
    w = np.random.default_rng(6).normal(size=(3, 5)).astype(np.float32)
    n, h, _, c = px.shape
    g = h // 7
    if isinstance(px, torch.Tensor):
        p = px.reshape(n, g, 7, g, 7, c).mean(dim=(2, 4))
        return p.reshape(n, g * g, c) @ torch.as_tensor(w)
    p = px.reshape(n, g, 7, g, 7, c).mean(axis=(2, 4))
    return p.reshape(n, g * g, c) @ jnp.asarray(w)


@pytest.mark.parametrize("scales,size", [((1, 2), 14), ((1, 3), 14),
                                         ((2,), 21)])
def test_multiscale_features_match_jax(scales, size):
    """S² over a stand-in tower: each scale's image is a bilinear resize
    (upsampling), its tiles' grids merge and, for s > 1, shrink back to
    the base grid (a downsampling resize: `jax.image.resize`
    antialiases, so the port's F.interpolate takes antialias=True with
    half-pixel centres). Within 1e-5 of JAX's; without the antialias the
    shrink differs."""
    px = pixels(7, B=2, size=size)
    want = np.asarray(jvision.multiscale_features(
        _patch_means, jnp.asarray(px), scales=scales, base_size=14))
    got = tvision.multiscale_features(_patch_means, torch.as_tensor(px),
                                      scales=scales, base_size=14)
    close(want, got.numpy())
    grid = torch.as_tensor(np.random.default_rng(8).normal(
        size=(1, 6, 6, 2)).astype(np.float32))
    jgrid = np.asarray(jax.image.resize(jnp.asarray(grid.numpy()),
                                        (1, 2, 2, 2), method="linear"))
    close(jgrid, tvision._resize_bilinear(grid, 2).numpy())
    plain = torch.nn.functional.interpolate(
        grid.permute(0, 3, 1, 2), size=(2, 2), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - jgrid).max() > 1e-2


# ---------------------------------------------------------------------------
# a CLIP LLaVA end to end
# ---------------------------------------------------------------------------

MISTRAL_TINY = dict(
    model_type="mistral", vocab_size=64, hidden_size=32,
    intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=256, sliding_window=6,
    mm_vision_tower="openai/clip-vit-large-patch14-336",
    mm_hidden_size=16, mm_projector_type="mlp2x_gelu", moe_name="smoe",
    num_experts=4, num_selected=2, clip_smoe=True, mlp_smoe=False,
    scales=[1], vision_config=dict(hidden_size=16, intermediate_size=32,
                                   num_hidden_layers=3,
                                   num_attention_heads=2, image_size=28,
                                   patch_size=14),
    tokenizer_model_max_length=256)


def _clip_checkpoint(path, seed=0):
    """A CLIP LLaVA checkpoint in the reference's layout: the HF CLIP
    tower under model.vision_tower.vision_tower., the projector's
    Sequential and a Mistral decoder (the port's exports of a model with
    random weights)."""
    cfg = tbuilder.llava_config_from_hf(MISTRAL_TINY, "llava-mistral",
                                        torch.float32)
    model = tbuilder.build_llava(cfg, seed=seed, device="cpu")
    sd = {"model.vision_tower.vision_tower." + k[len("vision_model."):]: v
          for k, v in hf_clip_sd(clip_cfg("smoe"), seed).items()}
    sd.update({k: torch.as_tensor(v) for k, v in sd.items()})
    sd.update(texport.export_plain_projector(model.mm_projector,
                                             prefix="model.mm_projector."))
    sd.update(texport.export_decoder(model.language_model, cfg.decoder,
                                     prefix="model."))
    path.mkdir(parents=True, exist_ok=True)
    sio.save_file(sd, path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(MISTRAL_TINY))
    return path


def test_clip_llava_loads_and_decodes_like_jax(tmp_path):
    """Both builders load one CLIP + mlp2x_gelu + Mistral (GQA, window 6)
    checkpoint from a directory named for Mistral: the same config, the
    port's tensors equal `from_jax_params` of JAX's, and greedy tokens
    of an image prompt and a text prompt (both longer than the window)
    equal JAX's."""
    ckpt = _clip_checkpoint(tmp_path / "llava-mistral-clip")
    _, model, _, _ = tbuilder.load_pretrained_model(
        ckpt, dtype=torch.float32, device="cpu")
    jm, jv = jbuilder.load_pretrained_model(ckpt, dtype=jnp.float32)[1:3]
    assert isinstance(model.vision_tower, tvision.CLIPSMoEVisionTower)
    assert model.cfg.decoder.sliding_window == 6
    assert not model.cfg.decoder.fused_qkv
    assert port_llava_cfg(jm.cfg) == model.cfg
    want = from_jax_params(jv)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(9)
    ids = rng.integers(2, 64, (1, 11)).astype(np.int32)
    ids[0, 3] = IMG
    px = pixels(10, B=1)
    for p_ids, p_px in ((ids, px), (ids[:, 4:], None)):
        a = tllava.generate(model, p_ids, p_px, max_new_tokens=8)[0]
        b = jllava.generate(jm, jv, p_ids, p_px, max_new_tokens=8)[0]
        np.testing.assert_array_equal(a, np.asarray(b))


def test_clip_export_refused_in_the_port_and_failing_in_jax(tmp_path):
    """JAX's export_llava_checkpoint writes SigLIP's names for any tower:
    on a CLIP tree it fails (no patch-conv bias). The port refuses a CLIP
    model with a message that says why."""
    ckpt = _clip_checkpoint(tmp_path / "llava-mistral-clip")
    jm, jv = jbuilder.load_pretrained_model(ckpt, dtype=jnp.float32)[1:3]
    with pytest.raises(KeyError, match="bias"):
        jexport.export_llava_checkpoint(jv["params"], jm.cfg)
    _, model, _, _ = tbuilder.load_pretrained_model(
        ckpt, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="SigLIP"):
        texport.export_llava_checkpoint(model)


def test_clip_llava_training_steps_match_jax():
    """Two sft steps of a CLIP LLaVA (CompeteSMoE tower and projector,
    a windowed GQA decoder: training takes the window on the no-cache
    mask path) through JAX's make_mm_train_step and the port's, which
    cli/train_mm runs: metrics and parameters as
    tests/test_torch_port_mm_train.py holds them."""
    from competesmoe_tpu.train import mm_task as jmm
    from competesmoe_tpu.train.lm_trainer import TrainState
    from competesmoe_tpu_torch.train import mm_task as tmm
    from tests.test_torch_port_mm_train import (_metrics_close,
                                                _params_close, port_model,
                                                small_batch, small_cfg,
                                                tcfg_for)
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(
            cfg.vision, tower_type="clip", use_cls_token=True,
            hidden_act="quick_gelu", layer_norm_eps=1e-5),
        decoder=dataclasses.replace(cfg.decoder, fused_qkv=False,
                                    num_attention_heads=4,
                                    num_key_value_heads=2,
                                    sliding_window=5))
    b = small_batch()
    params = jllava.LlavaModel(cfg).init(
        jax.random.PRNGKey(0), b["input_ids"], b["images"],
        labels=b["labels"], train=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert "class_embedding" in params["vision_tower"]["embeddings"]
    jt = jmm.MMTrainConfig(**tcfg_for("sft", False))
    tt = tmm.MMTrainConfig(**tcfg_for("sft", False))
    jvis, jproj = jmm.build_mm_schedules(cfg, jt)
    vis, proj = tmm.build_mm_schedules(port_llava_cfg(cfg), tt)
    jmodel = jllava.LlavaModel(cfg, vision_flip_schedule=jvis,
                               projector_flip_schedule=jproj)
    jopt = jmm.make_mm_optimizer(jt, params)
    jstate = TrainState.create(params, jopt)
    jstep = jmm.make_mm_train_step(jmodel, jopt, donate=False)
    model = port_model(cfg, params, vis, proj)
    assert isinstance(model.vision_tower, tvision.CLIPSMoEVisionTower)
    opt = tmm.make_mm_optimizer(tt)
    state = tmm.MMTrainState.create(model, opt)
    step = tmm.make_mm_train_step(model, opt)
    batch = small_batch(1)
    for i in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, tmm.batch_to(batch, "cpu"))
        _metrics_close(m, jm, f"clip step {i}")
        _params_close(model, jstate.params, f"clip step {i}")
