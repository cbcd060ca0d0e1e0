"""Parity of the port's multimodal training slice (train/mm_task.py,
train/lora.py, quant_opt, the competition step, the LLaVA loss) with the
JAX package as a whole, at the small geometry of tests/test_mm_train.py
(widened so that some parameters reach quant_opt's 4,096-element
threshold).

Three optimizer steps of JAX's `make_mm_train_step` against the port's,
from the same flax weights (`convert.from_jax_params`) on the same numpy
batch, over stage (pretrain, pft, sft), microbatches (1, 2) and 8-bit
moments (on, off): the metrics and every parameter after each step, and
`is_comp` per competing layer against `FlipSchedule.is_flip`. Then LoRA
steps and the eval step.

Tolerances: metrics rtol 1e-4; parameters atol 2e-5 + rtol 1e-4 (float32
sums in another order, through three Adam steps at lr 1e-3), but the
tower's key biases and, with 8-bit moments, at most 0.5% of a tensor's
elements, each within 3 lr (see `_params_close`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.train import lora as jlora
from competesmoe_tpu.train import mm_task as jmm
from competesmoe_tpu.train.lm_trainer import TrainState
from competesmoe_tpu_torch.convert import from_jax_lora, from_jax_params
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.train import lora as tlora
from competesmoe_tpu_torch.train import mm_task as tmm
from competesmoe_tpu_torch.train.lm_trainer import OptConfig, make_optimizer
from tests.test_torch_port_models import IMG, jax_llava_cfg, port_llava_cfg

MET_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)


def small_cfg():
    """tests/test_mm_train.py's geometry, CompeteSMoE in the tower and the
    projector, with a vocab of 256 and widths of 32 (the embedding, the
    lm_head, the decoder's gate_up, the tower's and the projector's first
    expert weights take 8-bit moments; the rest stay float)."""
    cfg = jax_llava_cfg()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, hidden_size=32,
                                   intermediate_size=64),
        projector=dataclasses.replace(cfg.projector, mm_hidden_size=32,
                                      hidden_size=32),
        decoder=dataclasses.replace(cfg.decoder, vocab_size=256,
                                    hidden_size=32, intermediate_size=96))


def small_batch(seed=0, B=4, L=12):
    """Rows 0-2 with an image token, row 3 text-only (a zero image, as the
    collator pads it); row 1 right-padded; labels masked at the prompt."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (B, L)).astype(np.int32)
    ids[:3, 2] = IMG
    labels = ids.copy()
    labels[:, :4] = -100
    labels[:3, 2] = -100
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    ids[1, 9:] = 0
    labels[1, 9:] = -100
    px = rng.uniform(-1, 1, (B, 28, 28, 3)).astype(np.float32)
    px[3] = 0.0
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "images": px}


@pytest.fixture(scope="module")
def weights():
    cfg = small_cfg()
    b = small_batch()
    params = jllava.LlavaModel(cfg).init(
        jax.random.PRNGKey(0), b["input_ids"], b["images"],
        labels=b["labels"], train=True)["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def tcfg_for(stage, state_8bit):
    return dict(stage=stage, learning_rate=1e-3, warmup_ratio=0.2,
                total_steps=10, rate_flip=0.5, max_compete_in_iter=2,
                schedule_seed=1, opt_state_8bit=state_8bit)


def port_model(cfg, params, vis, proj):
    model = tllava.LlavaModel(port_llava_cfg(cfg), device="cpu",
                              vision_flip_schedule=vis,
                              projector_flip_schedule=proj)
    model.load_state_dict(from_jax_params(params))
    return model


def _metrics_close(got, want, what):
    for key in ("loss/total", "loss/aux_mlp", "loss/aux_clip", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   **MET_TOL, err_msg=f"{what} {key}")


def _params_close(model, jparams, what, state_8bit=False):
    want = from_jax_params(jparams)
    got = model.state_dict()
    assert set(want) == set(got)
    for key, v in want.items():
        if state_8bit and not key.endswith("k_proj.bias"):
            # a moment one ulp apart can round to the neighbouring 8-bit
            # code: a few elements per tensor then take another step, of
            # at most lr (1e-3) a step
            g, w = got[key].numpy(), v.numpy()
            off = np.abs(g - w) > PARAM_TOL["atol"] + PARAM_TOL[
                "rtol"] * np.abs(w)
            assert off.mean() <= 5e-3, (what, key, off.mean())
            np.testing.assert_allclose(g, w, rtol=0, atol=3e-3,
                                       err_msg=f"{what} {key}")
            continue
        # a key projection's bias adds the same q.b to every score of a
        # query, which the softmax cancels: its gradient is 0 but for
        # rounding, and Adam turns that noise into steps of up to lr, in
        # either direction, on both sides
        tol = (dict(rtol=0, atol=3 * 1e-3) if key.endswith("k_proj.bias")
               else PARAM_TOL)
        np.testing.assert_allclose(got[key].numpy(), v.numpy(), **tol,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("stage", ["pretrain", "pft", "sft"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("state_8bit", [False, True])
def test_mm_train_steps_match_jax(weights, stage, n_micro, state_8bit):
    cfg, params = weights
    jt = jmm.MMTrainConfig(**tcfg_for(stage, state_8bit))
    tt = tmm.MMTrainConfig(**tcfg_for(stage, state_8bit))
    jvis, jproj = jmm.build_mm_schedules(cfg, jt)
    vis, proj = tmm.build_mm_schedules(port_llava_cfg(cfg), tt)
    np.testing.assert_array_equal(vis.flips, jvis.flips)
    np.testing.assert_array_equal(proj.flips, jproj.flips)
    jmodel = jllava.LlavaModel(cfg, vision_flip_schedule=jvis,
                               projector_flip_schedule=jproj)
    jopt = jmm.make_mm_optimizer(jt, params)
    jstate = TrainState.create(params, jopt)
    jstep = jmm.make_mm_train_step(jmodel, jopt, donate=False,
                                   n_microbatch=n_micro)
    model = port_model(cfg, params, vis, proj)
    opt = tmm.make_mm_optimizer(tt)
    state = tmm.MMTrainState.create(model, opt)
    step = tmm.make_mm_train_step(model, opt, n_microbatch=n_micro)
    if state_8bit:
        from competesmoe_tpu_torch.train.quant_opt import QuantLeaf
        quant = [k for g in state.opt_state.values() if g is not None
                 for k, v in g.mu.items() if isinstance(v, QuantLeaf)]
        assert quant, "no parameter took 8-bit moments"
    batch = small_batch(1)
    flips = 0
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, tmm.batch_to(batch, "cpu"))
        what = f"{stage} n_micro {n_micro} 8bit {state_8bit} step {i}"
        _metrics_close(m, jm, what)
        _params_close(model, jstate.params, what, state_8bit)
        want = [vis.is_flip(li, i) for li in range(vis.n_layers)]
        assert m["vision/is_comp"].tolist() == [float(w) for w in want]
        assert float(m["projector/is_comp"]) == float(proj.is_flip(0, i))
        for li, comp in enumerate(want):
            assert (float(m["vision/routerloss"][li]) > 0) == comp, what
        flips += sum(want) + proj.is_flip(0, i)
    assert flips, "the schedule gave no competition in 3 steps"
    frozen = ("vision_tower.", "language_model.")
    init = from_jax_params(params)
    for key, p in model.state_dict().items():
        moved = not torch.equal(p, init[key])
        if stage == "pretrain" and key.startswith(frozen):
            assert not moved, key


def test_mm_lora_and_eval_steps_match_jax(weights):
    """Two LoRA steps (the CLI's clip_by_global_norm(1.0) -> adamw(lr,
    wd 0), microbatches 2) from JAX's adapters carried across by
    convert.from_jax_lora, then the eval step on the trained model."""
    import optax
    cfg, params = weights
    tt = tmm.MMTrainConfig(**tcfg_for("sft", False))
    vis, proj = tmm.build_mm_schedules(port_llava_cfg(cfg), tt)
    jvis, jproj = jmm.build_mm_schedules(cfg, jmm.MMTrainConfig(
        **tcfg_for("sft", False)))
    jmodel = jllava.LlavaModel(cfg, vision_flip_schedule=jvis,
                               projector_flip_schedule=jproj)
    rank, scaling = 4, jlora.lora_scaling(4, 8.0)
    jl = jlora.init_lora_params(params, rank, jax.random.PRNGKey(3))
    # B = 0 at init; start from nonzero factors so both carry signal
    jl = {k: {"a": np.asarray(v["a"]),
              "b": np.asarray(jax.random.normal(
                  jax.random.PRNGKey(i), v["b"].shape) * 0.05)}
          for i, (k, v) in enumerate(sorted(jl.items()))}
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(1e-3, weight_decay=0.0))
    jstate = TrainState.create(jl, jopt)
    jstep = jlora.make_mm_lora_train_step(jmodel, jopt, scaling,
                                          donate=False, n_microbatch=2)
    model = port_model(cfg, params, vis, proj)
    lora = tlora.init_lora_params(model, rank, torch.Generator())
    assert "language_model.lm_head" not in lora.names
    lora.load_factors(from_jax_lora(jl))
    opt = make_optimizer(OptConfig(lr=1e-3, lr_sched="constant",
                                   grad_clip=1.0, weight_decay=0.0))
    state = tmm.MMTrainState.create(lora, opt)
    step = tlora.make_mm_lora_train_step(model, opt, scaling,
                                         n_microbatch=2)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    batch = small_batch(2)
    for i in range(2):
        jstate, jm = jstep(jstate, params, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        state, m = step(state, tmm.batch_to(batch, "cpu"))
        _metrics_close(m, jm, f"lora step {i}")
        want = from_jax_lora(jstate.params)
        for name, ab in lora.factors().items():
            for part in ("a", "b"):
                np.testing.assert_allclose(
                    ab[part].detach().numpy(), want[name][part].numpy(),
                    **PARAM_TOL, err_msg=f"lora {name} {part}")
    for key, v in model.state_dict().items():
        assert torch.equal(v, base[key]), f"LoRA moved the base {key}"
    # the eval step on the base model folded with the trained adapters
    eff = jlora.apply_lora(params, jstate.params, scaling)
    want = jmm.make_mm_eval_step(jmodel)(eff, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
    with tlora.apply_lora(model, lora, scaling):
        got = tmm.make_mm_eval_step(model)(tmm.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), **MET_TOL)


def test_anyres_and_multi_image_feature_blocks_match_jax(weights):
    """Multi-tile pixel batches [B, M, H, W, C] through encode_images and
    the splice: 'multi' (an image token per tile) and 'anyres' (the tiles
    as one block at one image token), loss and logits against JAX."""
    cfg, params = weights
    rng = np.random.default_rng(7)
    B, L, M = 2, 10, 3
    for splice in ("multi", "anyres"):
        jcfg = dataclasses.replace(cfg, image_splice=splice)
        ids = rng.integers(1, 256, (B, L)).astype(np.int32)
        ids[:, 1] = IMG
        if splice == "multi":
            ids[:, 4] = IMG
            ids[0, 7] = IMG
        labels = ids.copy()
        px = rng.uniform(-1, 1, (B, M, 28, 28, 3)).astype(np.float32)
        out = jllava.LlavaModel(jcfg).apply({"params": params}, ids, px,
                                            labels=labels)
        model = tllava.LlavaModel(dataclasses.replace(
            port_llava_cfg(jcfg), image_splice=splice), device="cpu")
        model.load_state_dict(from_jax_params(params))
        with torch.no_grad():
            got = model(torch.as_tensor(ids).long(), torch.as_tensor(px),
                        labels=torch.as_tensor(labels).long())
        np.testing.assert_allclose(got.logits.numpy(), out.logits,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(got.loss), float(out.loss),
                                   **MET_TOL)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(out.labels))
