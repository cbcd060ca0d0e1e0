"""Parity of the port's LM training slice with the JAX package: the flip
schedule, the pretrain losses, the keys/values expert paths with K1's
plain version, the CompeteSMoE pretrain layer, FastRope attention with
K2's plain version, the LM and its optimizer steps, and the CLI task.

Inputs are made with numpy from a seed and fed to both packages; weights
go from the flax tree to the port through `convert.from_jax_params`.
Tolerance: float32 rtol/atol 1e-4 (reordered f32 sums) unless a test
states another. JAX's Pallas K1 runs in interpret mode; its flash
attention has no CPU path, so the port's flash backend (K2's plain
version) is held against JAX's einsum backend, which computes the same
function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.moe import pretrain_layers as jpl
from competesmoe_tpu.moe import schedule as jsched
from competesmoe_tpu.ops import expert_compute as jec
from competesmoe_tpu.ops import gmm_fused as jgmm
from competesmoe_tpu.ops import losses as jlosses
from competesmoe_tpu.train import lm_trainer as jtrainer
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import lm as tlm
from competesmoe_tpu_torch.moe import MoEArgs, get_pretrain_moe
from competesmoe_tpu_torch.moe import pretrain_layers as tpl
from competesmoe_tpu_torch.moe import schedule as tsched
from competesmoe_tpu_torch.ops import expert_compute as tec
from competesmoe_tpu_torch.ops import flash_attention as tfa
from competesmoe_tpu_torch.ops import gmm_fused as tgmm
from competesmoe_tpu_torch.ops import losses as tlosses
from competesmoe_tpu_torch.train import lm_trainer as ttrainer

TOL = dict(rtol=1e-4, atol=1e-4)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def t(a):
    return torch.from_numpy(np.array(a))


def port_args(a: JMoEArgs) -> MoEArgs:
    return MoEArgs(**dataclasses.asdict(a))


# ---------------------------------------------------------------------------
# flip schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,total,warm,rate,cap,seed", [
    (2, 12, 0.0, 0.5, 2, 0), (4, 200, 0.1, 0.3, 1, 3),
    (16, 1000, 0.0, 0.07, 3, 0), (7, 300, 0.05, 0.9, 2, 11)])
def test_flip_schedule_identical_and_round_trips(n_layers, total, warm,
                                                 rate, cap, seed):
    js = jsched.build_flip_schedule(n_layers, total, warm, rate, cap,
                                    seed=seed)
    ts = tsched.build_flip_schedule(n_layers, total, warm, rate, cap,
                                    seed=seed)
    assert (js.step_warm, js.flip_steps) == (ts.step_warm, ts.flip_steps)
    np.testing.assert_array_equal(js.flips, ts.flips)
    back = tsched.schedule_from_dict(jsched.schedule_to_dict(js))
    np.testing.assert_array_equal(back.flips, js.flips)
    forth = jsched.schedule_from_dict(tsched.schedule_to_dict(ts))
    np.testing.assert_array_equal(forth.flips, ts.flips)
    assert all(js.is_flip(i, s) == ts.is_flip(i, s)
               for i in range(n_layers) for s in range(0, total, 7))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["entropy_from_logprobs", "entropy",
                                  "log_mean", "entropy_balance_loss",
                                  "diversity_loss", "router_mse_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 20, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0, :2] = 0.0                           # clipped by eps
    args = {
        "entropy_from_logprobs": (logits - np.log(np.exp(logits).sum(
            -1, keepdims=True)),),
        "entropy": (probs,),
        "log_mean": (logits,),
        "entropy_balance_loss": (logits,),
        "diversity_loss": (rng.normal(size=(5, 4, 16)).astype(np.float32),),
        "router_mse_loss": (probs, probs[::-1].copy()),
    }[name]
    want = getattr(jlosses, name)(*map(jnp.asarray, args))
    got = getattr(tlosses, name)(*map(t, args))
    close(want, got)


# ---------------------------------------------------------------------------
# keys/values experts and K1
# ---------------------------------------------------------------------------

def _kv_inputs(T=64, D=128, E=8, ES=128, k=2, skew=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    keys = (rng.normal(size=(E, D, ES)) * 0.04).astype(np.float32)
    values = (rng.normal(size=(E, ES, D)) * 0.01).astype(np.float32)
    if skew:     # as tests/test_gmm_fused.py: experts 0-2, 4-6 empty
        sel = np.zeros((T, k), np.int32)
        sel[:, 1] = 7
        sel[:3, 0] = 3
    else:
        sel = np.stack([rng.choice(E, k, replace=False)
                        for _ in range(T)]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(T, k)).astype(np.float32)
    return x, sel, w / w.sum(-1, keepdims=True), keys, values


@pytest.mark.parametrize("impl", ["dense", "grouped", "fused", "auto"])
def test_moe_ffn_kv_matches_jax(impl):
    """On the CPU 'fused' falls back to 'grouped' in both packages
    (fused_path_available asks for the accelerator)."""
    x, sel, w, keys, values = _kv_inputs(D=32, ES=16)
    want = jec.moe_ffn_kv(*map(jnp.asarray, (x, sel, w, keys, values)),
                          jax.nn.relu, impl=impl)
    got = tec.moe_ffn_kv(*map(t, (x, sel, w, keys, values)), torch.relu,
                         impl=impl)
    close(want, got)


def test_moe_ffn_kv_ep_raises():
    x, sel, w, keys, values = map(t, _kv_inputs(D=32, ES=16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tec.moe_ffn_kv(x, sel, w, keys, values, torch.relu, impl="ep")


@pytest.mark.parametrize("skew", [False, True])
def test_fused_pipeline_matches_jax_interpret(skew):
    """The port's K1 pipeline on the CPU (the kernel's plain version)
    against JAX's with the Pallas kernel interpreted, including skewed
    and empty groups; the aligned layout arrays are bit-identical."""
    x, sel, w, keys, values = _kv_inputs(skew=skew)
    jgs, jtok, jte, jshift = jgmm._aligned_layout(jnp.asarray(sel), 8)
    tgs, ttok, tte, tshift = tgmm.aligned_layout(t(sel), 8)
    for a, b in ((jtok, ttok), (jte, tte), (jshift, tshift),
                 (jgs.inv_perm, tgs.inv_perm)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = jgmm.fused_grouped_ffn_kv_fwd(
        *map(jnp.asarray, (x, sel, w, keys, values)), interpret=True)
    before = tgmm.gmm2_fused_aligned.launches
    got = tgmm.fused_grouped_ffn_kv_fwd(*map(t, (x, sel, w, keys, values)))
    assert tgmm.gmm2_fused_aligned.launches == before   # CPU: plain version
    close(want, got, rtol=1e-5, atol=1e-6)


def test_fused_gradients_match_jax_vjp():
    x, sel, w, keys, values = _kv_inputs()

    def jloss(x, w, k, v):
        o = jgmm.fused_grouped_ffn_kv(x, jnp.asarray(sel), w, k, v)
        return (o ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, keys, values)))
    leaves = [t(a).requires_grad_() for a in (x, w, keys, values)]
    out = tgmm.fused_grouped_ffn_kv(leaves[0], t(sel), *leaves[1:])
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for a, b in zip(want, got):
        close(a, b, rtol=1e-4, atol=1e-6)


def test_jax_pretrain_activation_misses_the_fused_rule():
    """JAX's MoEUTBase passes its own relu wrapper, which fails
    fused_path_available's identity test, so `-moe.impl fused` never
    reaches the Pallas kernel there (ROADMAP section 3). The port passes
    torch.relu itself, the function its rule names."""
    assert jpl.MoEUTBase.activation is not jax.nn.relu
    assert tpl.MoEUTBase.activation is torch.relu
    x = torch.zeros(4, 128)
    assert not tgmm.fused_path_available(x, torch.zeros(2, 128, 128),
                                         torch.relu)   # CPU tensor


def test_fused_path_refusal_names_the_reason():
    """The reason `moe_ffn_kv(impl='fused')` raises with on CUDA tensors
    (JAX's rule, device aside); None where K1 can run."""
    x, keys = torch.zeros(4, 128), torch.zeros(2, 128, 256)
    assert tgmm.fused_path_refusal(x, keys, torch.relu) is None
    assert "activation" in tgmm.fused_path_refusal(x, keys, tec.gelu_tanh)
    assert "bias" in tgmm.fused_path_refusal(x, keys, torch.relu,
                                             torch.zeros(2, 256))
    assert "multiples of 128" in tgmm.fused_path_refusal(
        torch.zeros(4, 96), torch.zeros(2, 96, 128), torch.relu)
    assert "multiples of 128" in tgmm.fused_path_refusal(
        x, torch.zeros(2, 128, 64), torch.relu)


# ---------------------------------------------------------------------------
# the pretrain MoE layers
# ---------------------------------------------------------------------------

_LAYER_ARGS = JMoEArgs(hybrid=True, router_theta=0.2, router_loss_coef=0.001,
                       balance_affinity=True, rate_flip=0.07,
                       max_compete_in_iter=3)


@pytest.mark.parametrize("name,step", [("competesmoe", 0),
                                       ("competesmoe", 1), ("smoe", 0)])
def test_pretrain_layer_matches_jax(name, step):
    """Output, selection, every aux key and the gradients, on a step
    where the layer competes (competesmoe, step 1) and where it does not
    (step 0)."""
    flips = np.array([False, True, False])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    jcls = {"competesmoe": jpl.PretrainCompeteSMoE,
            "smoe": jpl.PretrainSMoE}[name]
    jl = jcls(dmodel=32, n_experts=8, expert_size=16, n_heads=2,
              args=_LAYER_ARGS, weight_scale=0.7)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    kw = {"flips": flips} if name == "competesmoe" else {}

    def jf(p, x):
        out, aux = jl.apply(p, x, step=step, train=True,
                            return_id_experts=True, **kw)
        return (out ** 2).sum() + aux.aux_loss, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tl = get_pretrain_moe(name)(32, 8, 16, 2, args=port_args(_LAYER_ARGS),
                                weight_scale=0.7, device="cpu")
    tl.load_state_dict(from_jax_params(params))
    xt = t(x).requires_grad_()
    tout, taux = tl(xt, step=step, train=True, return_id_experts=True, **kw)
    loss = (tout ** 2).sum() + taux.aux_loss
    grads = torch.autograd.grad(loss, [xt, *tl.parameters()])
    close(jout, tout.detach())
    close(jaux.aux_loss, taux.aux_loss.detach())
    np.testing.assert_array_equal(np.asarray(jaux.selected_experts),
                                  taux.selected_experts.numpy())
    close(jaux.gate_softmax, taux.gate_softmax)
    assert set(jaux.losses) == set(taux.losses)
    for key in jaux.losses:
        close(jaux.losses[key], taux.losses[key])
    if name == "competesmoe":
        assert float(taux.losses["mlp_is_comp"]) == float(flips[step])
    close(jgrads[1], grads[0])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads[0]))
    for (pname, _), g in zip(tl.named_parameters(), grads[1:]):
        close(want[pname], g, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# attention (K2's plain version) and the LM
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    base = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                n_experts=8, expert_size=8, moe_topk=2,
                moe_name="competesmoe", moe_args=_LAYER_ARGS)
    base.update(kw)
    jcfg = jlm.LMConfig(**base, dtype=jnp.float32, attn_backend="einsum")
    targs = dict(base, moe_args=port_args(base["moe_args"]))
    return jcfg, tlm.LMConfig(**targs, attn_backend="flash")


def test_fast_rope_attention_flash_matches_jax_einsum():
    """Head size 82 (the 154M geometry's): the port's flash backend on
    the CPU, forward and gradients, against JAX's einsum backend."""
    jcfg, tcfg = _cfgs(d_model=64, head_dim=82)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 21, 64)).astype(np.float32)
    ja = jlm.FastRopeAttention(jcfg)
    params = ja.init(jax.random.PRNGKey(2), jnp.asarray(x))
    out, jgrads = jax.value_and_grad(
        lambda p, x: (ja.apply(p, x) ** 2).sum(), argnums=(0, 1))(
        params, jnp.asarray(x))
    ta = tlm.FastRopeAttention(tcfg, device="cpu")
    ta.load_state_dict(from_jax_params(params))
    xt = t(x).requires_grad_()
    counts = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dkv,
                                   tfa.flash_attention_bwd_dq)]
    loss = (ta(xt) ** 2).sum()
    grads = torch.autograd.grad(loss, [xt, *ta.parameters()])
    assert counts == [f.launches for f in (tfa.flash_attention_fwd,
                                           tfa.flash_attention_bwd_dkv,
                                           tfa.flash_attention_bwd_dq)]
    close(out, loss.detach(), rtol=1e-4)
    close(jgrads[1], grads[0])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads[0]))
    for (name, _), g in zip(ta.named_parameters(), grads[1:]):
        close(want[name], g)


@pytest.mark.parametrize("n_microbatch,steps", [(1, 3), (2, 2)])
def test_lm_train_steps_match_jax(n_microbatch, steps):
    """A tiny CompeteSMoE LM: steps of `make_train_step` (adamw,
    clipping, warmup, cosine; one or two microbatches) from the same
    weights, batches and flip schedule; steps 0, 1, 2 have 0, 2 and 1
    competing layers. Losses, grad_norm, the competesmoe metrics and the
    parameters after the steps agree."""
    jcfg, tcfg = _cfgs()
    sched = jsched.build_flip_schedule(2, 12, 0.0, 0.5, 2, seed=0)
    tsch = tsched.build_flip_schedule(2, 12, 0.0, 0.5, 2, seed=0)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=12, grad_clip=0.1,
               weight_decay=0.01)
    tokens = np.random.default_rng(7).integers(0, 128, (3, 4, 17))

    jmodel = jlm.MoELanguageModel(jcfg, flip_schedule=sched)
    params = jmodel.init(jax.random.PRNGKey(3),
                         jnp.asarray(tokens[0, :, :-1]))["params"]
    joptim = jtrainer.make_optimizer(jtrainer.OptConfig(**opt))
    jstate = jtrainer.TrainState.create(params, joptim)
    jstep = jtrainer.make_train_step(jmodel, joptim, donate=False,
                                     n_microbatch=n_microbatch)

    tmodel = tlm.MoELanguageModel(tcfg, flip_schedule=tsch, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    toptim = ttrainer.make_optimizer(ttrainer.OptConfig(**opt))
    tstate = ttrainer.TrainState.create(tmodel, toptim)
    tstep = ttrainer.make_train_step(tmodel, toptim,
                                     n_microbatch=n_microbatch)

    n_flips = []
    for s in range(steps):
        jstate, jm = jstep(jstate, jnp.asarray(tokens[s], jnp.int32))
        tstate, tm = tstep(tstate, t(tokens[s]))
        assert set(jm) == set(tm)
        for key in jm:
            close(jm[key], tm[key])
        n_flips.append(int(tm["competesmoe/n_flip_layers"]))
    assert n_flips == [0, 2, 1][:steps]
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for key in want:
        close(want[key], got[key], rtol=1e-4, atol=1e-5)


def test_lm_eval_and_loss_match_jax():
    jcfg, tcfg = _cfgs(moe_name="smoe")
    tokens = np.random.default_rng(8).integers(0, 128, (2, 9))
    jmodel = jlm.MoELanguageModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(4),
                         jnp.asarray(tokens[:, :-1]))["params"]
    jnll, jn = jtrainer.make_eval_step(jmodel)(params, jnp.asarray(tokens))
    tmodel = tlm.MoELanguageModel(tcfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    tnll, tn = ttrainer.make_eval_step(tmodel)(t(tokens))
    close(jnll, tnll)
    assert int(jn) == int(tn) == 16
    logits = np.random.default_rng(9).normal(size=(2, 8, 5))
    targets = tokens[:, 1:] % 5
    targets[0, 3] = targets[1, 0] = -100
    jl, jcount = jlm.lm_loss_fn(jnp.asarray(logits, jnp.float32),
                                jnp.asarray(targets))
    tl_, tcount = tlm.lm_loss_fn(t(logits).float(), t(targets))
    close(jl, tl_)
    assert int(jcount) == int(tcount) == 14


def test_lr_schedule_matches_optax():
    for cfg in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
                dict(lr=2.5e-4, total_steps=1000, final_lr_fraction=0.1),
                dict(lr=1e-3, lr_sched="constant", warmup_steps=3)):
        js = jtrainer.make_lr_schedule(jtrainer.OptConfig(**cfg))
        ts = ttrainer.make_lr_schedule(ttrainer.OptConfig(**cfg))
        for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150, 1000, 2000):
            close(js(s), ts(s), rtol=1e-6, atol=1e-9)
    assert float(optax.global_norm([jnp.ones(3)])) == pytest.approx(
        float(ttrainer.global_norm([torch.ones(3)])))


def test_lm_config_rules():
    assert tlm.resolve_attn_backend("auto", 4096, 128, "cuda") == "flash"
    assert tlm.resolve_attn_backend("auto", 1024, 82, "cuda") == "einsum"
    assert tlm.resolve_attn_backend("auto", 4096, 128, "cpu") == "einsum"
    assert tlm.resolve_attn_backend("flash", 16, 82, "cpu") == "flash"
    jcfg, tcfg = _cfgs(n_layers=4, universal_group_size=2,
                       universal_group_type="aabb")
    assert jcfg.layer_order() == tcfg.layer_order() == [0, 0, 1, 1]
    for field, value in (("att_moe", True), ("act_max_steps", 2),
                         ("n_prev_states", 1), ("p_drop_layer", 0.1),
                         ("remat", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.MoELanguageModel(dataclasses.replace(tcfg, **{field: value}),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="quant_opt"):
        ttrainer.make_optimizer(ttrainer.OptConfig(state_8bit=True))


# ---------------------------------------------------------------------------
# the task and the CLI entry point
# ---------------------------------------------------------------------------

_TINY_FLAGS = ["-stop_after", "4", "-batch_size", "2", "-lm.unroll", "16",
               "-lm.vocab_size", "64", "-state_size", "32",
               "-transformer.encoder_n_layers", "2", "-transformer.n_heads",
               "2", "-transformer.head_projection_size", "82",
               "-moe.n_experts", "8", "-moe.expert_size", "16",
               "-pkm.n_heads", "2", "-moe.impl", "fused",
               "-transformer.attn_backend", "flash", "-rate_flip", "0.5",
               "-warm_up", "0.0", "-hybrid", "1", "-balance_affinity", "1",
               "-wd", "0.01", "-grad_clip", "0.1", "-log_interval", "1",
               "-valid_interval", "0", "-amp", "0"]


def test_cli_trains_the_synthetic_task_on_cpu(tmp_path):
    import json

    from competesmoe_tpu_torch.cli.main import main
    main(_TINY_FLAGS + ["-run_dir", str(tmp_path), "-name", "t",
                        "--device", "cpu"])
    recs = [json.loads(line) for line in
            (tmp_path / "t" / "log_trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss/total"]) for r in recs)
    flips = [r["competesmoe/n_flip_layers"] for r in recs]
    assert max(flips) > 0 and min(flips) == 0


def test_task_needs_a_card_unless_asked(tmp_path):
    from competesmoe_tpu_torch.train.lm_task import get_task
    from competesmoe_tpu_torch.utils.argparser import build_parser
    a = build_parser().parse(_TINY_FLAGS + ["-run_dir", str(tmp_path)])
    assert a.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_task(a.task)(a)
    for flag in (["-n_expert_shards", "2"], ["-fsdp", "1"]):
        a = build_parser().parse(_TINY_FLAGS + flag + ["-device", "cpu",
                                                       "-run_dir",
                                                       str(tmp_path)])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_task(a.task)(a)
    # -restore is ported: a step with no checkpoint names what is missing
    a = build_parser().parse(_TINY_FLAGS + ["-restore", "5", "-device",
                                            "cpu", "-run_dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="step 5"):
        get_task(a.task)(a)
