"""The pretrain tree's five other routers against the JAX package.

The gates of `ops/routing.py` (`topk_sigmoid`, `topk_logits_softmax_weights`,
`cosine_logits`, `make_finite`), the layers `smoe_sigmoid`, `xmoe`,
`smoe_perturbed`, `deepseekv2` and `deepseekv3` of `moe/pretrain_layers.py`
through `convert.from_jax_params` (output, selection, aux losses, every
parameter's gradient; float32 and bf16 activations), three optimizer steps
of a tiny DeepSeek-V3 LM against JAX's, and the CLI training
`-moe_name smoe_sigmoid` on the CPU. The same numpy inputs, made from a
seed, go through both packages.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.moe import pretrain_layers as jpl
from competesmoe_tpu.ops import routing as jr
from competesmoe_tpu.train import lm_trainer as jtrainer
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import lm as tlm
from competesmoe_tpu_torch.moe import MoEArgs, get_pretrain_moe
from competesmoe_tpu_torch.moe.registry import PRETRAIN_MOE_REGISTRY
from competesmoe_tpu_torch.ops import routing as tr
from competesmoe_tpu_torch.train import lm_trainer as ttrainer

ROUTERS = ("smoe_sigmoid", "xmoe", "smoe_perturbed", "deepseekv2",
           "deepseekv3")
JAX_CLASS = {"smoe_sigmoid": jpl.PretrainSigmoidNorm,
             "xmoe": jpl.PretrainXMoE,
             "smoe_perturbed": jpl.PretrainPerturbed,
             "deepseekv2": jpl.PretrainDeepSeekV2,
             "deepseekv3": jpl.PretrainDeepSeekV3}
# float32 everywhere: the two packages agree to float32 rounding; bf16
# activations: a few bf16 ulps (2^-6 relative, and of the largest
# element), since a bf16 product rounded the other way upstream (float32
# sums in another order) moves its consumers by an ulp or two
F32 = dict(rtol=1e-4, atol=1e-5)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or F32))


def t(a):
    return torch.from_numpy(np.array(a))


def to_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bf16_close(want, got):
    want = to_np(want)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6,
                               atol=2.0 ** -6 * max(np.abs(want).max(), 1e-6))


def test_get_pretrain_moe_returns_all_seven_routers():
    assert set(PRETRAIN_MOE_REGISTRY) == set(ROUTERS) | {"smoe",
                                                         "competesmoe"}
    for name in ROUTERS:
        assert get_pretrain_moe(name) is PRETRAIN_MOE_REGISTRY[name]
    with pytest.raises(ValueError, match="deepseekv3"):
        get_pretrain_moe("nope")


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def _logits(dtype, seed=0, shape=(6, 16)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2
    x[1, 3] = x[1, 5]                        # a tie: lower index first
    return jnp.asarray(x, dtype), t(np.asarray(jnp.asarray(x, dtype)
                                               .astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", ["topk_sigmoid",
                                  "topk_logits_softmax_weights"])
def test_topk_gates_match_jax(gate, dtype):
    jl, tl_ = _logits(jnp.dtype(dtype))
    if dtype == "bfloat16":
        tl_ = tl_.to(torch.bfloat16)
    jw, jsel, jsm = getattr(jr, gate)(jl, 4)
    tw, tsel, tsm = getattr(tr, gate)(tl_, 4)
    np.testing.assert_array_equal(np.asarray(jsel), tsel.numpy())
    assert str(tw.dtype).split(".")[-1] == str(jw.dtype)
    close(to_np(jw), tw.float(), rtol=1e-6, atol=1e-7)
    close(jsm, tsm, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_logits_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    x[2] = 1e-6                              # a norm below eps
    emb = rng.normal(size=(16, 8)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = t(to_np(jx)).to(getattr(torch, dtype))
    want = jr.cosine_logits(jx, jnp.asarray(emb))
    got = tr.cosine_logits(tx, t(emb))
    assert got.dtype == tx.dtype
    close(to_np(want), got.float(), rtol=1e-6, atol=1e-6)


def test_make_finite_matches_jax_per_row():
    x = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    x[0, 1] = np.nan
    x[1, [0, 4]] = [np.inf, -np.inf]
    x[2] = np.nan                            # no finite score: 0
    want = np.asarray(jr.make_finite(jnp.asarray(x)))
    got = tr.make_finite(t(x)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[0, 1] == np.nanmin(np.where(np.isfinite(x[0]), x[0], np.nan))
    assert np.all(got[2] == 0) and np.all(got[3] == x[3])


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

_ARGS = JMoEArgs(balance_loss_coef=0.01)


def _layer_pair(name, x, seed=1):
    jl = JAX_CLASS[name](dmodel=32, n_experts=8, expert_size=16, n_heads=2,
                         args=_ARGS, weight_scale=0.7)
    params = jl.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tl_ = get_pretrain_moe(name)(32, 8, 16, 2,
                                 args=MoEArgs(balance_loss_coef=0.01),
                                 weight_scale=0.7, device="cpu")
    tl_.load_state_dict(from_jax_params(params))
    return jl, params, tl_


@pytest.mark.parametrize("name", ROUTERS)
def test_new_parameters_cross_from_jax(name):
    """from_jax_params carries every parameter of the router (expert_sel,
    expert_embeddings, keys_shared, values_shared,
    e_score_correction_bias) in its JAX layout."""
    x = np.zeros((1, 4, 32), np.float32)
    _, params, tl_ = _layer_pair(name, x)
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    want = {jax.tree_util.keystr(p).strip("[]'"): np.asarray(v)
            for p, v in flat}
    got = dict(tl_.named_parameters())
    assert set(want) == set(got)
    for key in want:
        np.testing.assert_array_equal(want[key], got[key].detach().numpy())
    extra = {"xmoe": {"expert_sel", "expert_embeddings"},
             "smoe_perturbed": {"expert_sel", "expert_embeddings"},
             "deepseekv2": {"keys_shared", "values_shared"},
             "deepseekv3": {"keys_shared", "values_shared",
                            "e_score_correction_bias"}}.get(name, set())
    assert extra <= set(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ROUTERS)
def test_router_layer_matches_jax(name, dtype):
    """Output, selection, aux loss, gate probabilities and every gradient
    (a parameter the router leaves unused, such as the cosine routers'
    w_gate, gets zeros in JAX and none here)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x, jdt)
    jl, params, tl_ = _layer_pair(name, jx)

    def jf(p, x):
        out, aux = jl.apply(p, x, train=True, return_id_experts=True)
        return (out.astype(jnp.float32) ** 2).sum() + aux.aux_loss, (out,
                                                                     aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jx)
    xt = t(to_np(jx)).to(getattr(torch, dtype)).requires_grad_()
    tout, taux = tl_(xt, train=True, return_id_experts=True)
    loss = (tout.float() ** 2).sum() + taux.aux_loss
    names = [n for n, _ in tl_.named_parameters()]
    grads = torch.autograd.grad(loss, [xt, *tl_.parameters()],
                                allow_unused=True)
    np.testing.assert_array_equal(np.asarray(jaux.selected_experts),
                                  taux.selected_experts.numpy())
    assert set(jaux.losses) == set(taux.losses) == {"mlp_ebalance"}
    want_grads = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                        jgrads[0]))
    if dtype == "float32":
        close(jout, tout.detach())
        close(jaux.aux_loss, taux.aux_loss.detach())
        close(to_np(jaux.gate_softmax), taux.gate_softmax.float())
        close(jgrads[1], grads[0])
        for pname, g in zip(names, grads[1:]):
            g = torch.zeros_like(want_grads[pname]) if g is None else g
            close(want_grads[pname], g, rtol=1e-4, atol=1e-5)
        return
    assert tout.dtype == torch.bfloat16
    bf16_close(jout, tout)
    close(jaux.aux_loss, taux.aux_loss.detach(), rtol=2e-3, atol=1e-6)
    bf16_close(jaux.gate_softmax, taux.gate_softmax)
    bf16_close(jgrads[1], grads[0])
    for pname, g in zip(names, grads[1:]):
        want = want_grads[pname].float().numpy()
        g = np.zeros_like(want) if g is None else g.float().numpy()
        # a weight's gradient sums bf16 products over every token, and
        # the gates' chains of bf16 roundings run in another order here:
        # held in the L2 norm, within 2^-5 of the gradient's
        err = np.linalg.norm(g - want)
        assert err <= 2.0 ** -5 * max(np.linalg.norm(want), 1e-6), \
            (pname, err, np.linalg.norm(want))


def test_cosine_routers_init_their_embeddings_as_jax():
    """theta 0 (xmoe): orthogonal rows at gain 0.32; theta 0.1
    (smoe_perturbed): N(0, 0.02). Drawn from the generator given."""
    for name, theta in (("xmoe", 0.0), ("smoe_perturbed", 0.1)):
        layer = get_pretrain_moe(name)(32, 64, 16, 8, device="cpu")
        assert layer.theta == theta
        layer.reset_parameters(torch.Generator().manual_seed(0))
        emb = layer.expert_embeddings.detach()
        assert tuple(emb.shape) == (64, 32)
        if theta == 0.0:
            gram = emb.t() @ emb
            torch.testing.assert_close(gram, 0.32 ** 2 * torch.eye(32),
                                       rtol=0, atol=1e-5)
        else:
            assert 0.015 < float(emb.std()) < 0.025
        again = get_pretrain_moe(name)(32, 64, 16, 8, device="cpu")
        again.reset_parameters(torch.Generator().manual_seed(0))
        assert torch.equal(again.expert_embeddings, layer.expert_embeddings)


# ---------------------------------------------------------------------------
# a tiny DeepSeek-V3 LM, and the CLI
# ---------------------------------------------------------------------------

def test_deepseekv3_lm_train_steps_match_jax():
    """Three steps of `make_train_step` (adamw, clipping, warmup, cosine)
    from the same weights and batches: losses, grad_norm and the
    parameters after the steps agree (the unused
    e_score_correction_bias stays 0 in both)."""
    base = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                n_experts=8, expert_size=8, moe_topk=2,
                moe_name="deepseekv3", moe_args=JMoEArgs())
    jcfg = jlm.LMConfig(**base)
    tcfg = tlm.LMConfig(**dict(base, moe_args=MoEArgs()))
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=12, grad_clip=0.1,
               weight_decay=0.01)
    tokens = np.random.default_rng(7).integers(0, 128, (3, 4, 17))
    jmodel = jlm.MoELanguageModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3),
                         jnp.asarray(tokens[0, :, :-1]))["params"]
    joptim = jtrainer.make_optimizer(jtrainer.OptConfig(**opt))
    jstate = jtrainer.TrainState.create(params, joptim)
    jstep = jtrainer.make_train_step(jmodel, joptim, donate=False)
    tmodel = tlm.MoELanguageModel(tcfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    toptim = ttrainer.make_optimizer(ttrainer.OptConfig(**opt))
    tstate = ttrainer.TrainState.create(tmodel, toptim)
    tstep = ttrainer.make_train_step(tmodel, toptim)
    for s in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens[s], jnp.int32))
        tstate, tm = tstep(tstate, t(tokens[s]))
        assert set(jm) == set(tm)
        for key in jm:
            close(jm[key], tm[key])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    assert any("keys_shared" in k for k in got)
    for key in want:
        close(want[key], got[key], rtol=1e-4, atol=1e-5)
        if key.endswith("e_score_correction_bias"):
            assert not got[key].any()


_TINY = ["-stop_after", "3", "-batch_size", "2", "-lm.unroll", "16",
         "-lm.vocab_size", "64", "-state_size", "32",
         "-transformer.encoder_n_layers", "2", "-transformer.n_heads", "2",
         "-transformer.head_projection_size", "82", "-moe.n_experts", "8",
         "-moe.expert_size", "16", "-pkm.n_heads", "2", "-moe.impl",
         "fused", "-transformer.attn_backend", "flash", "-wd", "0.01",
         "-grad_clip", "0.1", "-log_interval", "1", "-valid_interval", "0",
         "-amp", "1", "-balance_loss_coef", "0.01"]


def test_cli_trains_smoe_sigmoid_on_cpu(tmp_path):
    from competesmoe_tpu_torch.cli.main import main
    main(_TINY + ["-moe_name", "smoe_sigmoid", "-run_dir", str(tmp_path),
                  "-name", "t", "--device", "cpu"])
    recs = [json.loads(line) for line in
            (tmp_path / "t" / "log_trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss/total"]) for r in recs)
    assert all(r["competesmoe/n_flip_layers"] == 0 for r in recs)


@pytest.mark.parametrize("name,sweep", [
    ("deepseekv3", "slimpajama_moe_no_attmoe_154M_deepseekv3.yaml"),
    ("smoe_sigmoid", "slimpajama_moe_no_attmoe_154M_final.yaml")])
def test_chip_smoke_router_cells_are_their_sweeps(name, sweep):
    """chip_smoke.py's router cells set every field of their sweep file
    to its value, the task aside (the synthetic corpus stands in for
    SlimPajama; `log` picks a logger)."""
    from pathlib import Path

    import yaml

    import chip_smoke
    root = Path(__file__).resolve().parents[1]
    params = yaml.safe_load((root / "sweeps" / sweep).read_text())[
        "parameters"]
    flags = chip_smoke.ROUTER_SWEEPS[name]
    given = dict(zip(flags[::2], flags[1::2]))
    assert len(given) * 2 == len(flags)
    for key, spec in params.items():
        if key not in ("log", "task"):
            assert given["-" + key] == str(spec["value"]), key
    assert given["-task"] == "synthetic_transformer"
    assert given["-moe.impl"] == "fused"
    assert given["-transformer.attn_backend"] == "flash"
