"""Parity of the port's LM options with the JAX package: MoA
(`models/moa.py`), ACT (`models/act.py`), the Transformer-XL carry, layer
drop, per-block remat and `preln`, and one training step with MoA.

Inputs are made with numpy from a seed and fed to both packages; weights
go from the flax tree to the port through `convert.from_jax_params` (the
MoA banks' `w_gate` [H*E, d] and `experts` [H, E, in, out] pass as they
are, ACT's `halting` Dense becomes a Linear). Tolerance: float32 rtol and
atol 1e-4 (reordered f32 sums) unless a test states another. Random
draws are compared where they are deterministic (p = 0 and p = 1); the
keep share in between is a statistical check of the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.models import moa as jmoa
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.train import lm_trainer as jtrainer
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import lm as tlm
from competesmoe_tpu_torch.models import moa as tmoa
from competesmoe_tpu_torch.moe import MoEArgs
from competesmoe_tpu_torch.moe import schedule as tsched
from competesmoe_tpu_torch.train import lm_trainer as ttrainer

TOL = dict(rtol=1e-4, atol=1e-4)
ARGS = JMoEArgs(hybrid=True, router_theta=0.2, router_loss_coef=0.001,
                balance_affinity=True, rate_flip=0.07, max_compete_in_iter=3)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def t(a):
    return torch.from_numpy(np.array(a))


def cfgs(**kw):
    """(JAX LMConfig, port LMConfig) of a tiny float32 LM, einsum
    attention in JAX and flash (K2's plain version) in the port."""
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                n_experts=4, expert_size=8, moe_topk=2,
                moe_name="competesmoe", moe_args=ARGS)
    base.update(kw)
    jcfg = jlm.LMConfig(**base, dtype=jnp.float32, attn_backend="einsum")
    targs = dict(base, moe_args=MoEArgs(**dataclasses.asdict(
        base["moe_args"])))
    return jcfg, tlm.LMConfig(**targs, attn_backend="flash")


def models(jcfg, tcfg, tokens, seed=0):
    jm = jlm.MoELanguageModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    tm = tlm.MoELanguageModel(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def jax_loss(jm, params, tokens, **kw):
    """(loss, (logits, aux)) with the loss CE + total aux."""
    def f(p, tokens, state):
        logits, aux = jm.apply(p, tokens[:, :-1], state=state, **kw)
        ce, _ = jlm.lm_loss_fn(logits, tokens[:, 1:])
        return ce + aux["total_aux_loss"], (logits, aux)
    state = kw.pop("state", None)
    return jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, jnp.asarray(tokens), state)


def port_loss(tm, tokens, **kw):
    logits, aux = tm(t(tokens[:, :-1]), **kw)
    ce, _ = tlm.lm_loss_fn(logits, t(tokens[:, 1:]))
    loss = ce + aux["total_aux_loss"]
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    return loss, logits, aux, dict(zip(dict(tm.named_parameters()), grads))


def hold(jout, tout, names=None, grad_tol=None):
    """Loss, logits, every scalar aux key and every gradient."""
    (jl, (jlogits, jaux)), jgrads = jout
    tl, tlogits, taux, tgrads = tout
    close(jl, tl.detach())
    close(jlogits, tlogits.detach())
    jkeys = {k for k in jaux if k != "state"}
    assert jkeys == {k for k in taux if k != "state"}
    for k in jkeys:
        close(jaux[k], taux[k].detach())
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(tgrads)
    for k, g in tgrads.items():
        g = torch.zeros_like(want[k]) if g is None else g
        close(want[k], g, **(grad_tol or dict(rtol=1e-4, atol=1e-5)))


# ---------------------------------------------------------------------------
# MoA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts,v_size,carry", [
    ((True, True, True, True), None, False),
    ((True, True, True, True), 12, True),
    ((False, True, True, False), 12, False)])
def test_moa_attention_matches_jax(experts, v_size, carry):
    """FullMoeRopeAttention alone, train=True: output, the banks'
    selections (via the output), each att_*_ebalance and the aux loss,
    and the gradients of x, the carried prefix and every bank; all four
    projections as banks, then with a v size of its own and the XL
    prefix, then q and o as plain dense projections."""
    q, k, v, o = experts
    jcfg, tcfg = cfgs(att_moe=True, att_q_expert=q, att_k_expert=k,
                      att_v_expert=v, att_o_expert=o, att_v_size=v_size,
                      att_n_experts=4, att_k=2)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    pre = rng.normal(size=(2, 6, 32)).astype(np.float32)
    att = jmoa.FullMoeRopeAttention(jcfg)
    kw = {}
    if carry:
        kw = dict(pos_offset=6)
    params = att.init(jax.random.PRNGKey(3), jnp.asarray(x), train=True)

    def jf(p, x, pre):
        attend = jnp.concatenate([pre, x], 1) if carry else None
        out, aux = att.apply(p, x, attend_to=attend, train=True, **kw)
        return (out ** 2).sum() + aux.aux_loss, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(x),
                                             jnp.asarray(pre))
    ta = tmoa.FullMoeRopeAttention(tcfg, device="cpu")
    ta.load_state_dict(from_jax_params(params))
    xt, pt = t(x).requires_grad_(), t(pre).requires_grad_()
    attend = torch.cat([pt, xt], 1) if carry else None
    tout, taux = ta(xt, attend, **kw, train=True)
    loss = (tout ** 2).sum() + taux.aux_loss
    grads = torch.autograd.grad(loss, [xt, pt, *ta.parameters()],
                                allow_unused=True)
    close(jout, tout.detach())
    close(jaux.aux_loss, taux.aux_loss.detach())
    n_banks = sum(experts)
    assert set(jaux.losses) == set(taux.losses) and len(taux.losses) \
        == n_banks
    for key in jaux.losses:
        close(jaux.losses[key], taux.losses[key])
    close(jg[1], grads[0])
    if carry:
        close(jg[2], grads[1])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jg[0]))
    for (name, _), g in zip(ta.named_parameters(), grads[2:]):
        close(want[name], g, rtol=1e-4, atol=1e-5)


def test_moa_lm_and_train_step_match_jax():
    """A MoA LM: one `make_train_step` step (adamw, clip, warmup) from
    the same weights on both sides: every metric and the parameters
    after it. The balance keys land under layer{i}/att_<name>_ebalance."""
    jcfg, tcfg = cfgs(att_moe=True, att_v_size=12, n_layers=1)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=12, grad_clip=0.1,
               weight_decay=0.01)
    tokens = np.random.default_rng(7).integers(0, 64, (4, 13))
    jm = jlm.MoELanguageModel(jcfg)
    params = jm.init(jax.random.PRNGKey(5),
                     jnp.asarray(tokens[:, :-1]))["params"]
    jopt = jtrainer.make_optimizer(jtrainer.OptConfig(**opt))
    jstate, jmet = jtrainer.make_train_step(jm, jopt, donate=False)(
        jtrainer.TrainState.create(params, jopt), jnp.asarray(tokens))
    tm = tlm.MoELanguageModel(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    topt = ttrainer.make_optimizer(ttrainer.OptConfig(**opt))
    _, tmet = ttrainer.make_train_step(tm, topt)(
        ttrainer.TrainState.create(tm, topt), t(tokens))
    assert set(jmet) == set(tmet)
    for key in jmet:
        close(jmet[key], tmet[key])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    for key, p in tm.state_dict().items():
        close(want[key], p, rtol=1e-4, atol=1e-5)
    _, aux = tm(t(tokens[:, :-1]), train=True)
    assert {f"layer0/att_{n}_ebalance" for n in "qkvo"} <= set(aux)


# ---------------------------------------------------------------------------
# ACT, the XL carry, preln
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,n_prev,preln", [
    (3, 0, True), (0, 1, True), (0, 0, False)])
def test_lm_options_match_jax(act, n_prev, preln):
    """ACT (3 ponder steps, act_loss 0.01; ponder{i}/ and ponder_cost
    keys); the XL carry over two windows (the second sees the first's
    states; state tensors equal; the carry changes its logits); and
    preln=False (read nowhere in JAX: the same logits as preln=True in
    both packages). Loss, logits, aux keys and gradients."""
    jcfg, tcfg = cfgs(act_max_steps=act, act_loss=0.01, n_prev_states=n_prev,
                      preln=preln, moe_name="smoe", n_layers=2 - bool(act))
    rng = np.random.default_rng(21)
    w1, w2 = (rng.integers(0, 64, (2, 9)) for _ in range(2))
    jm, params, tm = models(jcfg, tcfg, w1[:, :-1], seed=2)
    kw = dict(train=True)
    if n_prev:
        (_, (_, jaux1)), _ = jax_loss(jm, params, w1, **kw)
        _, _, taux1, _ = port_loss(tm, w1, **kw)
        for a, b in zip(jaux1["state"], taux1["state"]):
            close(a, b)
        hold(jax_loss(jm, params, w2, state=jaux1["state"], **kw),
             port_loss(tm, w2, state=taux1["state"], **kw))
        plain = tm(t(w2[:, :-1]), train=True)[0]
        carried = tm(t(w2[:, :-1]), train=True, state=taux1["state"])[0]
        assert not torch.allclose(plain, carried, atol=1e-3)
        return
    hold(jax_loss(jm, params, w1, **kw), port_loss(tm, w1, **kw))
    if act:
        _, _, taux, _ = port_loss(tm, w1, **kw)
        assert {"layer0/ponder_cost", "layer0/ponder2/mlp_ebalance"} <= \
            set(taux)
    if not preln:
        jl, _ = jlm.MoELanguageModel(dataclasses.replace(
            jcfg, preln=True)).apply(params, jnp.asarray(w1[:, :-1]))
        tl = tlm.MoELanguageModel(dataclasses.replace(tcfg, preln=True),
                                  device="cpu")
        tl.load_state_dict(tm.state_dict())
        jf, _ = jm.apply(params, jnp.asarray(w1[:, :-1]))
        np.testing.assert_array_equal(np.asarray(jl), np.asarray(jf))
        with torch.no_grad():
            assert torch.equal(tl(t(w1[:, :-1]))[0], tm(t(w1[:, :-1]))[0])


# ---------------------------------------------------------------------------
# layer drop and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 1.0])
def test_layer_drop_matches_jax_at_deterministic_p(p):
    """p_drop_layer 0 keeps every block, 1 drops every block (the logits
    are the embedding's through the head); JAX given a 'layerdrop' rng,
    the port a generator."""
    jcfg, tcfg = cfgs(p_drop_layer=p, moe_name="smoe")
    tokens = np.random.default_rng(3).integers(0, 64, (2, 9))
    jm, params, tm = models(jcfg, tcfg, tokens[:, :-1], seed=4)
    kw = dict(train=True)
    jout = jax_loss(jm, params, tokens, rngs={
        "layerdrop": jax.random.PRNGKey(0)}, **kw)
    g = torch.Generator().manual_seed(0)
    hold(jout, port_loss(tm, tokens, generator=g, **kw))
    if p == 1.0:
        with torch.no_grad():
            emb = tm.embedding(t(tokens[:, :-1])) * np.sqrt(32)
            skip = tm.output(tm.out_norm(emb))
        close(jout[0][1][0], skip)


def test_layer_drop_keep_share_and_generator():
    """At p 0.3 the share of kept (token, layer) cells is 0.7 within 4
    sigma, the same generator seed gives the same logits, and a training
    forward without a generator raises (JAX's needs a 'layerdrop' rng)."""
    _, tcfg = cfgs(p_drop_layer=0.3, moe_name="smoe", n_layers=4)
    tm = tlm.MoELanguageModel(tcfg, device="cpu").init_weights(0)
    tokens = t(np.random.default_rng(1).integers(0, 64, (8, 64)))
    kept = []
    real = torch.where

    def spy(cond, a, b):
        if cond.dtype == torch.bool and cond.shape[-1] == 1:
            kept.append(cond.float().mean().item())
        return real(cond, a, b)

    torch.where = spy
    try:
        with torch.no_grad():
            a = tm(tokens, train=True,
                   generator=torch.Generator().manual_seed(5))[0]
    finally:
        torch.where = real
    share = float(np.mean(kept))
    n = 8 * 64 * 4
    assert len(kept) == 4
    assert abs(share - 0.7) <= 4 * np.sqrt(0.7 * 0.3 / n)
    with torch.no_grad():
        b = tm(tokens, train=True,
               generator=torch.Generator().manual_seed(5))[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        tm(tokens, train=True)


@pytest.mark.parametrize("kw", [
    dict(moe_name="competesmoe"),
    dict(moe_name="smoe", att_moe=True, att_expert_dropout=0.3,
         att_selection_dropout=0.2, p_drop_layer=0.3)])
def test_remat_equals_no_remat(kw):
    """remat=True gives the loss and every gradient of remat=False, bit
    for bit on the CPU: a CompeteSMoE LM on a step where both layers
    compete (the host decides the branch from the step number, on the
    recompute too), and a MoA LM with every random draw on (drawn
    outside the recomputed block from the same generator seed)."""
    step = 1                           # both layers compete
    rows = []
    for remat in (False, True):
        _, tcfg = cfgs(remat=remat, **kw)
        tm = tlm.MoELanguageModel(
            tcfg, flip_schedule=tsched.build_flip_schedule(
                2, 12, 0.0, 0.5, 2, seed=0), device="cpu").init_weights(3)
        tokens = np.random.default_rng(2).integers(0, 64, (2, 17))
        loss, _, aux, grads = port_loss(
            tm, tokens, step=step, train=True,
            generator=torch.Generator().manual_seed(9))
        rows.append((loss, grads, aux))
    (l0, g0, a0), (l1, g1, a1) = rows
    assert torch.equal(l0, l1)
    for k in g0:
        assert (g0[k] is None) == (g1[k] is None), k
        if g0[k] is not None:
            assert torch.equal(g0[k], g1[k]), k
    if kw["moe_name"] == "competesmoe":
        assert float(sum(v for k, v in a1.items()
                         if k.endswith("is_comp"))) == 2.0


@pytest.mark.parametrize("flags", [
    dict(p_drop_layer=0.1), dict(att_moe=True, att_expert_dropout=0.1),
    dict(att_moe=True, att_selection_dropout=0.1)])
def test_jax_train_step_passes_no_rng(flags):
    """JAX's `make_train_step` calls `model.apply` without `rngs`, so a
    training step with layer drop or either MoA dropout above 0 fails
    there (ROADMAP §3); the port's step draws from the generator it is
    given and trains."""
    jcfg, tcfg = cfgs(moe_name="smoe", **flags)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 9))
    jm = jlm.MoELanguageModel(jcfg)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "layerdrop": jax.random.PRNGKey(1),
                      "dropout": jax.random.PRNGKey(2),
                      "expert_drop": jax.random.PRNGKey(3)},
                     jnp.asarray(tokens[:, :-1]))["params"]
    jopt = jtrainer.make_optimizer(jtrainer.OptConfig())
    with pytest.raises(Exception, match="rng|PRNG|Rng"):
        jtrainer.make_train_step(jm, jopt, donate=False)(
            jtrainer.TrainState.create(params, jopt), jnp.asarray(tokens))
    tm = tlm.MoELanguageModel(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(params))
    topt = ttrainer.make_optimizer(ttrainer.OptConfig())
    step = ttrainer.make_train_step(tm, topt,
                                    generator=torch.Generator().manual_seed(0))
    _, m = step(ttrainer.TrainState.create(tm, topt), t(tokens))
    assert np.isfinite(float(m["loss/total"]))
