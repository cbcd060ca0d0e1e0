"""Parity of the port's multimodal CompeteSMoE layer (the competition step
of competesmoe_tpu/moe/layers.py `CompeteSMoELayer`) with the JAX layer.

The same numpy inputs (a seed) and the JAX layer's weights (through
`convert.from_jax_params`) go through both, in float32 and with bfloat16
activations, norm_sigmoid and hybrid on and off, at steps in warm-up, on
a flip, off a flip and past the schedule's end. Compared: the output,
aux_loss, every `losses` entry, the routing distribution (the affinity
softmax on a flip), the selected experts (exactly), and the gradients of
sum(out * R) + aux_loss with respect to x and to every parameter.
Tolerances: float32 rtol/atol 1e-4 (gradients 2e-4); bfloat16 outputs and
x's gradient 2^-6 of their largest magnitude, parameter gradients 2^-5
(bf16 roundings of reordered float32 sums).

The bfloat16 cases take the quick_gelu experts, whose activation the port
rounds where XLA does (x * sigmoid(1.702 x), the sigmoid stepwise), so
the top-2 of 4 affinities must agree token for token. F.gelu (exact and
tanh) rounds once where XLA rounds after each step, and a near-tie of two
bf16 affinities can then go the other way: on the card the trainer's
card-vs-CPU check measures that share (chip_faults.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.moe import layers as jlayers
from competesmoe_tpu.moe.schedule import build_flip_schedule as jschedule
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.moe import MoEArgs
from competesmoe_tpu_torch.moe.layers import (CompeteSMoELayer, competes_at,
                                             quick_gelu)
from competesmoe_tpu_torch.moe.schedule import build_flip_schedule
from competesmoe_tpu_torch.ops import expert_compute as tec

D, H, E, K = 12, 20, 4, 2
SCHED = dict(n_layers=1, total_steps=12, warm_up=0.25, rate_flip=0.5,
             max_compete_in_iter=1, seed=3)


def _schedule():
    s = build_flip_schedule(**SCHED)
    np.testing.assert_array_equal(s.flips, jschedule(**SCHED).flips)
    return s


def _steps(s):
    """A warm-up step, a flip, a step without one, one past the end."""
    row = s.flips[0]
    on = s.step_warm + int(np.flatnonzero(row)[0])
    off = s.step_warm + int(np.flatnonzero(~row)[0])
    return {"warm-up": 1, "flip": on, "no flip": off,
            "past the end": s.step_warm + len(row) + 2}


def _rel_close(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


def _run_jax(layer, params, x, step, r):
    def f(params, x):
        out, aux = layer.apply(params, x, step=step, train=True)
        return (jnp.sum(out.astype(jnp.float32) * r) + aux.aux_loss,
                (out, aux))
    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, x)
    return out, aux, gp, gx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_sigmoid,hybrid", [(False, False),
                                                 (True, True)])
def test_competition_layer_matches_jax(dtype, norm_sigmoid, hybrid):
    s = _schedule()
    row = s.flips[0]
    kw = dict(norm_sigmoid=norm_sigmoid, hybrid=hybrid, router_theta=0.3,
              diversity_loss_coef=0.05, bal_comp_loss_coef=0.02,
              router_loss_coef=0.1)
    act = "quick_gelu" if dtype == "bfloat16" else "gelu"
    jl = jlayers.CompeteSMoELayer(in_dim=D, out_dim=D, n_experts=E,
                                  n_selected=K, args=JMoEArgs(**kw),
                                  expert_hidden_dim=H, expert_act=act,
                                  flip_schedule=row, step_warm=s.step_warm)
    rng = np.random.default_rng(11)
    x32 = rng.normal(size=(2, 9, D)).astype(np.float32)
    r = rng.normal(size=(2, 9, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x32).astype(jdt)
    params = jax.tree_util.tree_map(
        np.asarray, jl.init(jax.random.PRNGKey(4), xj))
    tl = CompeteSMoELayer(D, D, n_experts=E, n_selected=K,
                          args=MoEArgs(**kw), expert_hidden_dim=H,
                          expert_act=act, flip_schedule=row,
                          step_warm=s.step_warm, device="cpu")
    tl.load_state_dict(from_jax_params(params))
    lowp = dtype == "bfloat16"
    for what, step in _steps(s).items():
        jout, jaux, jgp, jgx = _run_jax(jl, params, xj, step, r)
        xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)
        xt.requires_grad_(True)
        tl.zero_grad()
        out, aux = tl(xt, step=step, train=True)
        ((out.float() * torch.from_numpy(r)).sum() + aux.aux_loss).backward()
        want_comp = competes_at(row, s.step_warm, step)
        assert want_comp == (what == "flip")
        assert float(aux.losses["is_comp"]) == float(want_comp)
        assert set(aux.losses) == set(jaux.losses)
        np.testing.assert_array_equal(aux.selected_experts.numpy(),
                                      np.asarray(jaux.selected_experts),
                                      err_msg=what)
        if lowp:
            _rel_close(out.float().detach(), jout.astype(jnp.float32),
                       2.0 ** -6)
            _rel_close(xt.grad.float(), jgx.astype(jnp.float32), 2.0 ** -6)
        else:
            np.testing.assert_allclose(out.detach().numpy(), jout,
                                       rtol=1e-4, atol=1e-4, err_msg=what)
            np.testing.assert_allclose(xt.grad.numpy(), jgx, rtol=2e-4,
                                       atol=2e-4, err_msg=what)
        np.testing.assert_allclose(float(aux.aux_loss.detach()),
                                   float(jaux.aux_loss),
                                   rtol=2e-3 if lowp else 1e-4, atol=1e-6)
        for key, v in jaux.losses.items():
            np.testing.assert_allclose(float(aux.losses[key]), float(v),
                                       rtol=2e-3 if lowp else 1e-4,
                                       atol=1e-6, err_msg=f"{what} {key}")
        np.testing.assert_allclose(aux.gate_softmax.float().numpy(),
                                   np.asarray(jaux.gate_softmax, np.float32),
                                   rtol=1e-2 if lowp else 1e-5, atol=1e-5)
        grads = from_jax_params(jgp)
        for name, p in tl.named_parameters():
            want = grads[name].float().numpy()
            if lowp:
                _rel_close(p.grad.numpy(), want, 2.0 ** -5)
            else:
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=2e-4,
                                           atol=2e-4,
                                           err_msg=f"{what} {name}")


def test_routerloss_positive_exactly_on_flips():
    """routerloss > 0 exactly on the steps where the schedule flips."""
    s = _schedule()
    row = s.flips[0]
    tl = CompeteSMoELayer(D, D, n_experts=E, n_selected=K, args=MoEArgs(),
                          expert_hidden_dim=H, flip_schedule=row,
                          step_warm=s.step_warm, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tl.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    x = torch.randn((2, 5, D), generator=g)
    for step in range(s.step_warm + len(row) + 2):
        _, aux = tl(x, step=step, train=True)
        want = step < s.step_warm + len(row) and s.is_flip(0, step)
        assert (float(aux.losses["routerloss"]) > 0) == want, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_competition_all_experts_matches_jax(dtype):
    """The affinity, top-k outputs and selection against JAX's
    competition_all_experts_mlp2: bf16 affinities equal bit for bit
    (softplus rounded at each step, one rounding of the float32 mean)."""
    from competesmoe_tpu.ops import expert_compute as jec
    rng = np.random.default_rng(2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.normal(size=(64, D)).astype(np.float32)).astype(jdt)
    w1 = jnp.asarray(rng.normal(size=(E, D, H)).astype(np.float32) * .3)
    b1 = jnp.asarray(rng.normal(size=(E, H)).astype(np.float32) * .1)
    w2 = jnp.asarray(rng.normal(size=(E, H, D)).astype(np.float32) * .3)
    b2 = jnp.asarray(rng.normal(size=(E, D)).astype(np.float32) * .1)
    def jact(v):
        return v * jax.nn.sigmoid(1.702 * v)

    ja, jo, js = jec.competition_all_experts_mlp2(x, w1, b1, w2, b2, jact, K)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def t(a):
        return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32)))

    ta, to, ts = tec.competition_all_experts_mlp2(
        t(x).to(tdt), t(w1), t(b1), t(w2), t(b2), quick_gelu, K)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(ta.float().numpy(),
                                      np.asarray(ja, np.float32))
    else:
        np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5,
                               atol=1e-2 if dtype == "bfloat16" else 1e-5)
    with pytest.raises(ValueError, match="expert-parallel mesh"):
        tec.competition_all_experts_mlp2(t(x), t(w1), t(b1), t(w2), t(b2),
                                         quick_gelu, K, impl="ep")


def test_softplus_matches_jax_bit_for_bit():
    """bf16 softplus and its gradient as XLA computes them."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4096,)).astype(np.float32) * 4
                    ).astype(jnp.bfloat16)
    jv, jvjp = jax.vjp(jax.nn.softplus, x)
    g = jnp.asarray(rng.normal(size=(4096,)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    (jg,) = jvjp(g)
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
    xt.requires_grad_(True)
    y = tec.softplus(xt)
    y.backward(torch.tensor(np.asarray(g.astype(jnp.float32))).bfloat16())
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))
