"""The multimodal tree's five other routers and `gate_bias` against the JAX
package.

`smoe_sigmoidgating`, `xmoe`, `smoe_perturbed`, `smoe_share` and
`deepseekv3` of `moe/layers.py` through `convert.from_jax_params`: at the
layer (output, selected experts, aux losses, every parameter's gradient in
float32 within rtol 1e-4, atol 1e-5; bf16 activations within 2^-6 of
max|JAX| with the same selections), then in the SigLIP tower and the MoE
projector of a small `LlavaModel` (features, logits, the loss with its
aux terms and every gradient in float32, the eval adapter's routing
telemetry). `gate_bias` is created by the routers whose gate is a kernel
[in, E], zero from the port's `init_random_`, and read by no layer in
either package. The port's registry holds exactly JAX's eight names. The
same numpy inputs, made from a seed, go through both packages.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.eval.llava_adapter import \
    routing_telemetry as jtelemetry
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.moe.registry import MOE_REGISTRY as JAX_REGISTRY
from competesmoe_tpu.moe.registry import get_moe as jget_moe
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.eval.llava_adapter import \
    routing_telemetry as ttelemetry
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.moe.registry import MOE_REGISTRY, get_moe
from tests.test_torch_port_models import (IMG, jax_llava_cfg,
                                          port_llava_cfg)

ROUTERS = ("smoe_sigmoidgating", "xmoe", "smoe_perturbed", "smoe_share",
           "deepseekv3")
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2.0 ** -6


def close(got, want, what="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or F32), err_msg=what)


def np32(t):
    return t.detach().float().cpu().numpy()


def layer_pair(name, seed=1, gate_bias=False, d=16, h=24):
    """JAX's layer with its init from `seed` and the port's with the same
    weights."""
    x = np.random.default_rng(seed).standard_normal((2, 6, d)).astype(
        np.float32)
    jl = jget_moe(name)(in_dim=d, out_dim=d, n_experts=4, n_selected=2,
                        gate_bias=gate_bias, expert_hidden_dim=h)
    params = jax.tree_util.tree_map(
        np.asarray, jl.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    tl = get_moe(name)(d, d, n_experts=4, n_selected=2,
                       gate_bias=gate_bias, expert_hidden_dim=h,
                       device="cpu")
    tl.load_state_dict(from_jax_params(params))
    return jl, params, tl, x


def test_registry_holds_jax_names():
    assert set(MOE_REGISTRY) == set(JAX_REGISTRY)
    assert len(MOE_REGISTRY) == 8


@pytest.mark.parametrize("name", ROUTERS)
def test_router_layer_matches_jax_f32(name):
    """Training forward: output, selections, aux loss and its named
    components, the f32 routing distribution, and the gradient of
    sum(out * r) + aux_loss for every parameter."""
    jl, params, tl, x = layer_pair(name)
    r = np.random.default_rng(7).standard_normal((2, 6, 16)).astype(
        np.float32)

    def jloss(p):
        out, aux = jl.apply(p, jnp.asarray(x), train=True)
        return jnp.sum(out * r) + aux.aux_loss, (out, aux)

    (_, (jo, ja)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    to, ta = tl(torch.as_tensor(x), train=True)
    (torch.sum(to * torch.as_tensor(r)) + ta.aux_loss).backward()
    close(np32(to), jo, "output")
    np.testing.assert_array_equal(ta.selected_experts.numpy(),
                                  np.asarray(ja.selected_experts))
    close(float(ta.aux_loss), float(ja.aux_loss), "aux_loss")
    assert set(ta.losses) == set(ja.losses)
    for k in ja.losses:
        close(float(ta.losses[k]), float(ja.losses[k]), k)
    assert ta.gate_softmax.dtype == torch.float32
    close(np32(ta.gate_softmax), ja.gate_softmax, "gate_softmax")
    want = from_jax_params(jg)
    got = {k: p.grad for k, p in tl.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        assert g is not None, k
        close(np32(g), want[k].numpy(), f"grad {k}")


@pytest.mark.parametrize("name", ROUTERS)
def test_router_layer_matches_jax_bf16(name):
    """bf16 activations against float32 weights, inference and training
    forwards: the same selections, outputs within 2^-6 of max|JAX|."""
    jl, params, tl, x = layer_pair(name, seed=2)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    for train in (False, True):
        jo, ja = jl.apply(params, jnp.asarray(x).astype(jnp.bfloat16),
                          train=train, return_id_experts=True)
        with torch.no_grad():
            to, ta = tl(xb, train=train, return_id_experts=True)
        assert to.dtype == torch.bfloat16
        np.testing.assert_array_equal(ta.selected_experts.numpy(),
                                      np.asarray(ja.selected_experts))
        want = np.asarray(jo, np.float32)
        assert np.abs(np32(to) - want).max() <= BF16_REL * np.abs(
            want).max()
        close(float(ta.aux_loss), float(ja.aux_loss), "aux_loss",
              rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["smoe", "smoe_sigmoidgating",
                                  "competesmoe", "mixtral", "xmoe",
                                  "smoe_share"])
def test_gate_bias_created_and_unread_like_jax(name):
    """With gate_bias=True JAX creates a zero `gate_bias` [E] where the
    gate is a kernel [in, E] (not for the cosine or shared-expert gates,
    which ignore the flag) and no layer adds it to its logits: a bias of
    any value leaves the output unchanged in both packages. The port's
    parameters are JAX's, and its init_random_ makes the bias zero."""
    jl, params, tl, x = layer_pair(name, seed=3, gate_bias=True)
    has = "gate_bias" in params["params"]
    assert has == (name not in ("xmoe", "smoe_share"))
    assert ("gate_bias" in dict(tl.named_parameters())) == has
    jo, _ = jl.apply(params, jnp.asarray(x))
    with torch.no_grad():
        to, _ = tl(torch.as_tensor(x))
    close(np32(to), jo)
    if not has:
        return
    np.testing.assert_array_equal(params["params"]["gate_bias"], 0.0)
    shifted = jax.tree_util.tree_map(lambda a: a, params)
    shifted["params"]["gate_bias"] = np.arange(4, dtype=np.float32) * 5.0
    np.testing.assert_array_equal(
        np.asarray(jl.apply(shifted, jnp.asarray(x))[0]), np.asarray(jo))
    with torch.no_grad():
        tl.gate_bias.copy_(torch.arange(4.0) * 5.0)
        assert torch.equal(tl(torch.as_tensor(x))[0], to)
        tbuilder.init_random_(tl, seed=0)
    assert torch.equal(tl.gate_bias, torch.zeros(4))


# ---------------------------------------------------------------------------
# the routers in the tower, the projector and a small LlavaModel
# ---------------------------------------------------------------------------

def router_llava_cfg(name):
    cfg = jax_llava_cfg()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, moe_name=name),
        projector=dataclasses.replace(cfg.projector, moe_name=name))


def llava_batch(seed=4, B=2, L=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 64, (B, L)).astype(np.int32)
    ids[:, 2] = IMG
    labels = ids.copy()
    labels[:, :3] = -100
    px = rng.uniform(-1, 1, (B, 28, 28, 3)).astype(np.float32)
    return ids, labels, px


def random_params(module, *args, seed=0, **kwargs):
    """A param tree of `module`'s shapes, drawn with numpy (no init
    trace): norm scales 1, other leaves N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", "") in ("scale", "weight"):
            return np.ones(leaf.shape, np.float32)
        return rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=ROUTERS)
def router_llava(request):
    name = request.param
    cfg = router_llava_cfg(name)
    ids, labels, px = llava_batch()
    params = random_params(jllava.LlavaModel(cfg), ids, px, labels=labels,
                           train=True)
    model = tllava.LlavaModel(port_llava_cfg(cfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return name, cfg, params, model


def test_router_tower_and_projector_match_jax(router_llava):
    """The tower's features and aux, the projector's output and aux, with
    the router in every tower layer and in the projector."""
    name, cfg, params, model = router_llava
    _, _, px = llava_batch()
    jm = jllava.LlavaModel(cfg)
    jf, jclip, jv, jp = jax.jit(lambda p: jm.apply(
        p, jnp.asarray(px), train=True, method=jm.encode_images))(params)
    with torch.no_grad():
        tf, tclip, tv, tp = model.encode_images(torch.as_tensor(px),
                                                train=True)
    close(np32(tf), jf, "projected features")
    close(float(tclip), float(jclip), "aux_clip")
    close(float(tp.aux_loss), float(jp.aux_loss), "projector aux")
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a.selected_experts.numpy(),
                                      np.asarray(b.selected_experts))
        close(float(a.aux_loss), float(b.aux_loss), "tower layer aux")


def test_router_llava_loss_and_gradients_match_jax(router_llava):
    """Logits, the training loss (cross-entropy + aux_clip + the
    projector's aux) and every parameter's gradient."""
    name, cfg, params, model = router_llava
    ids, labels, px = llava_batch()
    jm = jllava.LlavaModel(cfg)

    def jloss(p):
        out = jm.apply(p, ids, px, labels=labels, train=True, step=0)
        return out.loss, out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model.zero_grad()
    out = model(torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(px),
                labels=torch.as_tensor(labels, dtype=torch.long), train=True,
                step=0)
    out.loss.backward()
    close(np32(out.logits), jout.logits, "logits")
    close(float(out.loss), float(jl), "loss")
    close(float(out.aux_mlp), float(jout.aux_mlp), "aux_mlp")
    want = from_jax_params(jg)
    for k, p in model.named_parameters():
        # the tower's last layer feeds only its aux loss (the features
        # come from the layer before): its experts get no gradient here
        # and zeros in JAX
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        close(np32(g), want[k].numpy(), f"grad {k}")


def test_router_telemetry_matches_jax(router_llava):
    """The eval adapter's per-layer telemetry (entropy, top-1 and top-2
    histograms, losses) of a `return_id_experts` forward. The shared-
    expert routers select k-1 = 1 expert (no top-2 histogram) among E-1;
    XMoE reports its bf16-then-f32 routing distribution."""
    name, cfg, params, model = router_llava
    ids, _, px = llava_batch(5)
    jout = jax.jit(lambda p: jllava.LlavaModel(cfg).apply(
        p, ids, px, return_id_experts=True))(params)
    with torch.no_grad():
        out = model(torch.as_tensor(ids, dtype=torch.long),
                    torch.as_tensor(px), return_id_experts=True)
    for got, want in ((ttelemetry(out.vision_auxes),
                       jtelemetry(jout.vision_auxes)),
                      (ttelemetry([out.projector_aux]),
                       jtelemetry([jout.projector_aux]))):
        assert set(got) == set(want) and got
        for layer, w in want.items():
            g = got[layer]
            assert g["top1_hist"] == w["top1_hist"], layer
            assert g["top2_hist"] == w["top2_hist"], layer
            close(g["entropy"], w["entropy"], layer)
            assert set(g["losses"]) == set(w["losses"])
            shared = name in ("smoe_share", "deepseekv3")
            assert (g["top2_hist"] is None) == shared
            assert len(g["top1_hist"]) == (3 if shared else 4)
