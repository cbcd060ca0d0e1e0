"""The port's parallel building blocks against JAX's
(competesmoe_tpu/parallel/): the placement rule on the 154M LM's and the
multimodal model's trees, the three expert-parallel dispatches (and the
capacity drop), the sharded competition step, the aux losses over the
global batch, 8-bit Adam and the global norm over shards, the job record,
and the refusals.

The multi-rank cases run in one world of 4 gloo ranks on the CPU per
module (`torch_parallel_ranks.spawn`); JAX's side runs on the virtual CPU
devices of tests/conftest.py, over the same numpy inputs. Ranks hold row
block r of the batch and expert shard r % n_expert, as JAX's mesh.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from competesmoe_tpu.ops import expert_compute as jec
from competesmoe_tpu.parallel import make_mesh as jmake_mesh
from competesmoe_tpu.parallel import expert_parallel as jep
from competesmoe_tpu.parallel import mesh as jmesh
from competesmoe_tpu_torch.parallel import mesh as tmesh

TOL = dict(rtol=1e-5, atol=1e-5)


def np32(t):
    return np.asarray(t, np.float32)


def jquick_gelu(x):
    return x * jax.nn.sigmoid(1.702 * x)


# ---------------------------------------------------------------------------
# the placement rule
# ---------------------------------------------------------------------------

class _Leaf:
    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)
        self.size = int(np.prod(shape))


@pytest.mark.parametrize("names,shape,fsdp", [
    (["moe", "keys"], (64, 512, 128), 4), (["output", "kernel"], (512, 8000), 4),
    (["attn", "kernel"], (1024, 512), 4), (["norm", "scale"], (512,), 4),
    (["x", "kernel"], (1023, 512), 4), (["output", "kernel"], (512, 8000), 1),
    (["ln", "bias"], (512,), 1), (["m", "experts_w3"], (8, 16, 32), 2)])
def test_param_spec_matches_jax(names, shape, fsdp):
    want = jmesh.param_spec(names, _Leaf(shape), fsdp)
    assert tuple(want) == tmesh.param_spec(names, _Leaf(shape), fsdp)


def _jax_to_port(path, spec, ndim):
    """A JAX leaf's path and spec -> the port's canonical name and spec
    (convert.from_jax_params's renames and transposes)."""
    keys = [getattr(p, "key", str(p)) for p in path]
    parts = []
    for k in keys[:-1]:
        head, _, idx = k.rpartition("_")
        parts.append(f"{head}.{idx}" if head in ("layers", "blocks")
                     and idx.isdigit() else k)
    leaf = keys[-1]
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec))) if spec else ()
    if leaf == "kernel":
        leaf = "weight"
        if spec:
            spec = spec[::-1] if ndim == 2 else tuple(spec[i] for i in
                                                      (3, 2, 0, 1))
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts + [leaf]), spec


def _compare_tree(jparams, tmodel, fsdp, min_size):
    mesh = jmake_mesh(n_expert=2)            # 4 x 2 over the 8 devices
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            jmesh.make_param_shardings(mesh, jparams, fsdp=fsdp,
                                       fsdp_min_size=min_size))[0]:
        nd = len(_shape_at(jparams, path))
        name, spec = _jax_to_port(path, sh.spec, nd)
        want[name] = spec
    got = tmesh.make_param_shardings(
        types.SimpleNamespace(shape=mesh.shape), tmodel, fsdp=fsdp,
        fsdp_min_size=min_size)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}
    return got


def _shape_at(tree, path):
    node = tree
    for p in path:
        node = node[getattr(p, "key", p)]
    return node.shape


@pytest.mark.parametrize("fsdp", [False, True])
def test_placement_matches_jax_on_the_154m_lm(fsdp):
    """Every parameter of the 154M sweep's LM (d 512, 16 layers, 4 heads
    of 82, 64 experts of 128, top-8) is placed as JAX places it, with and
    without FSDP over the 'data' axis."""
    from competesmoe_tpu.models import lm as jlm
    from competesmoe_tpu_torch.models import lm as tlm
    kw = dict(vocab_size=8000, d_model=512, n_layers=16, n_heads=4,
              head_dim=82, n_experts=64, expert_size=128, moe_topk=8,
              moe_name="competesmoe")
    jmodel = jlm.MoELanguageModel(jlm.LMConfig(**kw))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    tmodel = tlm.MoELanguageModel(tlm.LMConfig(**kw), device="meta")
    got = _compare_tree(shapes, tmodel, fsdp, 2 ** 16)
    assert got["blocks.0.moe.keys"] == ("expert", None, None)
    assert (got["embedding.weight"] == ("data", None)) == fsdp


@pytest.mark.parametrize("fsdp", [False, True])
def test_placement_matches_jax_on_the_multimodal_tree(fsdp):
    """The LLaVA tree (CompeteSMoE tower and projector, mlp2 experts) at
    small widths: every parameter placed as JAX places it."""
    from competesmoe_tpu.models import builder as jbuilder
    from competesmoe_tpu.models import llava as jllava
    from competesmoe_tpu_torch.models import builder as tbuilder
    from competesmoe_tpu_torch.models.llava import LlavaModel
    hf = dict(tbuilder.HF_5P1B, **R.MM_HF)
    jcfg = jbuilder.llava_config_from_hf(hf, "llava_phi", jnp.float32)
    ids = np.ones((1, 9), np.int32)
    ids[0, 2] = -200
    px = np.zeros((1, 28, 28, 3), np.float32)
    shapes = jax.eval_shape(lambda: jllava.LlavaModel(jcfg).init(
        jax.random.PRNGKey(0), ids, px))["params"]
    tcfg = tbuilder.llava_config_from_hf(hf, "llava_phi", torch.float32)
    got = _compare_tree(shapes, LlavaModel(tcfg, device="meta"), fsdp, 1024)
    assert any(v and v[0] == "expert" for k, v in got.items()
               if k.endswith("experts_w1"))


# ---------------------------------------------------------------------------
# the dispatches, the competition step, losses, optimizer: one world of 4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return R.spawn(R.four_rank_scenarios, 4, tmp_path_factory.mktemp("w4"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return R.spawn(R.two_rank_scenarios, 2, tmp_path_factory.mktemp("w2"))


def _jax_fns(kind, n_ep, cap):
    mesh = jmake_mesh(n_expert=n_ep, devices=jax.devices()[:4])
    if kind in ("kv", "capacity"):
        ep = jep.make_ep_ffn_kv(mesh, jax.nn.relu, capacity=cap)
        one = lambda x, s, w, k, v: jec.grouped_ffn_kv(  # noqa: E731
            x, s, w, k, v, jax.nn.relu)
    elif kind == "kv_bias":
        ep = jep.make_ep_ffn_kv(mesh, jax.nn.relu, with_bias=True)
        one = lambda x, s, w, k, v, b: jec.grouped_ffn_kv(  # noqa: E731
            x, s, w, k, v, jax.nn.relu, b1=b)
    elif kind == "mlp2":
        ep = jep.make_ep_ffn_mlp2(mesh, jquick_gelu)
        one = lambda x, s, w, *e: jec.grouped_ffn_mlp2(  # noqa: E731
            x, s, w, *e, jquick_gelu)
    else:
        ep = jep.make_ep_ffn_swiglu(mesh)
        one = jec.grouped_ffn_swiglu
    return mesh, ep, one


@pytest.mark.parametrize("case", [c[0] for c in R.DISPATCH_CASES])
def test_ep_dispatch_matches_jax(world4, case):
    """Each rank's rows of the dispatch's output equal JAX's
    expert-parallel function on its mesh (same layout) and the
    single-device grouped path; the gradients of sum(out^2) w.r.t. the
    tokens and each expert bank (the bank's summed over 'data') equal
    JAX's, which equal the single-device ones. The capacity case (cap 2)
    drops the slots JAX's drops: equal outputs and gradients, the dropped
    rows zero in both."""
    _, kind, n_ep, cap = next(c for c in R.DISPATCH_CASES if c[0] == case)
    d = R.case_inputs(kind)
    names = R._expert_names(kind)
    mesh, ep, one = _jax_fns(kind, n_ep, cap)
    args = [jnp.asarray(d[n]) for n in ("x", "sel", "w")]
    banks = [jnp.asarray(d[n]) for n in names]
    argn = tuple(range(1 + len(banks)))
    with mesh:
        jep_out = np.asarray(jax.jit(ep)(*args, *banks))
        grads = jax.jit(jax.grad(
            lambda x, *b: (ep(x, args[1], args[2], *b) ** 2).sum(),
            argnums=argn))(args[0], *banks)
    single = np.asarray(one(*args, *banks))
    if cap is None:
        sgrads = jax.grad(
            lambda x, *b: (one(x, args[1], args[2], *b) ** 2).sum(),
            argnums=argn)(args[0], *banks)
        for a, b in zip(grads, sgrads):
            np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5,
                                       atol=2e-5)
    got = np.zeros_like(single)
    for r in world4:
        rows, out, g, eidx = r["dispatch"][case]
        got[rows] = np32(out)
        np.testing.assert_allclose(np32(g["x"]), np32(grads[0])[rows], **TOL)
        for n, want in zip(names, grads[1:]):
            e_loc = want.shape[0] // n_ep
            np.testing.assert_allclose(
                np32(g[n]), np32(want)[eidx * e_loc:(eidx + 1) * e_loc],
                rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got, jep_out, **TOL)
    if cap is None:
        np.testing.assert_allclose(got, single, **TOL)
    else:
        dropped = np.all(jep_out == 0, axis=-1)
        assert dropped.any() and np.array_equal(
            np.all(got == 0, axis=-1), dropped)
        assert np.linalg.norm(got) < np.linalg.norm(single)


@pytest.mark.parametrize("case", [c[0] for c in R.COMPETITION_CASES])
def test_ep_competition_matches_jax(world4, case):
    """The sharded competition step: each rank's rows of the affinity,
    the global top-k and the selected outputs equal JAX's sharded step
    and its single-device one; the gradients of sum(topk^2) + sum(aff *
    c) equal the single-device gradients, and so do JAX's sharded ones
    (no gap between JAX's shard_map gradient and its own single-device
    gradient here)."""
    _, kind, n_ep = next(c for c in R.COMPETITION_CASES if c[0] == case)
    d = R.case_inputs(kind)
    names = R._expert_names(kind)
    mesh = jmake_mesh(n_expert=n_ep, devices=jax.devices()[:4])
    if kind == "kv":
        ep = jep.make_ep_all_experts_kv(mesh, jax.nn.relu, R.K_COMP)
        one = lambda x, *b: jec.competition_all_experts_kv(  # noqa: E731
            x, *b, jax.nn.relu, R.K_COMP)
    else:
        ep = jep.make_ep_all_experts_mlp2(mesh, jquick_gelu, R.K_COMP)
        one = lambda x, *b: jec.competition_all_experts_mlp2(  # noqa: E731
            x, *b, jquick_gelu, R.K_COMP)
    x = jnp.asarray(d["x"])
    banks = [jnp.asarray(d[n]) for n in names]
    c = jnp.asarray(R.competition_cotangent(x.shape[0], banks[0].shape[0]))

    def loss(fn):
        def f(x, *b):
            aff, tk, _ = fn(x, *b)
            return (tk ** 2).sum() + (aff * c).sum()
        return f
    argn = tuple(range(1 + len(banks)))
    with mesh:
        jaff, jtk, jsel = jax.jit(ep)(x, *banks)
        jgrads_ep = jax.jit(jax.grad(loss(ep), argnums=argn))(x, *banks)
    saff, stk, ssel = one(x, *banks)
    sgrads = jax.grad(loss(one), argnums=argn)(x, *banks)
    for a, b in zip(jgrads_ep, sgrads):
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(jsel), np.asarray(ssel))
    for r in world4:
        rows, aff, tk, sel, g, eidx = r["competition"][case]
        np.testing.assert_allclose(np32(aff), np32(jaff)[rows], **TOL)
        np.testing.assert_allclose(np32(aff), np32(saff)[rows], **TOL)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel)[rows])
        np.testing.assert_allclose(np32(tk), np32(jtk)[rows], **TOL)
        np.testing.assert_allclose(np32(g["x"]), np32(sgrads[0])[rows],
                                   rtol=1e-5, atol=2e-5)
        for n, want in zip(names, sgrads[1:]):
            e_loc = want.shape[0] // n_ep
            np.testing.assert_allclose(
                np32(g[n]), np32(want)[eidx * e_loc:(eidx + 1) * e_loc],
                rtol=1e-5, atol=5e-5)


def test_aux_losses_over_the_global_batch(world4):
    """The aux-loss trap. Mixtral's balance (its density means over the
    flattened tokens) and an entropy balance over tokens that span the
    ranks' rows, computed on 4 ranks with the world as the batch axis,
    equal the single-process values (JAX's `switch_balance_loss` and
    `entropy_balance_loss` over the whole batch), and the gradient of
    the ranks' summed objectives w.r.t. each rank's logits is the
    single-process gradient. The per-rank statistics averaged over the
    ranks are a different number, which this test tells apart."""
    from competesmoe_tpu.ops import losses as jl
    full = R.aux_inputs()
    b, n, e = full.shape
    lg = jnp.asarray(full)
    soft = jax.nn.softmax(lg, -1)
    _, sel = jax.lax.top_k(lg, 2)

    def both(lg):
        soft = jax.nn.softmax(lg, -1)
        _, sel = jax.lax.top_k(lg, 2)
        bal = jl.switch_balance_loss(soft.reshape(b * n, e),
                                     sel.reshape(b * n, -1), e)
        ent = jl.entropy_balance_loss(lg.reshape(b * n, e))
        return bal, ent
    bal, ent = both(lg)
    grad = jax.grad(lambda lg: sum(both(lg)))(lg)
    del soft, sel
    per_rank = [(r["aux"]["balance_local"], r["aux"]["entropy_local"])
                for r in world4]
    for r in world4:
        a = r["aux"]
        np.testing.assert_allclose(a["balance"], float(bal), rtol=1e-5)
        np.testing.assert_allclose(a["entropy"], float(ent), rtol=1e-5)
        np.testing.assert_allclose(np32(a["grad"]), np32(grad)[a["rows"]],
                                   rtol=1e-4, atol=1e-6)
    assert abs(np.mean([p[0] for p in per_rank]) - float(bal)) > 1e-2
    assert abs(np.mean([p[1] for p in per_rank]) - float(ent)) > 1e-2


def test_sharded_8bit_adam_equals_unsharded(world2):
    """The LM optimizer with 8-bit moments (clipping active) on
    parameters sharded over 2 ranks: along a non-block dim, along the
    block dim at a multiple of 256, and at a cut that would split a block
    (gathered, the moments kept whole). After each of 3 steps the
    shards, put together, equal the unsharded parameters exactly."""
    from competesmoe_tpu_torch.train.lm_trainer import (OptConfig,
                                                        make_optimizer)
    shapes = R.adam_param_shapes()
    params = {n: torch.full(s, 0.5) for n, s, _, _ in shapes}
    opt = make_optimizer(OptConfig(lr=1e-2, grad_clip=0.5, state_8bit=True,
                                   total_steps=10))
    state = opt.init(params)
    for step in range(3):
        opt.apply(params, {n: torch.from_numpy(v) for n, v in
                           R.adam_grads(step).items()}, state)
        for n, _, dim, _ in shapes:
            got = torch.cat([w["adam"][step][n] for w in world2], dim)
            np.testing.assert_allclose(got.numpy(), params[n].numpy(),
                                       rtol=0, atol=1e-7)


def test_global_norm_counts_each_shard_once(world2):
    """optax.global_norm over gradients sharded over 2 ranks plus a
    replicated one, and the clipped shards, equal the unsharded norm and
    clip (clipping active)."""
    from competesmoe_tpu_torch.train.lm_trainer import (clip_by_global_norm,
                                                        global_norm)
    import optax
    gs = R.adam_grads(0)
    full = [torch.from_numpy(gs[n]) for n, _, _, _ in R.adam_param_shapes()]
    full.append(torch.ones(3))
    want = float(global_norm(full))
    np.testing.assert_allclose(
        want, float(optax.global_norm([jnp.asarray(t.numpy()) for t in full])),
        rtol=1e-6)
    clipped = clip_by_global_norm(full, 1.0)
    for i, (n, _, dim, _) in enumerate(R.adam_param_shapes()):
        got = torch.cat([w["norm"][1][i] for w in world2], dim)
        np.testing.assert_allclose(got.numpy(), clipped[i].numpy(),
                                   rtol=1e-6, atol=1e-8)
    for w in world2:
        np.testing.assert_allclose(w["norm"][0], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# refusals, the job record
# ---------------------------------------------------------------------------

def test_impl_ep_needs_a_mesh_as_in_jax():
    from competesmoe_tpu_torch.ops import expert_compute as tec
    d = R.kv_inputs(0)
    with pytest.raises(ValueError, match="expert-parallel mesh"):
        jec.moe_ffn_kv(*(jnp.asarray(d[n]) for n in
                         ("x", "sel", "w", "keys", "values")),
                       jax.nn.relu, impl="ep")
    with pytest.raises(ValueError, match="expert-parallel mesh"):
        tec.moe_ffn_kv(*(torch.from_numpy(d[n]) for n in
                         ("x", "sel", "w", "keys", "values")),
                       torch.relu, impl="ep")
    # one process with an expert axis of 1: the context holds no mesh
    from competesmoe_tpu_torch.parallel import ep_context
    with ep_context.use_expert_parallel(tmesh.make_mesh()):
        assert ep_context.current_ep_mesh() is None
    # a seq axis of 2 needs 2 ranks, as JAX's mesh needs 2 devices
    with pytest.raises(ValueError, match="not divisible by expert=1 x "
                                         "seq=2"):
        tmesh.make_mesh(n_seq=2)


def test_backend_is_chosen_not_fallen_back_to(monkeypatch):
    """NCCL when each rank has a card of its own, gloo on the CPU or when
    ranks share a card; a forced NCCL without a card raises."""
    from competesmoe_tpu_torch.parallel import distributed as D
    env = D.DistributedEnv(rank=0, world_size=2)
    assert D.choose_backend(env, "cpu")[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    backend, why = D.choose_backend(env, "cuda")
    assert backend == "gloo" and "share" in why
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.choose_backend(env, "cuda")[0] == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert D.choose_backend(D.DistributedEnv(rank=0, world_size=8),
                            "cuda")[0] == "gloo"


def test_job_record_resumes_a_restarted_job(tmp_path, monkeypatch):
    """A preemptible SLURM job records its checkpoint directory under
    -job_record_dir; the restarted job (SLURM_RESTART_COUNT > 0) resumes
    from the recorded directory even under another -name (JAX's
    lm_task.py:324-352)."""
    from competesmoe_tpu_torch.train.lm_task import get_task
    from competesmoe_tpu_torch.utils.argparser import build_parser
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    monkeypatch.setenv("SLURM_RESTART_COUNT", "0")
    jobs = tmp_path / "jobs"
    flags = R.TASK_FLAGS + ["-run_dir", str(tmp_path), "-job_record_dir",
                            str(jobs)]
    a = build_parser().parse(flags + ["-name", "first"])
    t = get_task(a.task)(a)
    record = jobs / "slurm-4242"
    assert record.read_text() == str(tmp_path / "first" / "checkpoint")
    t.train(n_steps=2)                    # saves at step 2
    monkeypatch.setenv("SLURM_RESTART_COUNT", "1")
    b = build_parser().parse(flags + ["-name", "renamed"])
    t2 = get_task(b.task)(b)
    assert t2.state.step == 2
    assert t2.saver.dir == tmp_path / "first" / "checkpoint"
    w1 = dict(t.model.named_parameters())
    for k, v in t2.model.named_parameters():
        assert torch.equal(v, w1[k])


def test_lora_folds_over_a_gathered_weight():
    """LoRA on a weight that FSDP gathers at use (`mesh.gather_on_use`;
    here an axis of one rank, so the gather is the shard itself): the
    adapted weight is the gathered one plus the fold, the factors take
    the gradient, and leaving `apply_lora` leaves the gather in place."""
    from competesmoe_tpu_torch.train import lora as tlora
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5))
    w0 = model[0].weight.detach().clone()
    axis = tmesh.Axis("data", 1, 0, (0,))
    tmesh.gather_on_use(model[0], "weight", axis, 0)
    assert tmesh.canonical_name(next(
        n for n, _ in model.named_parameters() if "weight" in n)) == \
        "0.weight"
    factors = tlora.init_lora_params(model, 2, torch.Generator()
                                     .manual_seed(1),
                                     filter_fn=lambda n, m: n == "0")
    with torch.no_grad():
        factors.b[0].normal_()
    x = torch.randn(3, 6)
    want = x @ (w0 + 0.5 * (factors.a[0] @ factors.b[0]).t()).t() \
        + model[0].bias
    with tlora.apply_lora(model, factors, 0.5):
        got = model(x)
        got.sum().backward()
    torch.testing.assert_close(got, want)
    assert factors.a[0].grad is not None and factors.b[0].grad is not None
    assert tmesh.sharded_holder(model[0], "weight").folds == {}
    torch.testing.assert_close(model[0].weight, w0)
