"""Sequence parallelism against JAX: the port's ring and masked ring
attention (`parallel/ring_attention.py`) against JAX's
`make_ring_attention*` on its virtual CPU mesh (seq axes of 4 and 2,
causal and not, padded and random validity; bf16 with gradients); the LM
step on a seq mesh (4 ranks on 'seq', and 2 x 2 with expert parallelism)
against JAX's seq-mesh step and the port's single process, also with the
Transformer-XL carry; the LLaVA multimodal loss on a ('data', 'seq')
mesh against JAX's (JAX's test_ring_attention.py models and bounds); the
gathered paths (MoA, and decoders off JAX's masked ring: GQA, a sliding
window, ALiBi) and the LM task with `-n_seq_shards 2` against one
process.

The ranks are gloo processes on the CPU (`torch_parallel_ranks.spawn`),
one 4-rank world for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.moe import build_flip_schedule as jbuild
from competesmoe_tpu.parallel.ring_attention import (
    make_ring_attention as jring, make_ring_attention_masked as jring_masked)
from competesmoe_tpu.parallel.seq_context import (
    use_sequence_parallel as juse_seq)
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import lm as tlm
from competesmoe_tpu_torch.moe import MoEArgs
from tests.test_llava import tiny_llava_cfg
from tests.test_torch_port_models import port_llava_cfg

F32 = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-5)
BF16 = dict(rtol=0.1, atol=0.15)     # JAX's test_ring_attention_bf16


def jseq_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def jax_ring(d, n, causal=True, masked=False):
    mesh = jseq_mesh(n)
    sh4 = NamedSharding(mesh, P(None, "seq", None, None))
    sh2 = NamedSharding(mesh, P(None, "seq"))
    with mesh:
        if masked:
            pos = jax.device_put(jnp.asarray(d["pos"]), sh2)
            return np.asarray(jax.jit(jring_masked(mesh))(
                *(jax.device_put(jnp.asarray(d[k]), sh4)
                  for k in ("q", "k", "v")),
                pos, pos, jax.device_put(jnp.asarray(d["valid"]), sh2)))
        return np.asarray(jax.jit(jring(mesh, causal=causal))(
            *(jax.device_put(jnp.asarray(d[k]), sh4)
              for k in ("q", "k", "v"))))


def lm_cfgs(**kw):
    """JAX's test_lm_train_step_with_sequence_parallel model, and the
    port's."""
    base = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                n_experts=4, expert_size=8, moe_topk=2,
                moe_name="competesmoe")
    base.update(kw)
    jcfg = jlm.LMConfig(**base, moe_args=JMoEArgs(), dtype=jnp.float32)
    return jcfg, tlm.LMConfig(**base, moe_args=MoEArgs(),
                              dtype=torch.float32)


def lm_windows(n=1, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 120, (4, 33)).astype(np.int32)
            for _ in range(n)]


def jax_lm(jcfg, windows, mesh=None):
    """JAX's loss CE + aux at step 1 over each window (carrying the state
    where the config does) and the gradients of the last, on one device
    or its seq mesh; the init params."""
    sched = jbuild(jcfg.n_layers, **R.LM_SEQ_SCHEDULE)
    model = jlm.MoELanguageModel(jcfg, flip_schedule=sched)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.asarray(windows[0][:, :-1]))

    def f(p, toks, state):
        logits, aux = model.apply(p, toks[:, :-1], train=True,
                                  step=jnp.int32(1), state=state)
        ce, _ = jlm.lm_loss_fn(logits, toks[:, 1:])
        return ce + aux["total_aux_loss"], aux.get("state")

    step = jax.jit(jax.value_and_grad(f, has_aux=True))
    losses, state, grads = [], None, None
    for w in windows:
        if mesh is None:
            (loss, state), grads = step(params, jnp.asarray(w), state)
        else:
            with juse_seq(mesh), mesh:
                toks = jax.device_put(jnp.asarray(w),
                                      NamedSharding(mesh, P("data", None)))
                (loss, state), grads = step(jax.device_put(params), toks,
                                            state)
        losses.append(float(loss))
    return losses, from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                          grads)), params


def llava_batch():
    """JAX's mm loss test's batch: 13 tokens with an image (16 spliced
    positions), row 2 padded from 10."""
    rng = np.random.default_rng(3)
    ids = rng.integers(2, 60, (4, 13)).astype(np.int32)
    ids[:, 1] = jllava.IMAGE_TOKEN_INDEX
    labels, mask = ids.copy(), np.ones_like(ids)
    mask[2, 10:] = 0
    px = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    return dict(input_ids=ids, labels=labels, attention_mask=mask,
                images=px)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results, the port's single process, and the 4-rank world."""
    tmp = tmp_path_factory.mktemp("ring")
    jcfg, tcfg = lm_cfgs()
    windows = lm_windows()
    jl, jgrads, params = jax_lm(jcfg, windows)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                 ("data", "seq"))
    jl_seq, jgrads_seq, _ = jax_lm(jcfg, windows, mesh=jmesh)
    torch.save(from_jax_params(params), tmp / "lm.pt")

    xjcfg, xtcfg = lm_cfgs(moe_name="smoe", n_prev_states=1)
    xwindows = lm_windows(2, seed=5)
    xjl, xjgrads, xparams = jax_lm(xjcfg, xwindows)
    torch.save(from_jax_params(xparams), tmp / "xl.pt")

    lcfg = tiny_llava_cfg(moe=True)
    batch = llava_batch()
    model = jllava.LlavaModel(lcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lparams = model.init(jax.random.PRNGKey(0), jb["input_ids"],
                         jb["images"], labels=jb["labels"],
                         attention_mask=jb["attention_mask"])

    def mm_loss(p):
        return model.apply(p, jb["input_ids"], jb["images"],
                           labels=jb["labels"],
                           attention_mask=jb["attention_mask"], train=True,
                           step=jnp.int32(1)).loss

    ll, lgrads = jax.jit(jax.value_and_grad(mm_loss))(lparams)
    torch.save(from_jax_params(lparams), tmp / "llava.pt")
    tl_cfg = port_llava_cfg(lcfg)

    # the gathered paths: MoA, and decoders JAX keeps off the masked ring
    _, mcfg = lm_cfgs(moe_name="smoe", att_moe=True, att_n_experts=4,
                      att_k=2)
    torch.save(tlm.MoELanguageModel(mcfg, device="cpu").init_weights(3)
               .state_dict(), tmp / "moa.pt")
    dec_states = {}
    for name, kw in R.DECODER_SEQ_CASES.items():
        from competesmoe_tpu_torch.models.decoder import DecoderLM
        torch.manual_seed(4)
        dec = DecoderLM(R.tp_decoder_cfg(**kw), device="cpu")
        with torch.no_grad():
            for p in dec.parameters():
                p.normal_(0.0, 0.2)
        dec_states[name] = str(tmp / f"dec_{name}.pt")
        torch.save(dec.state_dict(), dec_states[name])
    single = dict(lm=R.lm_seq_grads(str(tmp / "lm.pt"), tcfg, windows, 1),
                  xl=R.lm_seq_grads(str(tmp / "xl.pt"), xtcfg, xwindows, 1),
                  moa=R.lm_seq_grads(str(tmp / "moa.pt"), mcfg, windows, 1),
                  decoder={name: R.decoder_seq_logits(path, name)
                           for name, path in dec_states.items()})
    ranks = R.spawn(R.seq_world4, 4, tmp, str(tmp), str(tmp / "lm.pt"), tcfg,
                    windows, str(tmp / "xl.pt"), xtcfg, xwindows,
                    str(tmp / "llava.pt"), tl_cfg, batch,
                    str(tmp / "moa.pt"), mcfg, dec_states)
    task1 = R.task_run(tmp, "seq1")
    return dict(jax=dict(lm=(jl, jgrads), lm_seq=(jl_seq, jgrads_seq),
                         xl=(xjl, xjgrads),
                         llava=(float(ll), from_jax_params(
                             jax.tree_util.tree_map(np.asarray, lgrads)))),
                single=single, ranks=ranks, task1=task1)


def _blocks(ranks, key, n):
    """The whole output of a seq axis of n from the ranks' blocks (the
    first n ranks hold blocks 0..n-1 in both meshes)."""
    return torch.cat([ranks[r]["ring"][key] for r in range(n)], dim=1)


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(runs, n, causal):
    got = _blocks(runs["ranks"], ("ring", n, causal), n).numpy()
    want = jax_ring(R.ring_inputs(n), n, causal=causal)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("form", ["padded", "fuzz"])
def test_masked_ring_attention_matches_jax(runs, n, form):
    """Rows with a valid key match JAX's; a row whose every key is masked
    is exactly zero in both."""
    d = R.ring_inputs(10 + n, form)
    got = _blocks(runs["ranks"], ("masked", n, form), n).numpy()
    want = jax_ring(d, n, masked=True)
    m = ((d["pos"][:, None, :] <= d["pos"][:, :, None])
         & d["valid"][:, None, :])
    has = m.any(-1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[has], want[has], **F32)
    assert np.abs(got[~has]).max(initial=0.0) == 0.0
    assert np.abs(want[~has]).max(initial=0.0) == 0.0


def test_ring_attention_bf16_and_grads_match_jax(runs):
    """bf16 in, bf16 out, float32 inside; the gradients of sum(out^2)
    through the ring against JAX's ring, at JAX's bf16 bounds."""
    d = R.ring_inputs(7, B=1, T=16, h=2, p=8)
    parts = [runs["ranks"][r]["ring"][("bf16",)] for r in range(4)]
    assert all(p[0] == torch.bfloat16 for p in parts)
    mesh = jseq_mesh(4)
    ring = jring(mesh)
    sh = NamedSharding(mesh, P(None, "seq", None, None))
    args = [jax.device_put(jnp.asarray(d[k], jnp.bfloat16), sh)
            for k in ("q", "k", "v")]
    with mesh:
        out = jax.jit(ring)(*args)
        grads = jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(ring(q, k, v).astype(jnp.float32) ** 2),
            argnums=(0, 1, 2)))(*args)
    for i, want in enumerate([out, *grads], start=1):
        got = torch.cat([p[i] for p in parts], dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)


def _grads_close(got, want):
    """Every gradient within GRAD; where JAX's is NaN (its diversity loss
    differentiates jnp.linalg.norm at an all-zero expert output, ROADMAP
    §3) the port's is finite, and the rest are compared."""
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        assert np.isfinite(g).all(), k
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], err_msg=k, **GRAD)


@pytest.mark.parametrize("world", ["lm4", "lm22"])
def test_lm_step_on_a_seq_mesh_matches_jax(runs, world):
    """The loss and every gradient of the CompeteSMoE LM at a competition
    step: 4 ranks on 'seq', and 2 expert x 2 seq ranks with the
    all-to-all dispatch, against JAX's ('data', 'seq') mesh, JAX's one
    device and the port's one process."""
    losses, grads, _ = runs["ranks"][0][world]
    for ref_l, ref_g in (runs["jax"]["lm_seq"], runs["jax"]["lm"],
                         runs["single"]["lm"][:2]):
        np.testing.assert_allclose(losses, ref_l, **LOSS)
        _grads_close(grads, ref_g)
    # every rank reduced to the same gradients
    for r in range(1, 4):
        _grads_close(runs["ranks"][r][world][1], grads)


def test_lm_step_with_the_xl_carry_matches_jax(runs):
    """Two windows, the second carrying the first's states (each rank its
    block of them; the carried prefix's keys gathered over 'seq'): the
    losses and the second window's gradients against JAX and the port's
    one process, and the state blocks against the whole state."""
    losses, grads, state = runs["ranks"][0]["xl"]
    for ref_l, ref_g in (runs["jax"]["xl"], runs["single"]["xl"][:2]):
        np.testing.assert_allclose(losses, ref_l, **LOSS)
        _grads_close(grads, ref_g)
    whole = runs["single"]["xl"][2]
    for li, s in enumerate(whole):
        got = torch.cat([runs["ranks"][r]["xl"][2][li] for r in range(2)],
                        dim=1)
        np.testing.assert_allclose(got.numpy(), s[:2].numpy(), **F32)


def test_moa_on_a_seq_mesh_matches_one_process(runs):
    """MoA's attention, which JAX keeps off the ring, gathers the
    sequence's K/V over 'seq' (and its selection's entropy balance
    log-means over every rank's tokens): loss and gradients of one
    process."""
    losses, grads, _ = runs["ranks"][0]["moa"]
    ref_l, ref_g, _ = runs["single"]["moa"]
    np.testing.assert_allclose(losses, ref_l, **LOSS)
    _grads_close(grads, ref_g)


@pytest.mark.parametrize("name", list(R.DECODER_SEQ_CASES))
def test_decoder_gathered_path_on_a_seq_mesh(runs, name):
    """A decoder whose attention JAX does not send through the masked
    ring (GQA, a sliding window, ALiBi) on a ('data', 'seq') mesh of 2 x
    2: each rank's rows and sequence block of the logits equal one
    process's (a padded row and restarting positions)."""
    want = runs["single"]["decoder"][name].numpy()
    parts = [runs["ranks"][r]["decoder"][name] for r in range(4)]
    # rank r holds data block r // 2 and sequence block r % 2
    got = torch.cat([torch.cat(parts[d * 2:d * 2 + 2], dim=1)
                     for d in range(2)], dim=0).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_llava_mm_loss_on_a_seq_mesh_matches_jax(runs):
    """The multimodal loss on a ('data', 'seq') mesh of 2 x 2: the labels
    shifted before the split, CE over the global label count, the padded
    row's validity riding the masked ring; loss and gradients against
    JAX's."""
    want_l, want_g = runs["jax"]["llava"]
    for r in range(4):
        loss, grads = runs["ranks"][r]["llava"]
        np.testing.assert_allclose(loss, want_l, **LOSS)
        _grads_close(grads, want_g)


def test_lm_task_with_seq_shards_matches_one_process(runs):
    """-n_seq_shards 2 -n_expert_shards 2 through the LM task on 4 ranks:
    the logged losses and gradient norms of one process."""
    got, saved, traffic = runs["ranks"][0]["task"]
    want, saved1, _ = runs["task1"]
    assert sorted(got) == sorted(want) and saved == saved1
    for step in want:
        np.testing.assert_allclose(got[step], want[step], rtol=1e-4)
    assert traffic["ring_shift"] > 0
