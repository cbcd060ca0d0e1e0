"""Training over several ranks against JAX's mesh and the port's single
process: the LM trainer's steps with expert parallelism (2 x 2 ranks,
JAX's test_ep_train_step_matches_single_shard model), with FSDP and with
expert-sharded weights gathered at use (`-moe.impl fused`); the LM task
at 4 ranks against 1, its checkpoint restored across world sizes; and
`cli/train_mm --n-expert 2` at 2 ranks against 1.

The ranks are gloo processes on the CPU (`torch_parallel_ranks.spawn`),
one world per module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.moe import build_flip_schedule as jbuild
from competesmoe_tpu.parallel import make_mesh as jmake_mesh
from competesmoe_tpu.parallel import use_expert_parallel as juse_ep
from competesmoe_tpu.parallel.mesh import batch_sharding, make_param_shardings
from competesmoe_tpu.train import lm_trainer as jtrainer
from competesmoe_tpu_torch.convert import from_jax_params



@pytest.fixture(scope="module")
def jax_runs():
    """JAX's 3 steps on the 2 x 2 EP mesh and on one device, from the
    same init; the init as the port's state dict."""
    cfg = jlm.LMConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                       n_experts=8, expert_size=8, moe_topk=2,
                       moe_name="competesmoe", moe_args=JMoEArgs(),
                       dtype=jnp.float32)
    sched = jbuild(cfg.n_layers, total_steps=4, warm_up=0.0, rate_flip=1.0,
                   max_compete_in_iter=2, seed=0)
    model = jlm.MoELanguageModel(cfg, flip_schedule=sched)
    toks = R.lm_tokens()
    params = model.init(jax.random.PRNGKey(0),
                        jnp.asarray(toks[0, :, :-1]))["params"]
    opt = jtrainer.make_optimizer(jtrainer.OptConfig(**R.LM_OPT))
    step = jtrainer.make_train_step(model, opt, donate=False)
    runs = {}
    mesh = jmake_mesh(n_expert=2, devices=jax.devices()[:4])
    for name in ("single", "ep"):
        state = jtrainer.TrainState.create(params, opt)
        metrics = []
        if name == "ep":
            with juse_ep(mesh):
                state = state.replace(params=jax.device_put(
                    params, make_param_shardings(mesh, params)))
                for t in toks:
                    state, m = step(state, jax.device_put(
                        jnp.asarray(t), batch_sharding(mesh)))
                    metrics.append({k: float(v) for k, v in m.items()})
        else:
            for t in toks:
                state, m = step(state, jnp.asarray(t))
                metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = (metrics, from_jax_params(jax.tree_util.tree_map(
            np.asarray, state.params)))
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params)), runs


@pytest.fixture(scope="module")
def world4(jax_runs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train4")
    init, _ = jax_runs
    torch.save(init, tmp / "init.pt")
    # the single-process task first: 2 steps, saved at 2, for the ranks to
    # restore
    R.task_run(tmp, "w1", steps=2)
    import shutil
    shutil.copytree(tmp / "w1" / "checkpoint", tmp / "w1_at_2")
    ranks = R.spawn(R.world4_runs, 4, tmp, str(tmp / "init.pt"), str(tmp))
    return tmp, ranks


def _close_metrics(got, want, loss_rtol=2e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss/total"], w["loss/total"],
                                   rtol=loss_rtol, atol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
        assert g["competesmoe/n_flip_layers"] == \
            w["competesmoe/n_flip_layers"]


def _close_params(got, want, rtol=2e-4, atol=2e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("run", list(R.LM_RUNS))
def test_lm_steps_over_ranks_match_jax_and_one_process(world4, jax_runs,
                                                       run):
    """3 CompeteSMoE steps (every step competes) at 4 ranks: with expert
    parallelism on JAX's 2 x 2 EP mesh (ep), with FSDP added (fsdp), with
    the expert banks sharded and gathered at use (fused), and data
    parallel with FSDP over 4 (dp). Losses (rtol 2e-5), grad_norm and the
    parameters after the 3 steps (rtol 2e-4) equal JAX's EP mesh step and
    its single device, and every rank reports the same metrics."""
    _, ranks = world4
    init, jruns = jax_runs
    metrics, params, traffic = ranks[0][run]
    for r in ranks[1:]:
        assert r[run][0] == metrics
    # every step competes: the sharded competition step's reduce-scatter
    assert traffic["reduce_scatter"] > 0
    for name in ("ep", "single"):
        _close_metrics(metrics, jruns[name][0])
        _close_params(params, jruns[name][1])
    assert [m["competesmoe/n_flip_layers"] for m in metrics] == [2, 2, 2]


def test_lm_steps_one_process_matches_jax(jax_runs):
    """The same 3 steps in one process (no process group) equal JAX's."""
    init, jruns = jax_runs
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        torch.save(init, f"{d}/init.pt")
        metrics, params, traffic = R.lm_steps(f"{d}/init.pt", n_expert=1)
    assert traffic == {}
    _close_metrics(metrics, jruns["single"][0])
    _close_params(params, jruns["single"][1])


def test_lm_task_at_four_ranks_matches_one(world4):
    """The LM task (-n_expert_shards 2, 4 ranks) logs the losses and
    grad norms of the same task in one process, step for step, and saves
    where it does."""
    tmp, ranks = world4
    losses4, saved4, traffic = ranks[0]["task"]
    one, saved1, _ = R.task_run(tmp, "w1", steps=1)    # resumes at 2, to 3
    assert sorted(losses4) == [0, 1, 2] and saved4 == [2, 3]
    # steps where a layer did not compete dispatched its tokens
    assert traffic["all_to_all"] > 0
    for step, (loss, gn) in one.items():
        np.testing.assert_allclose(losses4[step][0], loss, rtol=1e-5)
        np.testing.assert_allclose(losses4[step][1], gn, rtol=1e-4)
    assert all(r["task"] is None for r in ranks[1:])


def test_checkpoint_restores_across_world_sizes(world4):
    """A checkpoint written by 4 ranks (rank 0 writes the gathered state)
    restores in one process, and one written by one process restores at 4
    ranks; either way the next step's loss is the uninterrupted run's."""
    tmp, ranks = world4
    losses4 = ranks[0]["task"][0]
    # 4 -> 1: one process resumes the 4-rank run from its step-2 save
    got, _, _ = R.task_run(tmp, "w1from4", steps=1,
                        restore_from=f"{tmp}/w4/checkpoint/model-2")
    np.testing.assert_allclose(got[2][0], losses4[2][0], rtol=1e-5)
    # 1 -> 4: the ranks resumed the single process's step-2 save
    restored = ranks[0]["task_restored"][0]
    np.testing.assert_allclose(restored[2][0], losses4[2][0], rtol=1e-5)


@pytest.fixture(scope="module")
def mm_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mm")
    two = R.spawn(R.mm_world2, 2, tmp / "w2", str(tmp / "w2"))
    # the same global batch: 2 rows a rank x 2 ranks, 4 rows in one
    one = {run: R.mm_train(tmp / f"w1{run}",
                           ["--per-device-batch-size", "4", *flags])
           for run, flags in (("sft", []), ("lora", R.MM_LORA_FLAGS))}
    return one, {"sft": [r[0] for r in two], "lora": [r[1] for r in two]}


@pytest.mark.parametrize("run", ["sft", "lora"])
def test_train_mm_n_expert_2_matches_one_process(mm_runs, run):
    """`cli.train_mm.train` with `--n-expert 2` (the tower's and the
    projector's mlp2 experts sharded, tokens and the competition step
    over the expert axis, 2 accumulation microbatches) at 2 ranks: each
    step's loss, aux losses, grad_norm and competing layers equal one
    process's; so do LoRA's steps (the factors replicated, their
    gradients summed over the ranks) and its eval losses (each rank
    scoring its rows of the eval batch)."""
    one, two = mm_runs
    one, _, evals1 = one[run]
    (two, traffic, evals2), (two1, _, none) = two[run]
    assert two == two1 and traffic["all_to_all"] > 0 and none is None
    np.testing.assert_allclose(evals2, evals1, rtol=1e-5)
    assert len(evals1) == (2 if run == "lora" else 0)
    assert any(any(r["vision/is_comp"]) for r in one)
    for g, w in zip(two, one):
        assert g["vision/is_comp"] == w["vision/is_comp"]
        assert g["projector/is_comp"] == w["projector/is_comp"]
        for k in ("loss/total", "loss/aux_mlp", "loss/aux_clip"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
