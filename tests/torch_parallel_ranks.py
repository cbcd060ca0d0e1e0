"""Multi-rank scenarios of the port's parallel paths, run by processes that
`spawn` starts over gloo on the CPU (and, for `tests/test_torch_port_gpu
.py`, on one card that the ranks share). This module imports no JAX: the
ranks import it, and the card's machine has none. Each scenario runs on
every rank and returns what the tests compare; the tests hold it against
JAX's functions on its virtual CPU mesh and against the port's single
process.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch


def spawn(fn, world: int, tmp: Path, *args, timeout: float = 600.0):
    """Run `fn(*args)` on `world` ranks (gloo, `file://` rendezvous under
    `tmp`, so that concurrent test workers never share a port); returns
    each rank's result, in rank order."""
    import torch.multiprocessing as mp
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    init = tmp / f"init-{fn.__name__}-{os.getpid()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(init), str(tmp),
                                              fn, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
    if bad:
        errs = [(tmp / f"{fn.__name__}-rank{r}.err").read_text()
                if (tmp / f"{fn.__name__}-rank{r}.err").exists() else "?"
                for r, _ in bad]
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(errs))
    return [torch.load(tmp / f"{fn.__name__}-rank{r}.pt", weights_only=False)
            for r in range(world)]


def _entry(rank, world, init, out, fn, args):
    import traceback

    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world)
        res = fn(*args)
        torch.save(res, Path(out) / f"{fn.__name__}-rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(out, f"{fn.__name__}-rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# inputs, from numpy seeds (the parent makes the same)
# ---------------------------------------------------------------------------

def kv_inputs(seed, T=64, d=16, E=8, es=12, k=2, bias=False):
    rng = np.random.default_rng(seed)
    out = dict(x=rng.normal(size=(T, d)).astype(np.float32),
               keys=(rng.normal(size=(E, d, es)) * 0.2).astype(np.float32),
               values=(rng.normal(size=(E, es, d)) * 0.2).astype(np.float32),
               sel=rng.integers(0, E, (T, k)).astype(np.int32),
               w=rng.normal(size=(T, k)).astype(np.float32))
    w = np.exp(out["w"])
    out["w"] = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    if bias:
        out["b1"] = (rng.normal(size=(E, es)) * 0.1).astype(np.float32)
    return out


def mlp2_inputs(seed, T=64, d=16, E=8, h=12, k=2):
    rng = np.random.default_rng(seed)
    w = np.exp(rng.normal(size=(T, k)))
    return dict(x=rng.normal(size=(T, d)).astype(np.float32),
                w1=(rng.normal(size=(E, d, h)) * 0.2).astype(np.float32),
                b1=(rng.normal(size=(E, h)) * 0.1).astype(np.float32),
                w2=(rng.normal(size=(E, h, d)) * 0.2).astype(np.float32),
                b2=(rng.normal(size=(E, d)) * 0.1).astype(np.float32),
                sel=rng.integers(0, E, (T, k)).astype(np.int32),
                w=(w / w.sum(-1, keepdims=True)).astype(np.float32))


def swiglu_inputs(seed, T=64, d=16, E=8, h=12, k=2):
    rng = np.random.default_rng(seed)
    w = np.exp(rng.normal(size=(T, k)))
    return dict(x=rng.normal(size=(T, d)).astype(np.float32),
                w1=(rng.normal(size=(E, d, h)) * 0.2).astype(np.float32),
                w3=(rng.normal(size=(E, d, h)) * 0.2).astype(np.float32),
                w2=(rng.normal(size=(E, h, d)) * 0.2).astype(np.float32),
                sel=rng.integers(0, E, (T, k)).astype(np.int32),
                w=(w / w.sum(-1, keepdims=True)).astype(np.float32))


def capacity_inputs():
    """All tokens pick experts 0 and 1: shard 0 is oversubscribed
    (JAX's test_ep_capacity_drop)."""
    d = kv_inputs(1, T=32, d=8, E=4, es=8)
    d["sel"] = np.zeros((32, 2), np.int32)
    d["sel"][:, 1] = 1
    d["w"] = np.full((32, 2), 0.5, np.float32)
    return d


# cases of the dispatch: (name, kind, n_ep, capacity)
DISPATCH_CASES = (("kv-ep2", "kv", 2, None), ("kv-ep4", "kv", 4, None),
                  ("kv-bias-ep2", "kv_bias", 2, None),
                  ("kv-bias-ep4", "kv_bias", 4, None),
                  ("mlp2-ep2", "mlp2", 2, None), ("mlp2-ep4", "mlp2", 4, None),
                  ("swiglu-ep2", "swiglu", 2, None),
                  ("swiglu-ep4", "swiglu", 4, None),
                  ("capacity-ep2", "capacity", 2, 2))
COMPETITION_CASES = (("kv-ep2", "kv", 2), ("kv-ep4", "kv", 4),
                     ("mlp2-ep2", "mlp2", 2))
K_COMP = 2


def case_inputs(kind):
    return {"kv": lambda: kv_inputs(0), "kv_bias": lambda: kv_inputs(3, bias=True),
            "mlp2": lambda: mlp2_inputs(4), "swiglu": lambda: swiglu_inputs(5),
            "capacity": capacity_inputs}[kind]()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _expert_names(kind):
    return {"kv": ("keys", "values"), "kv_bias": ("keys", "values", "b1"),
            "capacity": ("keys", "values"),
            "mlp2": ("w1", "b1", "w2", "b2"), "swiglu": ("w1", "w3", "w2")}[kind]


def _shard(a: torch.Tensor, axis):
    n = a.shape[0] // axis.size
    return a[axis.index * n:(axis.index + 1) * n].clone()


def dispatch_scenarios():
    """Each DISPATCH_CASES case through the expert-parallel dispatch on
    this rank's rows and expert shards, forward and the gradients of
    sum(out^2): {case: (rows, out, {name: grad of this rank's tensor})},
    the banks' gradients summed over 'data' (as the trainer does)."""
    from competesmoe_tpu_torch.parallel import expert_parallel as EP
    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel.mesh import make_mesh, local_rows
    res = {}
    meshes = {n: make_mesh(n_expert=n) for n in (2, 4)}
    for name, kind, n_ep, cap in DISPATCH_CASES:
        mesh = meshes[n_ep]
        ax = mesh.axis("expert")
        d = case_inputs(kind)
        rows = local_rows(d["x"].shape[0], mesh)
        x = torch.from_numpy(d["x"][rows]).requires_grad_()
        sel = torch.from_numpy(d["sel"][rows]).long()
        w = torch.from_numpy(d["w"][rows])
        names = _expert_names(kind)
        banks = [_shard(torch.from_numpy(d[n]), ax).requires_grad_()
                 for n in names]
        if kind in ("kv", "capacity"):
            fn = EP.make_ep_ffn_kv(mesh, torch.relu, capacity=cap)
        elif kind == "kv_bias":
            fn = EP.make_ep_ffn_kv(mesh, torch.relu, with_bias=True)
        elif kind == "mlp2":
            fn = EP.make_ep_ffn_mlp2(mesh, quick_gelu)
        else:
            fn = EP.make_ep_ffn_swiglu(mesh)
        out = fn(x, sel, w, *banks)
        (out ** 2).sum().backward()
        grads = {"x": x.grad}
        for n, b in zip(names, banks):
            g = b.grad.clone()
            C.all_reduce_([g], mesh.axis("data"))
            grads[n] = g
        res[name] = (rows, out.detach(), grads, ax.index)
    return res


def competition_scenarios():
    """The sharded competition step (kv with relu, mlp2 with quick_gelu)
    on this rank's rows: affinity, sel, top-k outputs, and the gradients
    of sum(topk^2) + sum(affinity * c) (c fixed from a seed)."""
    from competesmoe_tpu_torch.parallel import expert_parallel as EP
    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel.mesh import make_mesh, local_rows
    res = {}
    meshes = {n: make_mesh(n_expert=n) for n in (2, 4)}
    for name, kind, n_ep in COMPETITION_CASES:
        mesh = meshes[n_ep]
        ax = mesh.axis("expert")
        d = case_inputs(kind)
        rows = local_rows(d["x"].shape[0], mesh)
        x = torch.from_numpy(d["x"][rows]).requires_grad_()
        names = _expert_names(kind)
        banks = [_shard(torch.from_numpy(d[n]), ax).requires_grad_()
                 for n in names]
        if kind == "kv":
            fn = EP.make_ep_all_experts_kv(mesh, torch.relu, K_COMP)
        else:
            fn = EP.make_ep_all_experts_mlp2(mesh, quick_gelu, K_COMP)
        aff, tk, sel = fn(x, *banks)
        c = torch.from_numpy(competition_cotangent(d["x"].shape[0],
                                                   d[names[0]].shape[0])[rows])
        ((tk ** 2).sum() + (aff * c).sum()).backward()
        grads = {"x": x.grad}
        for n, b in zip(names, banks):
            g = b.grad.clone()
            C.all_reduce_([g], mesh.axis("data"))
            grads[n] = g
        res[name] = (rows, aff.detach(), tk.detach(), sel, grads, ax.index)
    return res


def competition_cotangent(T, E):
    return np.random.default_rng(9).normal(size=(T, E)).astype(np.float32)


# ---------------------------------------------------------------------------
# aux losses over the global batch, 8-bit Adam, the global norm
# ---------------------------------------------------------------------------

def aux_inputs():
    rng = np.random.default_rng(11)
    # [B, N, E] logits whose rows differ by rank (a rank's rows skew to
    # its own experts), so per-rank statistics differ from global ones
    logits = rng.normal(size=(8, 6, 8)).astype(np.float32)
    for r in range(4):
        logits[2 * r:2 * r + 2, :, 2 * r:2 * r + 2] += 3.0
    return logits


def aux_scenarios():
    """Mixtral's flattened top-1 balance and a token-flattened entropy
    balance over this rank's rows, with the world as the batch axis, and
    the same with no axis (a per-rank statistic), with the gradient of
    the global value w.r.t. this rank's logits."""
    from competesmoe_tpu_torch.ops import losses as L
    from competesmoe_tpu_torch.ops import routing as R
    from competesmoe_tpu_torch.parallel import distributed_ops as D
    from competesmoe_tpu_torch.parallel.mesh import make_mesh, local_rows
    mesh = make_mesh()
    world = mesh.axis("world")
    full = aux_inputs()
    rows = local_rows(full.shape[0], mesh)
    lg = torch.from_numpy(full[rows]).requires_grad_()
    b, n, e = lg.shape
    soft = torch.softmax(lg, -1)
    _, sel = R.top_k(lg, 2)
    bal = L.switch_balance_loss(soft.reshape(b * n, e), sel.reshape(b * n, -1),
                                e, axis=world)
    bal_local = L.switch_balance_loss(soft.reshape(b * n, e),
                                      sel.reshape(b * n, -1), e)
    logp = torch.log_softmax(lg.reshape(b * n, e), -1)
    ent = -L.entropy_from_logprobs(D.log_mean(logp, dim=0, axis=world))
    ent_local = -L.entropy_from_logprobs(D.log_mean(logp, dim=0))
    # each rank's objective is 1/world of the replicated global values
    ((bal + ent) / world.size).backward()
    return dict(rows=rows, balance=float(bal), balance_local=float(bal_local),
                entropy=float(ent), entropy_local=float(ent_local),
                grad=lg.grad)


def adam_param_shapes():
    """(name, full shape, shard dim, block axis): a shard along a dim the
    blocks do not run along; one along the block dim cut at a multiple of
    the block; one whose cut would split a block (384 / 2 = 192)."""
    return (("rows", (8, 512), 0, -1), ("aligned", (4, 1024), 1, -1),
            ("split", (16, 384), 1, -1))


def adam_grads(step):
    rng = np.random.default_rng(100 + step)
    return {n: rng.normal(size=s).astype(np.float32)
            for n, s, _, _ in adam_param_shapes()}


def adam_scenario(steps: int = 3):
    """3 steps of the LM optimizer (8-bit moments, clipping active) on
    parameters sharded over the world (2 ranks), from shards of full
    gradients: this rank's parameter shards after each step."""
    from competesmoe_tpu_torch.parallel.mesh import make_mesh
    from competesmoe_tpu_torch.train.lm_trainer import (OptConfig,
                                                        make_optimizer)
    mesh = make_mesh()
    ax = mesh.axis("world")
    params, shards = {}, {}
    for n, shape, dim, _ in adam_param_shapes():
        full = torch.from_numpy(np.full(shape, 0.5, np.float32))
        params[n] = _cut(full, ax, dim)
        shards[n] = (ax, dim)
    opt = make_optimizer(OptConfig(lr=1e-2, grad_clip=0.5, state_8bit=True,
                                   total_steps=10))
    state = opt.init(params, shards=shards)
    out = []
    for s in range(steps):
        g = {n: _cut(torch.from_numpy(v), ax, shards[n][1])
             for n, v in adam_grads(s).items()}
        opt.apply(params, g, state)
        out.append({n: p.clone() for n, p in params.items()})
    return out


def _cut(t, ax, dim):
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n).clone()


def norm_scenario():
    """The global norm of gradients sharded over the world (the squares
    of each shard counted once) and the clipped shards."""
    from competesmoe_tpu_torch.parallel.mesh import make_mesh
    from competesmoe_tpu_torch.train.lm_trainer import (clip_by_global_norm,
                                                        global_norm)
    mesh = make_mesh()
    ax = mesh.axis("world")
    gs = adam_grads(0)
    ts, axes = [], []
    for n, _, dim, _ in adam_param_shapes():
        ts.append(_cut(torch.from_numpy(gs[n]), ax, dim))
        axes.append(ax)
    ts.append(torch.ones(3))        # a replicated gradient
    axes.append(None)
    return float(global_norm(ts, axes)), clip_by_global_norm(ts, 1.0, axes)


def four_rank_scenarios():
    """The 4-rank scenarios of tests/test_torch_port_parallel.py, in one
    world."""
    return {"dispatch": dispatch_scenarios(),
            "competition": competition_scenarios(),
            "aux": aux_scenarios()}


def two_rank_scenarios():
    return {"adam": adam_scenario(), "norm": norm_scenario()}


# ---------------------------------------------------------------------------
# the LM trainer and task
# ---------------------------------------------------------------------------

def lm_config(moe_impl="auto"):
    from competesmoe_tpu_torch.models import lm as tlm
    from competesmoe_tpu_torch.moe import MoEArgs
    return tlm.LMConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                        n_experts=8, expert_size=8, moe_topk=2,
                        moe_name="competesmoe", moe_args=MoEArgs(),
                        moe_impl=moe_impl, dtype=torch.float32)


LM_OPT = dict(total_steps=4, warmup_steps=0)


def lm_tokens(steps=3):
    return np.random.default_rng(3).integers(0, 64, (steps, 8, 17))


def lm_steps(state_path, n_expert=2, fsdp=False, moe_impl="auto",
             steps=3):
    """`steps` train steps of the tiny CompeteSMoE LM (JAX's EP test's
    model) from the weights at `state_path`, over a mesh of this world
    with `n_expert` ranks on the expert axis: each step's metrics, the
    full parameters after the last, and the bytes each collective sent
    from this rank over the steps."""
    from competesmoe_tpu_torch.models import lm as tlm
    from competesmoe_tpu_torch.moe import schedule as tsched
    from competesmoe_tpu_torch.parallel.ep_context import use_expert_parallel
    from competesmoe_tpu_torch.parallel.mesh import (full_state_dict,
                                                     make_mesh, put_batch,
                                                     shard_params)
    from competesmoe_tpu_torch.train import lm_trainer as T
    import contextlib
    cfg = lm_config(moe_impl)
    sched = tsched.build_flip_schedule(cfg.n_layers, total_steps=4,
                                       warm_up=0.0, rate_flip=1.0,
                                       max_compete_in_iter=2, seed=0)
    model = tlm.MoELanguageModel(cfg, flip_schedule=sched, device="cpu")
    model.load_state_dict(torch.load(state_path))
    mesh = make_mesh(n_expert=n_expert)
    ep = n_expert > 1 and moe_impl in ("auto", "ep")
    shard_params(model, mesh, fsdp=fsdp, fsdp_min_size=1024, ep=ep)
    opt = T.make_optimizer(T.OptConfig(**LM_OPT))
    state = T.TrainState.create(model, opt)
    step = T.make_train_step(model, opt, mesh=mesh)
    metrics = []
    from competesmoe_tpu_torch.parallel import collectives as C
    C.reset_bytes()
    with (use_expert_parallel(mesh) if ep else contextlib.nullcontext()):
        for toks in lm_tokens(steps):
            state, m = step(state, torch.from_numpy(put_batch(toks, mesh)))
            metrics.append({k: float(v) for k, v in m.items()})
    traffic = dict(C.BYTES)
    return metrics, full_state_dict(model), traffic


TASK_FLAGS = ["-stop_after", "3", "-batch_size", "8", "-lm.unroll", "16",
              "-lm.vocab_size", "64", "-state_size", "32",
              "-transformer.encoder_n_layers", "2", "-transformer.n_heads",
              "2", "-moe.n_experts", "8", "-moe.expert_size", "8",
              "-pkm.n_heads", "2", "-rate_flip", "0.5", "-warm_up", "0.0",
              "-log_interval", "1", "-valid_interval", "0", "-amp", "0",
              "-save_interval", "2", "-device", "cpu",
              "-lm.eval.enabled", "0"]


def task_run(run_dir, name, flags=(), steps=None, restore_from=None):
    """The LM task (`train/lm_task.py`) of this world: train `steps` steps
    (to -stop_after when None), optionally first restoring the
    checkpoint directory `restore_from`; the logged losses by step (rank
    0), the saved steps and the bytes each collective sent from rank 0."""
    import json

    from competesmoe_tpu_torch.train.lm_task import get_task
    from competesmoe_tpu_torch.utils.argparser import build_parser
    argv = TASK_FLAGS + ["-run_dir", str(run_dir), "-name", name, *flags]
    if restore_from:
        argv += ["-restore", str(restore_from)]
    from competesmoe_tpu_torch.parallel import collectives as C
    a = build_parser().parse(argv)
    t = get_task(a.task)(a)
    C.reset_bytes()
    t.train(n_steps=steps)
    t.logger.close()
    if rank() != 0:
        return None
    log = Path(run_dir) / name / "log_trainer.jsonl"
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    return ({r["step"]: (r["loss/total"], r["grad_norm"]) for r in recs
             if "loss/total" in r}, t.saver.saved_steps(), dict(C.BYTES))


LM_RUNS = {"ep": dict(n_expert=2), "fsdp": dict(n_expert=2, fsdp=True),
           "fused": dict(n_expert=2, moe_impl="fused"),
           "dp": dict(n_expert=1, fsdp=True)}


def world4_runs(state_path, tmp):
    """The 4-rank scenarios of tests/test_torch_port_parallel_train.py, in
    one world: the trainer's runs, the task, and the task resumed from the
    single process's step-2 checkpoint (a copy, `w1_at_2`)."""
    out = {name: lm_steps(state_path, **kw) for name, kw in LM_RUNS.items()}
    out["task"] = task_run(tmp, "w4", ["-n_expert_shards", "2"])
    out["task_restored"] = task_run(
        tmp, "w4r", ["-n_expert_shards", "2"], steps=1,
        restore_from=f"{tmp}/w1_at_2/model-2")
    return out


# ---------------------------------------------------------------------------
# cli/train_mm
# ---------------------------------------------------------------------------

MM_HF = dict(vocab_size=512, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=2, mm_hidden_size=16,
             vision_config=dict(hidden_size=16, intermediate_size=32,
                                num_hidden_layers=2, num_attention_heads=2,
                                image_size=28, patch_size=14))
MM_FLAGS = ["--stage", "sft", "--model-max-length", "48",
            "--per-device-batch-size", "2", "--grad-accum", "2",
            "--rate-flip", "0.5", "--learning-rate", "1e-3",
            "--log-interval", "1", "--save-interval", "0",
            "--num-train-steps", "3", "--warmup-ratio", "0.0"]


def mm_train(out_dir, flags=(), dtype=torch.float32, device="cpu"):
    """`cli.train_mm.train` of a tiny CompeteSMoE LLaVA (the 5.1B's
    routers at MM_HF's sizes, weights from seed 0) on seeded
    conversations, over this world (with `--eval-interval`, the same
    conversations as the eval set): the per-step metrics, the bytes each
    collective sent from this rank, and rank 0's logged eval losses."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from competesmoe_tpu_torch.cli.train_mm import build_argparser, train
    from competesmoe_tpu_torch.models.builder import (HF_5P1B, build_llava,
                                                      llava_config_from_hf)
    cfg = llava_config_from_hf(dict(HF_5P1B, **MM_HF), "llava_phi", dtype)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    model = build_llava(cfg, seed=0, device=dev)
    tok = cs.ChatTok(512)
    data = cs.MMConversations(tok, 16, (3, 8), 28, seed=7, max_len=48)
    a = build_argparser().parse_args(MM_FLAGS + list(flags)
                                     + ["--output-dir", str(out_dir)])
    rows = []

    def on_step(step, state, metrics, seconds):
        rows.append({k: (v.tolist() if v.numel() > 1 else float(v))
                     for k, v in metrics.items()})
    from competesmoe_tpu_torch.parallel import collectives as C
    C.reset_bytes()
    train(a, model, data, tok, eval_dataset=data, on_step=on_step,
          final_save=False)
    log = Path(out_dir) / "log_trainer.jsonl"
    evals = ([json.loads(x)["eval/loss"] for x in log.read_text()
              .splitlines() if "eval/loss" in x] if rank() == 0 else None)
    return rows, dict(C.BYTES), evals


MM_LORA_FLAGS = ["--lora-enable", "--lora-r", "4", "--lora-alpha", "8",
                 "--eval-interval", "1", "--eval-batches", "2"]


def mm_world2(tmp):
    return (mm_train(f"{tmp}/sft", ["--n-expert", "2"]),
            mm_train(f"{tmp}/lora", ["--n-expert", "2", *MM_LORA_FLAGS]))


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_port_gpu.py): ranks sharing one card
# ---------------------------------------------------------------------------

def ep_k1_inputs():
    """The expert-parallel dispatch at shapes K1 takes (d and ES 128)."""
    return kv_inputs(21, T=256, d=128, E=8, es=128, k=2)


def ep_k1_scenario():
    """This rank's rows through the expert-parallel dispatch on the card
    (bf16 tokens, 2 expert shards; the local compute is K1), the
    gradient of sum(out^2) w.r.t. the tokens, and the launches of K1 and
    its backward kernels."""
    from competesmoe_tpu_torch.ops import gmm_fused as G
    from competesmoe_tpu_torch.parallel import expert_parallel as EP
    from competesmoe_tpu_torch.parallel.mesh import make_mesh, local_rows
    mesh = make_mesh(n_expert=2)
    ax = mesh.axis("expert")
    d = ep_k1_inputs()
    rows = local_rows(d["x"].shape[0], mesh)
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(d["x"][rows]).to(dev, torch.bfloat16)
    x.requires_grad_()
    banks = [_shard(torch.from_numpy(d[n]), ax).to(dev)
             for n in ("keys", "values")]
    before = [f.launches for f in (G.gmm2_fused_aligned, G.gmm2_bwd_dx,
                                   G.gmm2_bwd_dw)]
    out = EP.make_ep_ffn_kv(mesh, torch.relu)(
        x, torch.from_numpy(d["sel"][rows]).to(dev).long(),
        torch.from_numpy(d["w"][rows]).to(dev, torch.bfloat16), *banks)
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = [f.launches - b for f, b in zip(
        (G.gmm2_fused_aligned, G.gmm2_bwd_dx, G.gmm2_bwd_dw), before)]
    return rows, out.float().cpu(), x.grad.float().cpu(), launches
