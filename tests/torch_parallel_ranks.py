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
             steps=3, n_seq=1, cfg_kw=None):
    """`steps` train steps of the tiny CompeteSMoE LM (JAX's EP test's
    model) from the weights at `state_path`, over a mesh of this world
    with `n_expert` ranks on the expert axis (and `n_seq` on a 'seq'
    axis): each step's metrics, the full parameters after the last, and
    the bytes each collective sent from this rank over the steps."""
    from competesmoe_tpu_torch.models import lm as tlm
    from competesmoe_tpu_torch.moe import schedule as tsched
    from competesmoe_tpu_torch.parallel.ep_context import use_expert_parallel
    from competesmoe_tpu_torch.parallel.mesh import (full_state_dict,
                                                     make_mesh, put_batch,
                                                     shard_params)
    from competesmoe_tpu_torch.train import lm_trainer as T
    import contextlib
    import dataclasses
    cfg = dataclasses.replace(lm_config(moe_impl), **(cfg_kw or {}))
    sched = tsched.build_flip_schedule(cfg.n_layers, total_steps=4,
                                       warm_up=0.0, rate_flip=1.0,
                                       max_compete_in_iter=2, seed=0)
    model = tlm.MoELanguageModel(cfg, flip_schedule=sched, device="cpu")
    model.load_state_dict(torch.load(state_path))
    mesh = make_mesh(n_expert=n_expert, n_seq=n_seq)
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


# ---------------------------------------------------------------------------
# ring attention and sequence parallelism (tests/test_torch_port_ring.py)
# ---------------------------------------------------------------------------

def ring_inputs(seed, form="plain", B=2, T=16, h=3, p=8):
    """q, k, v [B, T, h, p] and per-token validity and positions: `padded`
    right-pads each row (positions count the valid tokens, as the image
    splice makes them), `fuzz` draws both at random with a row whose
    every key is masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, h, p)).astype(np.float32)
               for _ in range(3))
    valid = np.ones((B, T), bool)
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    if form == "padded":
        valid[0, T - 5:] = False
        valid[1, T // 2 + 1:] = False
        pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0)
    elif form == "fuzz":
        valid = rng.random((B, T)) > 0.3
        valid[0, :] = False
        valid[1, 0] = True
        pos = rng.integers(0, T, (B, T))
    return dict(q=q, k=k, v=v, valid=valid, pos=pos.astype(np.int32))


def _seq_meshes():
    """A 4-rank world's seq axes: 4 ranks, and 2 (a ('data', 'seq') mesh
    of 2 x 2 whose data rows repeat the same blocks)."""
    from competesmoe_tpu_torch.parallel.mesh import Mesh
    return {4: Mesh(("seq",), (4,)), 2: Mesh(("data", "seq"), (2, 2))}


def ring_scenarios():
    """This rank's block of the ring and of the masked ring over seq axes
    of 4 and 2 (f32, causal and not; padded and random validity), and
    bf16 with the gradients of sum(out^2) over 4: {key: tensors}."""
    from competesmoe_tpu_torch.parallel.mesh import seq_block
    from competesmoe_tpu_torch.parallel.ring_attention import (
        make_ring_attention, make_ring_attention_masked)
    out = {}
    meshes = _seq_meshes()
    for n, mesh in meshes.items():
        def blk(a):
            return seq_block(torch.from_numpy(np.asarray(a)), mesh)
        for causal in (True, False):
            d = ring_inputs(n)
            out[("ring", n, causal)] = make_ring_attention(
                mesh, causal=causal)(blk(d["q"]), blk(d["k"]), blk(d["v"]))
        for form in ("padded", "fuzz"):
            d = ring_inputs(10 + n, form)
            out[("masked", n, form)] = make_ring_attention_masked(mesh)(
                blk(d["q"]), blk(d["k"]), blk(d["v"]), blk(d["pos"]),
                blk(d["pos"]), blk(d["valid"]))
    mesh = meshes[4]
    d = ring_inputs(7, B=1, T=16, h=2, p=8)
    q, k, v = (seq_block(torch.from_numpy(d[n]), mesh).to(torch.bfloat16)
               .requires_grad_() for n in ("q", "k", "v"))
    o = make_ring_attention(mesh)(q, k, v)
    (o.float() ** 2).sum().backward()
    out[("bf16",)] = (o.dtype, o.float().detach(), q.grad.float(),
                      k.grad.float(), v.grad.float())
    return out


LM_SEQ_SCHEDULE = dict(total_steps=10, warm_up=0.0, rate_flip=1.0,
                       max_compete_in_iter=2, seed=0)


def lm_seq_grads(state_path, cfg, windows, n_seq, expert_shards=1):
    """JAX's test_lm_train_step_with_sequence_parallel step on this world
    (rows over 'data' x 'expert', the sequence over `n_seq` ranks): the
    loss CE + aux at step 1 of each window [B, T+1] in turn (a window
    after the first carries the previous one's state when the config has
    n_prev_states), as the ranks' sum of their shares; the gradients of
    the last window, summed over the ranks; and this rank's carried state
    blocks."""
    import contextlib

    from competesmoe_tpu_torch.models import lm as tlm
    from competesmoe_tpu_torch.moe import schedule as tsched
    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel import distributed_ops
    from competesmoe_tpu_torch.parallel.ep_context import use_expert_parallel
    from competesmoe_tpu_torch.parallel.mesh import (
        gather_full, make_mesh, named_params, placements, put_batch,
        reduce_gradients, seq_block, shard_params)
    from competesmoe_tpu_torch.parallel.seq_context import (
        use_sequence_parallel)
    sched = tsched.build_flip_schedule(cfg.n_layers, **LM_SEQ_SCHEDULE)
    model = tlm.MoELanguageModel(cfg, flip_schedule=sched, device="cpu")
    model.load_state_dict(torch.load(state_path))
    mesh = make_mesh(n_expert=expert_shards, n_seq=n_seq)
    ep = expert_shards > 1
    shard_params(model, mesh, ep=ep)
    world = mesh.axis("world")
    seq = mesh.axis("seq") if n_seq > 1 else None
    state, losses = None, []
    for w in windows:
        toks = torch.from_numpy(put_batch(np.asarray(w), mesh)).long()
        for p in model.parameters():
            p.grad = None
        # the backward's recompute of the competition step runs under the
        # forward's contexts too
        with distributed_ops.use_batch_axis(world, tokens=seq), \
                (use_sequence_parallel(mesh) if seq is not None
                 else contextlib.nullcontext()), \
                (use_expert_parallel(mesh) if ep
                 else contextlib.nullcontext()):
            logits, aux = model(seq_block(toks[:, :-1], mesh), step=1,
                                train=True, state=state)
            ce, n = tlm.lm_loss_fn(logits, seq_block(toks[:, 1:], mesh))
            n_all = C.raw_all_reduce(n, world)
            share = ce * n / n_all + aux["total_aux_loss"] / world.size
            share.backward()
        losses.append(float(C.raw_all_reduce(share.detach(), world)))
        state = aux.get("state")
    grads = {k: p.grad.clone() for k, p in named_params(model).items()}
    reduce_gradients(model, mesh, grads)
    place = placements(model)
    grads = {k: gather_full(g, place.get(k)) for k, g in grads.items()}
    return losses, grads, state


def llava_seq_grads(state_path, cfg, batch, n_seq):
    """JAX's test_llava_mm_loss_with_sequence_parallel step on this world
    (rows over 'data', the spliced sequence over `n_seq` ranks): the loss
    (the ranks' sum of their shares: CE over the global label count, aux
    over the world) and the gradients summed over the ranks."""
    from competesmoe_tpu_torch.models import llava as tllava
    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel import distributed_ops
    from competesmoe_tpu_torch.parallel.mesh import (
        make_mesh, named_params, put_batch, reduce_gradients, shard_params)
    from competesmoe_tpu_torch.parallel.seq_context import (
        use_sequence_parallel)
    model = tllava.LlavaModel(cfg, device="cpu")
    model.load_state_dict(torch.load(state_path))
    mesh = make_mesh(n_seq=n_seq)
    shard_params(model, mesh)
    world = mesh.axis("world")
    b = {k: torch.from_numpy(v) for k, v in put_batch(batch, mesh).items()}
    with distributed_ops.use_batch_axis(world, tokens=mesh.axis("seq")), \
            use_sequence_parallel(mesh):
        out = model(b["input_ids"].long(), b["images"],
                    labels=b["labels"].long(),
                    attention_mask=b["attention_mask"], train=True, step=1)
        n_all = C.raw_all_reduce(out.n_tokens, world)
        share = (out.ce * out.n_tokens / n_all
                 + (out.loss - out.ce) / world.size)
        share.backward()
    grads = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for k, p in named_params(model).items()}
    reduce_gradients(model, mesh, grads)
    return float(C.raw_all_reduce(share.detach(), world)), grads


DECODER_SEQ_CASES = {
    # JAX's masked ring takes none of these: the gathered path does
    "gqa": dict(num_key_value_heads=2),
    "window": dict(sliding_window=5),
    "alibi": dict(use_alibi=True),
}


def decoder_seq_inputs():
    """ids [4, 16], a right-padded row and positions that count the
    valid tokens (the image splice's form)."""
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 64, (4, 16))
    mask = np.ones((4, 16), np.int64)
    mask[1, 11:] = 0
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    return ids, mask, pos


def decoder_seq_logits(state_path, name, n_seq=0):
    """The tiny decoder of case `name` without a cache: its logits over
    this rank's rows and sequence block under a seq axis of `n_seq`
    ranks (0: one process, all of them)."""
    import contextlib

    from competesmoe_tpu_torch.models.decoder import DecoderLM
    from competesmoe_tpu_torch.parallel.mesh import (make_mesh, put_batch,
                                                     seq_block)
    from competesmoe_tpu_torch.parallel.seq_context import (
        use_sequence_parallel)
    model = DecoderLM(tp_decoder_cfg(**DECODER_SEQ_CASES[name]),
                      device="cpu")
    model.load_state_dict(torch.load(state_path))
    mesh = make_mesh(n_seq=n_seq) if n_seq else None
    ids, mask, pos = (torch.from_numpy(put_batch(a, mesh) if mesh else a)
                      for a in decoder_seq_inputs())
    scope = (use_sequence_parallel(mesh) if mesh
             else contextlib.nullcontext())
    with torch.no_grad(), scope:
        logits, _, _ = model(seq_block(ids, mesh),
                             attention_mask=seq_block(mask, mesh),
                             position_ids=seq_block(pos, mesh))
    return logits


def lm_task_seq(run_dir, name, flags=()):
    """The LM task with -n_seq_shards over this world (rank 0's logged
    losses by step)."""
    return task_run(run_dir, name, flags)


def seq_world4(tmp, lm_state, lm_cfg, windows, xl_state, xl_cfg,
               xl_windows, llava_state, llava_cfg, llava_batch, moa_state,
               moa_cfg, dec_states):
    """The 4-rank scenarios of tests/test_torch_port_ring.py, in one
    world."""
    return dict(
        ring=ring_scenarios(),
        lm4=lm_seq_grads(lm_state, lm_cfg, windows, 4),
        lm22=lm_seq_grads(lm_state, lm_cfg, windows, 2, expert_shards=2),
        xl=lm_seq_grads(xl_state, xl_cfg, xl_windows, 2),
        moa=lm_seq_grads(moa_state, moa_cfg, windows, 2),
        decoder={name: decoder_seq_logits(path, name, 2)
                 for name, path in dec_states.items()},
        llava=llava_seq_grads(llava_state, llava_cfg, llava_batch, 2),
        task=lm_task_seq(tmp, "seq", ["-n_seq_shards", "2",
                                      "-n_expert_shards", "2"]))


# ---------------------------------------------------------------------------
# tensor- and expert-parallel serving (tests/test_torch_port_tp_serving.py)
# ---------------------------------------------------------------------------

def tp_decoder_cfg(**kw):
    """tests/test_tp_decode.py's tiny decoder (float32), in the port."""
    from competesmoe_tpu_torch.models.decoder import DecoderConfig
    base = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=128,
                original_max_position_embeddings=128, fused_qkv=True,
                dtype=torch.float32)
    base.update(kw)
    return DecoderConfig(**base)


def greedy_decode(model, ids, kvlen=32, n=4, rows=None):
    """Prefill then n greedy steps (JAX's tests' loop): the tokens
    [n + 1, B] and each call's logits; `rows`: the axis whose ranks split
    the cache's rows."""
    ids = torch.from_numpy(np.asarray(ids)).long()
    cache = model.new_cache(ids.shape[0], kvlen, "cpu", rows=rows)
    with torch.no_grad():
        logits, cache, _ = model(ids, cache=cache)
        tok = logits[:, -1].argmax(-1)
        toks, lgs = [tok], [logits[:, -1]]
        for _ in range(n):
            logits, cache, _ = model(tok[:, None], cache=cache)
            tok = logits[:, 0].argmax(-1)
            toks.append(tok)
            lgs.append(logits[:, 0])
    return torch.stack(toks), torch.stack(lgs), cache


def tp_decode_case(state_path, cfg_kw, bits=None, n_model=0, B=4, T=8):
    """The tiny decoder from `state_path` (quantized to `bits` first, as
    --load-8bit / --load-4bit do), tensor parallel over `n_model` ranks
    of this world (0: one process): greedy tokens, logits, and what the
    placement did (layer 0's heads, the cache's KV heads, the lm_head's
    rows)."""
    from competesmoe_tpu_torch.models import builder as tbuilder
    from competesmoe_tpu_torch.models.decoder import DecoderLM
    from competesmoe_tpu_torch.parallel.mesh import make_tp_mesh
    from competesmoe_tpu_torch.parallel.tensor_parallel import shard_decoder
    model = DecoderLM(tp_decoder_cfg(**cfg_kw), device="cpu")
    model.load_state_dict(torch.load(state_path))
    if bits:
        tbuilder.quantize_decoder_to_int8(model, bits=bits)
    rows = None
    if n_model:
        mesh = make_tp_mesh(n_model)
        shard_decoder(model, mesh)
        # the cache's rows over 'data', as JAX's kv_cache_sharding
        rows = mesh.axis("data")
    ids = np.random.default_rng(0).integers(1, 64, (B, T))
    toks, logits, cache = greedy_decode(model, ids, rows=rows)
    attn = model.layers[0].self_attn
    head = getattr(model, "lm_head", None)
    return dict(tokens=toks, logits=logits,
                heads=(attn.n_heads, attn.n_kv_heads),
                cache_heads=cache.k.shape[3], cache_rows=cache.k.shape[1],
                head_rows=None if head is None or not hasattr(
                    head, "weight") else head.weight.shape[0])


def ep_decoder_cfg(moe_name):
    """tests/test_ep_decode.py's MoE decoder (8 experts, 2 selected)."""
    return tp_decoder_cfg(moe_name=moe_name, num_experts=8, num_selected=2)


def ep_decode_case(state_path, moe_name, n_expert=0):
    """The MoE decoder's greedy decode (B 8, T 8) with its expert banks
    sharded over `n_expert` ranks and the tokens dispatched by
    all-to-all (0: one process): tokens, logits, the bytes the
    all-to-all sent and the bank rows this rank holds."""
    import contextlib

    from competesmoe_tpu_torch.models.decoder import DecoderLM
    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel.ep_context import use_expert_parallel
    from competesmoe_tpu_torch.parallel.mesh import make_mesh
    from competesmoe_tpu_torch.parallel.mesh import ep_param_shardings
    from competesmoe_tpu_torch.parallel.tensor_parallel import (
        apply_shardings)
    model = DecoderLM(ep_decoder_cfg(moe_name), device="cpu")
    model.load_state_dict(torch.load(state_path))
    scope = contextlib.nullcontext()
    if n_expert:
        mesh = make_mesh(n_expert=n_expert)
        apply_shardings(model, ep_param_shardings(mesh, model), mesh)
        scope = use_expert_parallel(mesh, replicated_tokens=True)
    C.reset_bytes()
    ids = np.random.default_rng(0).integers(1, 64, (8, 8))
    with scope:
        toks, logits, _ = greedy_decode(model, ids)
    bank = model.layers[0].moe
    bank = getattr(bank, "experts_w1", None)
    return dict(tokens=toks, logits=logits, a2a=C.BYTES["all_to_all"],
                bank_rows=None if bank is None else bank.shape[0])


def ep_tower_case(state_path, cfg, n_expert=0):
    """JAX's test_ep_prefill_llava_vision_tower: a small LLaVA whose tower
    and projector are MoE, generate 4 tokens for 2 image prompts with
    their banks sharded over `n_expert` ranks (0: one process)."""
    from competesmoe_tpu_torch.models import llava as tllava
    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel.ep_context import set_ep_mesh
    from competesmoe_tpu_torch.parallel.mesh import make_mesh
    from competesmoe_tpu_torch.parallel.tensor_parallel import shard_llava_ep
    model = tllava.LlavaModel(cfg, device="cpu")
    model.load_state_dict(torch.load(state_path))
    if n_expert:
        shard_llava_ep(model, make_mesh(n_expert=n_expert))
    ids, px = tower_prompts()
    C.reset_bytes()
    try:
        toks, _ = tllava.generate(model, ids, px, max_new_tokens=4)
    finally:
        set_ep_mesh(None)
    return np.asarray(toks), C.BYTES["all_to_all"]


def tower_prompts():
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 64, (2, 6)).astype(np.int32)
    ids[:, 1] = -200
    px = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    return ids, px


def serving_llava(quant=None):
    """A small LLaVA with MoE tower and projector (random weights from a
    seed, float32), --load-8bit / --load-4bit applied by `quant`."""
    from competesmoe_tpu_torch.models import builder as tbuilder
    from competesmoe_tpu_torch.models.decoder import DecoderConfig
    from competesmoe_tpu_torch.models.llava import LlavaConfig
    from competesmoe_tpu_torch.models.projector import ProjectorConfig
    from competesmoe_tpu_torch.models.vision import VisionConfig
    vis = VisionConfig(hidden_size=16, intermediate_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       image_size=28, patch_size=14, moe_name="smoe",
                       num_experts=4, num_selected=2)
    proj = ProjectorConfig(projector_type="moe", mm_hidden_size=16,
                           hidden_size=64, moe_name="smoe", num_experts=4,
                           num_selected=2)
    dec = DecoderConfig(vocab_size=128, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4,
                        fused_qkv=True, max_position_embeddings=256,
                        original_max_position_embeddings=256,
                        dtype=torch.float32)
    cfg = LlavaConfig(vision=vis, projector=proj, decoder=dec,
                      tokenizer_model_max_length=None)
    model = tbuilder.build_llava(cfg, seed=0, device="cpu")
    if quant == "int8":
        tbuilder.apply_load_8bit(model)
    elif quant == "int4":
        tbuilder.apply_load_4bit(model)
    return model


def engine_requests():
    """Three prompts, the second with an image."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        ids = rng.integers(1, 120, 10 + i).astype(np.int32)
        px = None
        if i == 1:
            ids[2] = -200
            px = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
        out.append((ids, px))
    return out


def engine_tokens(mode=None, n=2, quant=None, spec_k=2, features=False):
    """Three concurrent requests (greedy, 6 tokens) through a DecodeEngine
    of 4 slots over the small LLaVA: one process (mode None), tensor
    parallel over a DxM mesh (mode 'tp', n = M) or expert parallel (mode
    'ep', n expert shards). `features`: with 2 parked rows and prefill
    chunks of 8 (the text prompts prefill in chunks), and a second turn
    of each conversation after the first (its parked row unparked).
    Rank 0's tokens; the other ranks follow."""
    import threading

    from competesmoe_tpu_torch.parallel import tensor_parallel as tp
    from competesmoe_tpu_torch.parallel.ep_context import set_ep_mesh
    from competesmoe_tpu_torch.parallel.mesh import make_mesh, make_tp_mesh
    from competesmoe_tpu_torch.serve.engine import DecodeEngine
    model = serving_llava(quant)
    mesh = None
    if mode == "tp":
        mesh = make_tp_mesh(n)
        tp.shard_llava(model, mesh)
    elif mode == "ep":
        mesh = make_mesh(n_expert=n)
        tp.shard_llava_ep(model, mesh)
    more = dict(prefix_cache_slots=2, prefill_chunk=8) if features else {}
    eng = DecodeEngine(model, n_slots=4, max_len=96, mesh=mesh, spec_k=spec_k,
                       **more)
    try:
        if mesh is not None and mesh.rank != 0:
            eng.follow()
            return None
        reqs = engine_requests()

        def run(reqs):
            res = [None] * len(reqs)

            def go(i):
                res[i] = list(eng.submit(reqs[i][0],
                                         pixel_values=reqs[i][1],
                                         max_new_tokens=6))
            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(len(reqs))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return res
        res = run(reqs)
        if features:
            # second turns: each text conversation continued
            follow = [(np.concatenate([ids, np.asarray(out[:-1], np.int32),
                                       np.arange(5, 9, dtype=np.int32)]),
                       None) for (ids, px), out in zip(reqs, res)
                      if px is None]
            res = res + run(follow)
            res.append(eng.stats()["engine_prefix_cache_hits"])
        eng.shutdown()
        if eng.error is not None:
            raise eng.error
        return res
    finally:
        set_ep_mesh(None)


class WordTok:
    """Word-level stand-in tokenizer: ids assigned on first sight from 3;
    eos 2."""

    bos_token_id = None
    eos_token_id = 2

    def __init__(self, vocab_size: int = 128):
        self.vocab_size = vocab_size
        self.vocab, self.inv = {}, {}

    def __call__(self, text):
        ids = []
        for w in text.split():
            if w not in self.vocab:
                i = 3 + len(self.vocab) % (self.vocab_size - 3)
                self.vocab[w] = i
                self.inv[i] = w
            ids.append(self.vocab[w])
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.inv.get(int(i), f"<{int(i)}>") for i in ids
                        if not (skip_special_tokens and int(i) < 3))


WORKER_PROMPTS = ("what color is the cat", "describe the image please",
                  "hello there how are you")


def worker_texts(flags=()):
    """The model worker (`build_serving`, the flags of its CLI over the
    small LLaVA) serving three requests over HTTP from rank 0; the other
    ranks follow. Rank 0's streamed texts."""
    import json
    import socket
    from urllib import request as urlrequest

    from competesmoe_tpu_torch.parallel.ep_context import set_ep_mesh
    from competesmoe_tpu_torch.serve import model_worker as W
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    a = W.parse_args(["--device", "cpu", "--no-register", "--tokenizer",
                      "unused", "--max-new-tokens", "6", *flags])
    served = W.build_serving(a, model=serving_llava(), tokenizer=WordTok(),
                             model_name="small")
    try:
        if not served.lead:
            served.follow()
            return None
        httpd = W.serve_worker(served.worker, "127.0.0.1", port,
                               background=True)
        texts = []
        try:
            for prompt in WORKER_PROMPTS:
                req = urlrequest.Request(
                    f"http://127.0.0.1:{port}/worker_generate_stream",
                    data=json.dumps({"prompt": prompt,
                                     "max_new_tokens": 6}).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"})
                with urlrequest.urlopen(req, timeout=120) as r:
                    chunks = [json.loads(p) for p in r.read().split(b"\0")
                              if p]
                assert all(c["error_code"] == 0 for c in chunks), chunks
                texts.append(chunks[-1]["text"])
        finally:
            httpd.shutdown()
            httpd.server_close()
            served.close()
        return texts
    finally:
        set_ep_mesh(None)


def eval_cli_rows(ckpt_dir, tok_dir, out_json, flags=()):
    """cli/eval_mm over the port's checkpoint on this world: rank 0's
    results (the followers' run returns no results)."""
    from competesmoe_tpu_torch.cli.eval_mm import main
    return main(["--model-dir", str(ckpt_dir), "--tokenizer", str(tok_dir),
                 "--tasks", "cli_port_gen", "--device", "cpu",
                 "--output-path", str(out_json), *flags])


def tp_world2(tmp, state_paths, tower_state, tower_cfg):
    """The 2-rank scenarios of tests/test_torch_port_tp_serving.py."""
    out = {"tp": {name: tp_decode_case(path, kw, bits, n_model=2)
                  for name, (path, kw, bits) in state_paths.items()
                  if not name.startswith("ep_")},
           "ep": {name: ep_decode_case(path, kw, n_expert=2)
                  for name, (path, kw, _) in state_paths.items()
                  if name.startswith("ep_")},
           "tower": ep_tower_case(tower_state, tower_cfg, n_expert=2)}
    out["engine_tp"] = engine_tokens("tp", 2)
    out["engine_tp_int4"] = engine_tokens("tp", 2, quant="int4", spec_k=0)
    out["engine_ep"] = engine_tokens("ep", 2)
    out["worker_tp"] = worker_texts(["--mesh", "1x2", "--engine-slots", "4"])
    out["worker_ep"] = worker_texts(["--ep-shards", "2"])
    out["eval"] = eval_results(f"{tmp}/eval_tp.json", ["--mesh", "1x2"])
    return out


def tp_world4(state_paths):
    """The 4-rank scenarios: TP decode on 2 x 2, EP decode over 4 expert
    shards, and the TP engine on 2 x 2."""
    return {"tp": {name: tp_decode_case(path, kw, bits, n_model=2)
                   for name, (path, kw, bits) in state_paths.items()
                   if not name.startswith("ep_")},
            "ep": {name: ep_decode_case(path, kw, n_expert=4)
                   for name, (path, kw, _) in state_paths.items()
                   if name.startswith("ep_")},
            "engine_tp": engine_tokens("tp", 2),
            "engine_tp_features": engine_tokens("tp", 2, features=True)}


class ArrayImage:
    """A seeded uint8 image as `ImageProcessorConfig.preprocess` reads a
    PIL one (no image package is needed): convert() returns it, resize()
    keeps its own size."""

    def __init__(self, seed: int, size: int = 28):
        rng = np.random.default_rng(seed)
        self.array = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        self.size = (size, size)

    def convert(self, mode):
        return self

    def resize(self, size, resample=None):
        assert tuple(size) == self.size
        return self

    def __array__(self, dtype=None, copy=None):
        return self.array if dtype is None else self.array.astype(dtype)


def eval_tasks():
    """POPE-shaped generate_until and loglikelihood tasks of 5 and 4
    documents (every third without an image)."""
    import dataclasses

    from competesmoe_tpu_torch.eval import register_task
    from competesmoe_tpu_torch.eval import tasks_builtin  # noqa: F401
    from competesmoe_tpu_torch.eval.task import get_task_config
    objects = ("cat", "dog", "red car", "blue kite", "tree")
    docs = [{"question": f"Is there a {objects[i]} in the image?",
             "answer": "yes" if i % 2 else "no", "target": "yes it is",
             "image": None if i % 3 == 1 else ArrayImage(i)}
            for i in range(5)]
    pope = get_task_config("pope")
    register_task("tp_gen", dataclasses.replace(
        pope, task="tp_gen", dataset_path=None, docs=docs,
        generation_kwargs=dict(pope.generation_kwargs, max_new_tokens=3)))
    register_task("tp_ll", dataclasses.replace(
        pope, task="tp_ll", dataset_path=None, docs=docs[:4],
        output_type="loglikelihood", doc_to_target=lambda d: d["target"],
        generation_kwargs={}, filter_list=[],
        metric_list=[{"metric": "accuracy", "aggregation": "mean"}]))
    return "tp_gen,tp_ll"


def eval_results(out_json, flags=()):
    """cli/eval_mm's run over the small LLaVA (both tasks, batch 2): rank
    0's per-task metrics and each document's responses; None on the other
    ranks, which follow."""
    from competesmoe_tpu_torch.cli import eval_mm
    a = eval_mm.parse_args(["--tasks", eval_tasks(), "--device", "cpu",
                            "--batch-size", "2", "--max-new-tokens", "3",
                            "--output-path", str(out_json), *flags])
    res = eval_mm.run(a, model=serving_llava(), tokenizer=WordTok())
    if not res:
        return None
    r = res[0]
    return ({t: {k: v for k, v in m.items() if k != "alias"}
             for t, m in r["results"].items()},
            {t: [s["resps"] for s in rows]
             for t, rows in r.get("samples", {}).items()})


# ---------------------------------------------------------------------------
# on the card: tensor parallelism and the ring over ranks sharing it
# ---------------------------------------------------------------------------

def card_tp_cfg():
    """A bf16 decoder whose tensor-parallel shards K3 takes (d 256, 4
    heads of 64, ffn 512: per rank qkv 256 -> 384, o 128 -> 256,
    gate_up 256 -> 512, down 256 -> 256)."""
    return tp_decoder_cfg(vocab_size=512, hidden_size=256,
                          intermediate_size=512, dtype=torch.bfloat16,
                          matvec_kernel=True)


def card_tp_state():
    from competesmoe_tpu_torch.models.decoder import DecoderLM
    g = torch.Generator().manual_seed(0)
    model = DecoderLM(card_tp_cfg(), device="cpu")
    return {k: (torch.randn(v.shape, generator=g) * 0.05).to(v.dtype)
            for k, v in model.state_dict().items()}


def card_tp_decode(n_model=0):
    """The decoder of `card_tp_cfg` on the card, tensor parallel over
    `n_model` ranks sharing it (0: one process): greedy tokens (B 2, 8
    prompt tokens, 6 steps) and K3's launches."""
    from competesmoe_tpu_torch.models.decoder import DecoderLM
    from competesmoe_tpu_torch.ops import matvec
    from competesmoe_tpu_torch.parallel.mesh import make_tp_mesh
    from competesmoe_tpu_torch.parallel.tensor_parallel import shard_decoder
    dev = torch.device("cuda", 0)
    model = DecoderLM(card_tp_cfg(), device=dev)
    model.load_state_dict(card_tp_state())
    if n_model:
        shard_decoder(model, make_tp_mesh(n_model))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, 512, (2, 8))).to(dev)
    before = matvec.small_m_matmul.launches
    cache = model.new_cache(2, 32, dev)
    with torch.no_grad():
        logits, cache, _ = model(ids, cache=cache)
        tok = logits[:, -1].argmax(-1)
        toks = [tok]
        for _ in range(6):
            logits, cache, _ = model(tok[:, None], cache=cache)
            tok = logits[:, 0].argmax(-1)
            toks.append(tok)
    torch.cuda.synchronize()
    return (torch.stack(toks).cpu(), matvec.small_m_matmul.launches - before)


def card_ring():
    """Ring attention over 2 ranks sharing the card (bf16, causal): this
    rank's block of the output and of dq for sum(out^2)."""
    from competesmoe_tpu_torch.parallel.mesh import Mesh, seq_block
    from competesmoe_tpu_torch.parallel.ring_attention import (
        make_ring_attention)
    mesh = Mesh(("seq",), (2,))
    d = ring_inputs(3, B=2, T=256, h=4, p=64)
    q, k, v = (seq_block(torch.from_numpy(d[n]), mesh).to(
        "cuda", torch.bfloat16).requires_grad_() for n in ("q", "k", "v"))
    out = make_ring_attention(mesh)(q, k, v)
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    return out.float().cpu().detach(), q.grad.float().cpu()
