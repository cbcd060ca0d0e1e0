"""Evaluation loop.

Re-design of `evaluate/lmms_eval/evaluator.py:34-658`: `simple_evaluate`
(seeds, task build, `return_id_experts` threading) -> `evaluate` (request
building with rank/world splitting, grouped dispatch by request type,
filter pipeline, aggregation, table print).

The port's own copy of competesmoe_tpu/eval/evaluator.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional

import numpy as np

from .task import ConfigurableTask, get_task_config


def simple_evaluate(lm, tasks: List[str], limit: Optional[int] = None,
                    rank: int = 0, world_size: int = 1,
                    return_id_experts: bool = False,
                    seed: int = 0, merge_dir=None) -> Dict[str, Any]:
    """merge_dir: with world_size > 1, a shared directory through which
    rank shards merge — rank 0 returns GLOBAL metrics over every rank's
    samples (see merge_rank_results); without it each rank reports its
    own slice."""
    random.seed(seed)
    np.random.seed(seed)
    task_objs = {name: ConfigurableTask(get_task_config(name), limit=limit)
                 for name in tasks}
    results = evaluate(lm, task_objs, rank=rank, world_size=world_size,
                       return_id_experts=return_id_experts)
    # eval-side timing channel (the reference's `time_inference` log,
    # models/llava.py:492)
    times = getattr(lm, "time_inference", None)
    if times:
        results["time_inference"] = {
            "total_s": float(sum(times)), "n_batches": len(times),
            "mean_s": float(sum(times) / len(times))}
    if world_size > 1 and merge_dir is not None:
        results = merge_rank_results(task_objs, results, rank,
                                     world_size, merge_dir)
    return results


def _rank_request_count(n_docs: int, rank: int, world_size: int) -> int:
    """How many docs land on `rank` under doc_id % world_size slicing."""
    return n_docs // world_size + (1 if rank < n_docs % world_size else 0)


def pad_uneven_ranks(task: ConfigurableTask, insts: list, rank: int,
                     world_size: int) -> list:
    """Pseudobatch padding (reference evaluator.py:276-296): when ranks
    receive uneven request counts, clone this rank's last request (marked
    `padded=True`, excluded from scoring) until every rank runs the same
    number — so multi-host collective inference never deadlocks. Our
    round-robin doc split makes every rank's count computable locally,
    so no gather is needed to agree on the target count."""
    import dataclasses as _dc

    n_docs = len(task.docs)
    max_count = max(_rank_request_count(n_docs, r, world_size)
                    for r in range(world_size))
    pads = []
    while insts and len(insts) + len(pads) < max_count:
        src = insts[-1]
        pads.append(_dc.replace(src, resps=[], filtered_resps={},
                                padded=True))
    return pads


def evaluate(lm, task_objs: Dict[str, ConfigurableTask], rank: int = 0,
             world_size: int = 1,
             return_id_experts: bool = False,
             bootstrap_iters: int = 1000) -> Dict[str, Any]:
    from .metrics import bootstrap_stderr, pooled_stderr

    # 1. build requests per task, rank-sliced, padded so every rank runs
    #    the same number (evaluator.py:257-296)
    requests_by_type: Dict[str, list] = {}
    for name, task in task_objs.items():
        insts = task.build_all_requests(rank=rank, world_size=world_size)
        pads = pad_uneven_ranks(task, insts, rank, world_size)
        task.instances.extend(pads)
        for inst in insts + pads:
            requests_by_type.setdefault(inst.request_type, []).append(inst)

    # 2. grouped dispatch (evaluator.py:300-301)
    for reqtype, reqs in requests_by_type.items():
        fn = getattr(lm, reqtype)
        fn(reqs, return_id_experts=return_id_experts)

    # 3. filters + scoring per task (populates task.sample_scores)
    samples_by_task: Dict[str, list] = {}
    for name, task in task_objs.items():
        task.apply_filters()
        task.score()
        samples = []
        for inst in task.instances:
            if inst.padded:
                continue
            rec = {"doc_id": inst.doc_id,
                   "resps": inst.resps,
                   "filtered": inst.filtered_resps.get("default")}
            if return_id_experts:
                rec["logs_metrics_vision"] = inst.logs_metrics_vision
                rec["logs_metrics_mlp"] = inst.logs_metrics_mlp
            samples.append(rec)
        samples_by_task[name] = samples

    # 4. aggregation (+ bootstrap, groups) over this rank's samples
    return score_and_aggregate(
        task_objs,
        {name: getattr(t, "sample_scores", {})
         for name, t in task_objs.items()},
        samples_by_task, bootstrap_iters)


def score_and_aggregate(task_objs: Dict[str, ConfigurableTask],
                        sample_scores_by_task: Dict[str, Dict[str, list]],
                        samples_by_task: Dict[str, list],
                        bootstrap_iters: int = 1000) -> Dict[str, Any]:
    """Aggregate per-sample scores into the results dict: per-task
    aggregation + bootstrap stderr + size-weighted group rollup. Called
    on a rank's own scores by evaluate(), and on MERGED rank shards by
    merge_rank_results (the reference's accelerate-gather role)."""
    from .metrics import bootstrap_stderr, pooled_stderr

    results: Dict[str, Any] = {"results": {}, "samples": samples_by_task,
                               "groups": {}}
    group_members: Dict[str, list] = {}
    for name, task in task_objs.items():
        per_metric = sample_scores_by_task.get(name, {})
        scores = task.aggregate(per_metric)
        for metric, vals in per_metric.items():
            # corpus-level metrics (e.g. CIDEr) keep raw per-sample items;
            # bootstrap only applies to numeric per-sample scores
            numeric = all(isinstance(v, (int, float)) for v in vals)
            if metric in scores and bootstrap_iters > 0 and numeric:
                scores[f"{metric}_stderr"] = bootstrap_stderr(
                    vals, n_resamples=bootstrap_iters)
        results["results"][name] = scores
        if task.cfg.group:
            group_members.setdefault(task.cfg.group, []).append((name,
                                                                 task))

    # group aggregation: size-weighted mean over member tasks, pooled
    # stderr (reference evaluator.py group handling)
    for group, members in group_members.items():
        agg: Dict[str, Any] = {}
        metrics = set()
        for name, task in members:
            metrics.update(sample_scores_by_task.get(name, {}).keys())
        for metric in metrics:
            vals, errs, sizes = [], [], []
            for name, task in members:
                samples = sample_scores_by_task.get(name, {}).get(metric)
                if not samples:
                    continue
                vals.append(results["results"][name][metric])
                errs.append(results["results"][name].get(
                    f"{metric}_stderr", 0.0))
                sizes.append(len(samples))
            if not vals:
                continue
            total = sum(sizes)
            agg[metric] = sum(v * n for v, n in zip(vals, sizes)) / total
            agg[f"{metric}_stderr"] = pooled_stderr(errs, sizes)
            agg["n_samples"] = total
        results["groups"][group] = agg
    return results


def merge_rank_results(task_objs: Dict[str, ConfigurableTask],
                       results: Dict[str, Any], rank: int,
                       world_size: int, merge_dir,
                       timeout_s: float = 1800.0,
                       bootstrap_iters: int = 1000) -> Dict[str, Any]:
    """File-based cross-rank result merge (the reference gathers sample
    logs with accelerate, evaluator.py + llava_trainer gather role; here
    a shared filesystem replaces the collective so eval processes need
    no torch.distributed process group).

    Every rank atomically writes its per-sample scores + sample records
    to `merge_dir/rank_<r>.json`. Non-zero ranks return their local
    (partial) results flagged `partial_rank`; rank 0 waits for all
    shards and re-aggregates globally — metric means, bootstrap stderr,
    and group rollups are then computed over the FULL sample set, not
    rank 0's slice."""
    import time as _time
    from pathlib import Path

    merge_dir = Path(merge_dir)
    merge_dir.mkdir(parents=True, exist_ok=True)
    shard = {name: {"sample_scores": getattr(t, "sample_scores", {}),
                    "samples": results["samples"].get(name, [])}
             for name, t in task_objs.items()}
    tmp = merge_dir / f"rank_{rank}.json.tmp"
    tmp.write_text(json.dumps(shard, default=str))
    tmp.rename(merge_dir / f"rank_{rank}.json")

    if rank != 0:
        results["partial_rank"] = rank
        return results

    deadline = _time.monotonic() + timeout_s
    paths = [merge_dir / f"rank_{r}.json" for r in range(world_size)]
    while not all(p.exists() for p in paths):
        if _time.monotonic() > deadline:
            missing = [str(p) for p in paths if not p.exists()]
            raise TimeoutError(f"rank shards missing after {timeout_s}s: "
                               f"{missing}")
        _time.sleep(0.5)

    merged_scores: Dict[str, Dict[str, list]] = {}
    merged_samples: Dict[str, list] = {}
    for p in paths:
        data = json.loads(p.read_text())
        for name, rec in data.items():
            ms = merged_scores.setdefault(name, {})
            for metric, vals in rec["sample_scores"].items():
                ms.setdefault(metric, []).extend(vals)
            merged_samples.setdefault(name, []).extend(rec["samples"])
    # guard against stale shards from a previous run in a reused
    # merge_dir: the merged sample count must be exactly the doc count
    for name, task in task_objs.items():
        got, want = len(merged_samples.get(name, [])), len(task.docs)
        if got != want:
            raise RuntimeError(
                f"merged sample count for {name!r} is {got}, expected "
                f"{want} — stale rank shards in {merge_dir}? Use a "
                f"fresh --merge-dir per run")
    for p in paths:  # consumed: a rerun cannot merge this run's shards
        p.unlink()
    out = score_and_aggregate(task_objs, merged_scores, merged_samples,
                              bootstrap_iters)
    out["merged_ranks"] = world_size
    if "time_inference" in results:
        out["time_inference"] = results["time_inference"]
    return out


def make_table(results: Dict[str, Any]) -> str:
    """Plain-text results table (utils.py make_table role); stderr shown
    as +- next to its metric, groups appended below the tasks."""
    lines = [f"{'Task':<24} {'Metric':<16} {'Value':>10} {'Stderr':>9}"]
    lines.append("-" * 62)

    def emit(name, metrics):
        for metric, value in metrics.items():
            if metric.endswith("_stderr") or metric == "n_samples":
                continue
            err = metrics.get(f"{metric}_stderr")
            err_s = f"+-{err:7.4f}" if err is not None else ""
            lines.append(f"{name:<24} {metric:<16} {value:>10.4f} {err_s}")

    for task, metrics in results["results"].items():
        emit(task, metrics)
    for group, metrics in results.get("groups", {}).items():
        emit(f"[group] {group}", metrics)
    return "\n".join(lines)
