"""Evaluation entry point (port of competesmoe_tpu/cli/eval_mm.py; the
`moe-eval` role, evaluate/lmms_eval/__main__.py:39-359).

  python -m competesmoe_tpu_torch.cli.eval_mm --model-dir ckpt/ \
    --tasks pope,mme --limit 100 --output-path results.json \
    --return-id-experts

Runs on `cuda` unless `--device cpu` is given. `run(args, model=...,
tokenizer=...)` is the same loop over a model already loaded.

`--mesh DxM` shards the decoder tensor-parallel over D x M ranks (one
process a rank: `python -m torch.distributed.run --nproc-per-node N -m
competesmoe_tpu_torch.cli.eval_mm --mesh 1xN ...`): rank 0 scores every
document and writes the results, the other ranks make its model calls in
lockstep (`eval.llava_adapter.TorchLlava(mesh=...)`).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--tokenizer", default="",
                    help="HF tokenizer dir (defaults to --model-dir)")
    ap.add_argument("--tasks", default="",
                    help="comma-separated task names")
    ap.add_argument("--task-yaml", nargs="*", default=[],
                    help="reference-style task yaml files to register")
    ap.add_argument("--config", default="",
                    help="yaml with a LIST of eval run configs; each "
                         "entry's keys override these flags (the "
                         "reference __main__.py multi-config loop)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--conv-template", default="phi35")
    ap.add_argument("--output-path", default="")
    ap.add_argument("--log-samples", action="store_true")
    ap.add_argument("--wandb", action="store_true",
                    help="mirror results/samples tables to wandb "
                         "(logging_utils.py role)")
    ap.add_argument("--wandb-project", default="competesmoe_tpu-eval")
    ap.add_argument("--return-id-experts", action="store_true",
                    help="collect per-layer routing telemetry")
    # rank/world default from the scheduler env (SLURM/torchrun — the
    # reference's accelerate-driven rank split, models/llava.py:139-160)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    # quantized inference (reference __main__ passes these through
    # model_args to builder.load_pretrained_model)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--kv-quant", default="", choices=["", "int8"])
    ap.add_argument("--mesh", default="",
                    help="DxM tensor-parallel mesh (e.g. 1x2): shard the "
                         "decoder over M ranks for eval of models larger "
                         "than one card (serve.model_worker shares the "
                         "same path); rank 0 scores the documents")
    ap.add_argument("--speculative", type=int, default=0,
                    help="prompt-lookup speculative decoding for "
                         "batch-1 generation tasks: verify K drafted "
                         "tokens per forward (greedy: the same tokens; "
                         "sampled gen_kwargs: unbiased rejection scheme)")
    ap.add_argument("--engine-slots", type=int, default=0,
                    help="run generation tasks through the continuous-"
                         "batching DecodeEngine with N slots sharing "
                         "one batched decode step (token-exact vs the "
                         "solo path; ignored for --return-id-experts "
                         "runs, which need prefill telemetry)")
    ap.add_argument("--engine-pipeline", type=int, default=1,
                    help="with --engine-slots: pipelined tick dispatch "
                         "depth (decode call N+1 issued before call N "
                         "is read; token-exact). Ignored when "
                         "--speculative is set")
    ap.add_argument("--engine-max-len", type=int, default=0,
                    help="engine KV length (default: the model's "
                         "tokenizer_model_max_length)")
    ap.add_argument("--merge-dir", default="",
                    help="with --world-size > 1: shared directory for "
                         "cross-rank result merging — rank 0 prints "
                         "GLOBAL metrics over all ranks' samples "
                         "(the reference's accelerate gather role)")
    ap.add_argument("--device", default="cuda",
                    help="device the model is loaded on (cuda unless "
                         "asked; no fallback to the CPU)")
    return ap.parse_args(argv)


def register_task_yamls(paths) -> None:
    from ..eval.task import load_task_yaml
    for path in paths:
        p = Path(path)
        if p.is_dir():
            # a reference-style tasks directory: register every yaml that
            # loads (some need deps unavailable offline — skip those)
            n_ok = 0
            for y in sorted(p.rglob("*.yaml")):
                try:
                    load_task_yaml(y)
                    n_ok += 1
                except Exception:
                    pass
            print(f"registered {n_ok} tasks from {p}")
        else:
            load_task_yaml(path)


def run(a: argparse.Namespace, *, model=None, tokenizer=None):
    """Evaluate every run config of `a` (the flags, or each entry of
    --config over them): load the model from --model-dir unless `model`
    is given, take `tokenizer` when given (else the checkpoint's, or
    --tokenizer's through transformers), evaluate --tasks and write the
    results. Returns the results of each run config."""
    import torch

    from .. import eval as harness
    from ..eval import tasks_builtin  # noqa: F401  (register builtin tasks)
    from ..models.builder import load_pretrained_model
    from ..multimodal.mm_utils import ImageProcessorConfig

    if getattr(a, "mesh", ""):
        # the ranks are the mesh's: rank 0 scores every document
        from ..serve.model_worker import start_ranks
        start_ranks(a)
        a.rank, a.world_size = 0, 1
    if a.rank is None or a.world_size is None:
        from ..parallel.distributed import detect_env
        denv = detect_env()
        if a.rank is None:
            a.rank = denv.rank
        if a.world_size is None:
            a.world_size = denv.world_size

    # multi-config loop (evaluate/lmms_eval/__main__.py:120-160): a yaml
    # list of run configs, each overriding the CLI flags
    run_cfgs = [{}]
    if a.config:
        import yaml
        loaded = yaml.safe_load(Path(a.config).read_text())
        run_cfgs = loaded if isinstance(loaded, list) else [loaded]

    register_task_yamls(a.task_yaml)

    all_results = []
    for overrides in run_cfgs:
        run = argparse.Namespace(**{**vars(a), **{
            k.replace("-", "_"): v for k, v in (overrides or {}).items()}})
        if not run.tasks or (model is None and not run.model_dir):
            raise SystemExit("--model-dir and --tasks are required "
                             "(via flags or --config entries)")
        tok = tokenizer
        if model is None:
            loaded, lmodel, image_processor, _ = load_pretrained_model(
                run.model_dir, dtype=torch.bfloat16,
                load_8bit=run.load_8bit, load_4bit=run.load_4bit,
                kv_quant=run.kv_quant or None, device=run.device)
            tok = loaded if tok is None else tok
        else:
            lmodel = model
            image_processor = ImageProcessorConfig(
                size=lmodel.cfg.vision.image_size)
        if tokenizer is None and (tok is None or run.tokenizer):
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(
                run.tokenizer or run.model_dir, local_files_only=True)
        mesh = None
        if getattr(run, "mesh", ""):
            from ..serve.model_worker import shard_llava_params
            lmodel, mesh = shard_llava_params(lmodel, run.mesh)
        lm = harness.TorchLlava(lmodel, tok, image_processor,
                                conv_template=run.conv_template,
                                batch_size=run.batch_size,
                                max_new_tokens=run.max_new_tokens,
                                speculative=getattr(run, "speculative", 0),
                                engine_slots=getattr(run, "engine_slots", 0),
                                engine_max_len=getattr(run,
                                                       "engine_max_len", 0),
                                engine_pipeline=getattr(
                                    run, "engine_pipeline", 1),
                                mesh=mesh)
        if mesh is not None and mesh.rank != 0:
            lm.follow()
            continue
        try:
            results = harness.simple_evaluate(
                lm, run.tasks.split(","), limit=run.limit, rank=run.rank,
                world_size=run.world_size,
                return_id_experts=run.return_id_experts, seed=run.seed,
                merge_dir=getattr(run, "merge_dir", "") or None)
        finally:
            lm.close()
        print(harness.make_table(results))
        out_dir = Path(run.output_path) if run.output_path else \
            Path("eval_results")
        if run.output_path and run.output_path.endswith(".json"):
            Path(run.output_path).write_text(
                json.dumps(results, default=str, indent=1))
            print(f"wrote {run.output_path}")
        else:
            from ..eval.logging_utils import EvalResultsLogger
            rlog = EvalResultsLogger(out_dir, use_wandb=run.wandb,
                                     wandb_project=run.wandb_project,
                                     run_name=Path(run.model_dir).name)
            path = rlog.log_results(results,
                                    log_samples=run.log_samples)
            rlog.finish()
            print(f"wrote {path}")
        all_results.append(results)
    return all_results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
