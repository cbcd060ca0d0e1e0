"""Evaluation tasks: config-driven request building and scoring.

Re-design of `evaluate/lmms_eval/api/task.py:53-1301` — TaskConfig
(yaml/dict-driven with doc_to_* hooks), ConfigurableTask building Instances
per doc, rank/world splitting, filter pipeline, and metric aggregation —
plus the task registry (`register_task`).

The port's own copy of competesmoe_tpu/eval/task.py: it imports neither
JAX nor that package.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

from .instance import Instance
from .metrics import (
    AGGREGATION_REGISTRY,
    FILTER_REGISTRY,
    METRIC_REGISTRY,
    get_aggregation,
    get_metric,
)

TASK_REGISTRY: Dict[str, "TaskConfig"] = {}


def register_task(name: str, cfg: Union["TaskConfig", dict]):
    if isinstance(cfg, dict):
        cfg = TaskConfig(**cfg)
    TASK_REGISTRY[name] = cfg
    return cfg


def get_task_config(name: str) -> "TaskConfig":
    try:
        return TASK_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown task {name!r}; registered: "
                         f"{', '.join(sorted(TASK_REGISTRY))}") from None


def _resolve(fn, search_dir: Optional[Path] = None):
    """Resolve a '!function module.attr'-style hook (api/task.py yaml
    `!function` support) or pass callables through. When `search_dir` is
    given, the module may be a .py file next to the yaml (the reference's
    per-task utils.py convention)."""
    if callable(fn) or fn is None:
        return fn
    if isinstance(fn, str) and fn.startswith("!function "):
        modname, attr = fn[len("!function "):].rsplit(".", 1)
        if search_dir is not None and \
                (Path(search_dir) / f"{modname}.py").exists():
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                f"_task_utils_{modname}",
                Path(search_dir) / f"{modname}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return getattr(mod, attr)
        return getattr(importlib.import_module(modname), attr)
    if isinstance(fn, str):
        # bare string = doc field name (lm-eval yaml convention)
        key = fn
        return lambda doc: str(doc[key]) if key in doc else key
    return fn


def _with_prompt_kwargs(fn, mspk):
    """Adapt a hook to the reference's two-arg convention
    (`fn(doc, model_specific_prompt_kwargs)`, api/task.py): if the
    callable requires (or accepts) a second positional arg, pass the
    config's prompt kwargs (defaulting to {})."""
    if fn is None or not callable(fn):
        return fn
    import inspect
    try:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY,
                                p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        return fn
    if len(params) >= 2:
        return lambda doc: fn(doc, mspk if mspk is not None else {})
    return fn


def load_task_yaml(path, register: bool = True) -> "TaskConfig":
    """Build (and register) a TaskConfig from a reference-style task yaml
    (api/task.py:53-152): supports the `!function utils.fn` tag (resolved
    against .py files next to the yaml), `include:` templates from the
    same directory, and ignores fields outside our config surface. The
    lmms_eval/loguru import shims (eval/lmms_compat.py) are installed
    first so the reference's own per-task utils.py files import
    unmodified."""
    import yaml

    from .lmms_compat import ensure_lmms_compat, register_tasks_root
    ensure_lmms_compat()
    # sibling-module imports (lmms_eval.tasks.<dir>.<mod>) resolve under
    # the yaml's tasks root
    register_tasks_root(Path(path).resolve().parent.parent)

    path = Path(path)

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor(
        "!function",
        lambda loader, node: "!function " + loader.construct_scalar(node))

    def read(p: Path) -> dict:
        data = yaml.load(p.read_text(), Loader=_Loader) or {}
        if "include" in data:
            inc = path.parent / data.pop("include")
            if not inc.suffix:
                inc = inc.with_suffix(".yaml") \
                    if inc.with_suffix(".yaml").exists() else inc
            base = read(inc)
            base.update(data)
            data = base
        return data

    raw = read(path)
    known = {f.name for f in dataclasses.fields(TaskConfig)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    for hook in ("doc_to_text", "doc_to_visual", "doc_to_target",
                 "process_results"):
        if hook in kwargs:
            kwargs[hook] = _resolve(kwargs[hook], search_dir=path.parent)
    # yaml nests prompt kwargs per model; use the "default" entry
    mspk = kwargs.get("model_specific_prompt_kwargs")
    if isinstance(mspk, dict) and "default" in mspk:
        kwargs["model_specific_prompt_kwargs"] = mspk["default"]
    # normalize reference metric_list aggregation callables to names
    for spec in kwargs.get("metric_list", []) or []:
        if isinstance(spec.get("aggregation"), str) and \
                spec["aggregation"].startswith("!function "):
            spec["aggregation"] = "mean"
        spec.pop("higher_is_better", None)
    cfg = TaskConfig(**kwargs)
    if register and cfg.task:
        register_task(cfg.task, cfg)
    return cfg


@dataclasses.dataclass
class TaskConfig:
    """Mirror of the reference's yaml-driven TaskConfig (api/task.py:53-152
    fields that the live pipeline uses)."""

    task: str = ""
    dataset_path: Optional[str] = None       # HF datasets path or None
    dataset_name: Optional[str] = None
    test_split: str = "test"
    output_type: str = "generate_until"      # or 'loglikelihood'
    doc_to_text: Any = None                  # callable(doc) -> str
    doc_to_visual: Any = None                # callable(doc) -> list[PIL]
    doc_to_target: Any = None                # callable(doc) -> str
    process_results: Any = None              # callable(doc, resps) -> dict
    generation_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    metric_list: List[Dict[str, Any]] = dataclasses.field(
        default_factory=lambda: [{"metric": "exact_match",
                                  "aggregation": "mean"}])
    filter_list: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    # offline escape hatch: explicit documents instead of dataset download
    docs: Optional[List[dict]] = None
    # metric group this task aggregates into (the reference's task-group
    # aggregation, evaluator.py:~330-560); None = ungrouped
    group: Optional[str] = None
    # few-shot prompting (api/task.py ContextSampler role): k seeded
    # example Q/A pairs prepended to every context
    num_fewshot: int = 0
    fewshot_split: Optional[str] = None
    fewshot_seed: int = 1234
    fewshot_delimiter: str = "\n\n"
    # per-model prompt kwargs passed as the reference hooks' second arg
    # (yaml `model_specific_prompt_kwargs.default`, api/task.py)
    model_specific_prompt_kwargs: Optional[Dict[str, Any]] = None


def _containment_score(pred, target) -> float:
    """Offline stand-in for GPT-judge scoring: exact match or target
    containment on normalized text. Reported under
    `offline_judge_containment` with the `offline_metric` flag set, so it
    can never be confused with a real judge score."""
    p = " ".join(str(pred).lower().split())
    t = " ".join(str(target).lower().split())
    if not t:
        return 0.0
    return 1.0 if (p == t or t in p) else 0.0


class ConfigurableTask:
    """Builds requests from docs, applies filters, scores and aggregates."""

    def __init__(self, cfg: TaskConfig, limit: Optional[int] = None):
        self.cfg = cfg
        mspk = cfg.model_specific_prompt_kwargs
        self.doc_to_text = _with_prompt_kwargs(
            _resolve(cfg.doc_to_text), mspk)
        self.doc_to_visual = _with_prompt_kwargs(
            _resolve(cfg.doc_to_visual), mspk)
        self.doc_to_target = _with_prompt_kwargs(
            _resolve(cfg.doc_to_target), mspk)
        self.process_results = _resolve(cfg.process_results)
        self._docs = self._load_docs(limit)
        self.instances: List[Instance] = []

    def _load_docs(self, limit):
        if self.cfg.docs is not None:
            docs = list(self.cfg.docs)
        elif self.cfg.dataset_path:
            import datasets
            ds = datasets.load_dataset(self.cfg.dataset_path,
                                       self.cfg.dataset_name,
                                       split=self.cfg.test_split)
            docs = list(ds)
        else:
            raise ValueError(f"task {self.cfg.task}: no docs or dataset")
        return docs[:limit] if limit else docs

    @property
    def docs(self):
        return self._docs

    def fewshot_context(self, doc_id: int) -> str:
        """Seeded k-shot example prefix (api/task.py few-shot sampler):
        examples drawn from `fewshot_split` docs (or this split, excluding
        the current doc) as 'question answer' pairs."""
        if not self.cfg.num_fewshot:
            return ""
        import random as _random
        pool_ids = [i for i in range(len(self._fewshot_docs))
                    if self._fewshot_docs is not self._docs or i != doc_id]
        rng = _random.Random(self.cfg.fewshot_seed + doc_id)
        picks = rng.sample(pool_ids,
                           min(self.cfg.num_fewshot, len(pool_ids)))
        parts = []
        for i in picks:
            d = self._fewshot_docs[i]
            q = self.doc_to_text(d) if self.doc_to_text else ""
            a = self.doc_to_target(d) if self.doc_to_target else ""
            parts.append(f"{q} {a}".strip())
        return self.cfg.fewshot_delimiter.join(parts) \
            + self.cfg.fewshot_delimiter

    @property
    def _fewshot_docs(self):
        if self.cfg.fewshot_split and self.cfg.dataset_path:
            if not hasattr(self, "_fs_docs"):
                import datasets
                self._fs_docs = list(datasets.load_dataset(
                    self.cfg.dataset_path, self.cfg.dataset_name,
                    split=self.cfg.fewshot_split))
            return self._fs_docs
        return self._docs

    def build_all_requests(self, rank: int = 0, world_size: int = 1
                           ) -> List[Instance]:
        """Instances for this rank's slice (evaluator.py:257 semantics)."""
        self.instances = []
        for doc_id, doc in enumerate(self._docs):
            if doc_id % world_size != rank:
                continue
            ctx = self.doc_to_text(doc) if self.doc_to_text else ""
            if self.cfg.num_fewshot:
                ctx = self.fewshot_context(doc_id) + ctx
            visuals = self.doc_to_visual(doc) if self.doc_to_visual else []
            if self.cfg.output_type == "generate_until":
                arguments = (ctx, self.cfg.generation_kwargs, visuals)
            else:
                target = self.doc_to_target(doc) if self.doc_to_target \
                    else ""
                arguments = (ctx, target, visuals)
            self.instances.append(Instance(
                request_type=self.cfg.output_type, arguments=arguments,
                idx=0, metadata=(self.cfg.task, doc_id, 1)))
        return self.instances

    def apply_filters(self) -> None:
        """Run the filter pipeline over responses (filters/*)."""
        specs = self.cfg.filter_list or [{"name": "none"}]
        for inst in self.instances:
            resps = list(inst.resps)
            for spec in self.cfg.filter_list:
                fn = FILTER_REGISTRY[spec["filter"]]
                kwargs = {k: v for k, v in spec.items() if k != "filter"}
                resps = [fn(r, **kwargs) if isinstance(r, str) else r
                         for r in resps]
            inst.filtered_resps["default"] = resps
        del specs

    @staticmethod
    def _coerce_float(v):
        """Metric values are floats except for corpus-level passthrough
        metrics (e.g. cider_item), whose raw items go to the aggregation."""
        try:
            return float(v)
        except (TypeError, ValueError):
            return v

    def score(self) -> Dict[str, float]:
        """Per-doc metrics -> aggregation (evaluator.py:330-560 role).
        Per-sample scores are kept on `self.sample_scores` so the
        evaluator can compute bootstrap stderrs and group aggregates."""
        per_metric: Dict[str, List[float]] = {}
        for inst in self.instances:
            if inst.padded:
                continue
            doc = self._docs[inst.doc_id]
            resps = inst.filtered_resps.get("default", inst.resps)
            if self.process_results is not None:
                try:
                    results = self.process_results(doc, resps)
                except RuntimeError as e:
                    # GPT-judge tasks (llava-in-the-wild etc.) raise from
                    # the offline openai/reka stubs; fall back to an
                    # exact/containment score and FLAG it — offline
                    # numbers must never be mistaken for judge scores.
                    if "offline" not in str(e):
                        raise
                    tgt = (self.doc_to_target(doc)
                           if self.doc_to_target else "")
                    results = {"offline_judge_containment":
                               _containment_score(resps[0] if resps
                                                  else "", tgt)}
                    self.offline_metric = True
                for k, v in results.items():
                    per_metric.setdefault(k, []).append(self._coerce_float(v))
                continue
            target = self.doc_to_target(doc) if self.doc_to_target else ""
            for spec in self.cfg.metric_list:
                fn = get_metric(spec["metric"])
                kwargs = {k: v for k, v in spec.items()
                          if k not in ("metric", "aggregation")}
                if self.cfg.output_type == "generate_until":
                    val = fn(resps[0], target, **kwargs)
                else:
                    # loglikelihood responses: (ll, is_greedy)
                    val = float(resps[0][1])
                per_metric.setdefault(spec["metric"],
                                      []).append(self._coerce_float(val))
        self.sample_scores = per_metric
        return self.aggregate(per_metric)

    def aggregate(self, per_metric: Dict[str, list]) -> Dict[str, float]:
        """Aggregation over per-sample scores — factored out of score()
        so the evaluator can re-aggregate MERGED rank shards (the
        reference's accelerate gather role, evaluator.py:~330-560)."""
        out = {}
        for spec in self.cfg.metric_list:
            name = spec["metric"]
            if name not in per_metric:
                continue
            agg = get_aggregation(spec.get("aggregation", "mean"))
            out[name] = agg(per_metric[name])
        for name, vals in per_metric.items():
            if name not in out:
                out[name] = get_aggregation("mean")(vals)
        if getattr(self, "offline_metric", False):
            out["offline_metric"] = True
        return out
