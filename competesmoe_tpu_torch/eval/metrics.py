"""Metric and aggregation registry.

Re-design of `evaluate/lmms_eval/api/{metrics,registry}.py`: string-keyed
metric/aggregation/filter registries plus the core metric implementations
(exact match, ANLS, accuracy, perplexity aggregations).

The port's own copy of competesmoe_tpu/eval/metrics.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

import math
import re
import statistics
from typing import Callable, Dict, List

METRIC_REGISTRY: Dict[str, Callable] = {}
AGGREGATION_REGISTRY: Dict[str, Callable] = {}
FILTER_REGISTRY: Dict[str, Callable] = {}


def register_metric(name):
    def deco(fn):
        METRIC_REGISTRY[name] = fn
        return fn
    return deco


def register_aggregation(name):
    def deco(fn):
        AGGREGATION_REGISTRY[name] = fn
        return fn
    return deco


def register_filter(name):
    def deco(fn):
        FILTER_REGISTRY[name] = fn
        return fn
    return deco


def get_metric(name):
    return METRIC_REGISTRY[name]


def get_aggregation(name):
    return AGGREGATION_REGISTRY[name]


# -- aggregations --

@register_aggregation("mean")
def agg_mean(xs: List[float]) -> float:
    return float(statistics.fmean(xs)) if xs else float("nan")


@register_aggregation("median")
def agg_median(xs: List[float]) -> float:
    return float(statistics.median(xs)) if xs else float("nan")


@register_aggregation("sum")
def agg_sum(xs: List[float]) -> float:
    return float(sum(xs))


@register_aggregation("perplexity")
def agg_perplexity(xs: List[float]) -> float:
    # xs are total log-likelihoods per token
    return float(math.exp(-statistics.fmean(xs))) if xs else float("nan")


# -- metrics (doc-level) --

def _normalize_text(s: str, ignore_case=True, ignore_punct=False) -> str:
    if ignore_case:
        s = s.lower()
    if ignore_punct:
        s = re.sub(r"[^\w\s]", "", s)
    return " ".join(s.split())


@register_metric("exact_match")
def exact_match(pred: str, target: str, ignore_case=True,
                ignore_punctuation=False) -> float:
    return float(_normalize_text(pred, ignore_case, ignore_punctuation)
                 == _normalize_text(target, ignore_case,
                                    ignore_punctuation))


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@register_metric("anls")
def anls(pred: str, targets, threshold: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity (api/metrics.py anls)."""
    if isinstance(targets, str):
        targets = [targets]
    best = 0.0
    for t in targets:
        a, b = pred.strip().lower(), t.strip().lower()
        denom = max(len(a), len(b))
        sim = 1.0 - (_levenshtein(a, b) / denom) if denom else 1.0
        best = max(best, sim)
    return best if best >= threshold else 0.0


@register_metric("accuracy")
def accuracy(pred, target) -> float:
    return float(pred == target)


@register_metric("vqa_accuracy")
def vqa_accuracy_metric(pred, target) -> float:
    """EvalAI 10-annotator consensus accuracy (tasks/vqav2/utils.py:20-46);
    target may be a list of annotator answers or a single string."""
    from .vqa_metrics import vqa_accuracy
    if isinstance(target, str):
        target = [target]
    return vqa_accuracy(pred, list(target))


@register_metric("relaxed_accuracy")
def relaxed_accuracy_metric(pred, target) -> float:
    """ChartQA relaxed correctness (tasks/chartqa/utils.py:25-67)."""
    from .vqa_metrics import relaxed_correctness
    return relaxed_correctness(pred, target)


@register_metric("ocrbench_accuracy")
def ocrbench_metric(pred, target) -> float:
    """OCRBench containment scoring (tasks/ocrbench/utils.py:30-62)."""
    from .vqa_metrics import ocrbench_contains
    return ocrbench_contains(pred, target)


@register_metric("cider_item")
def cider_item(pred, target):
    """Passthrough pairing for corpus-level CIDEr-D: returns the raw
    (candidate, references) tuple; the `cider` aggregation consumes the
    full list (the reference's *_passthrough metrics + pycocoevalcap)."""
    refs = [target] if isinstance(target, str) else list(target)
    return (pred, refs)


@register_aggregation("cider")
def agg_cider(items) -> float:
    from .vqa_metrics import cider_d
    return cider_d(items)


def mme_parse_pred(pred: str) -> str:
    """Otter-eval yes/no parsing (tasks/mme/utils.py:62-85)."""
    pred = str(pred).lower().strip().replace(".", "")
    if pred in ("yes", "no"):
        return pred
    if len(pred) == 1:
        return {"y": "yes", "n": "no"}.get(pred, "other")
    prefix = pred[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


@register_aggregation("mme")
def agg_mme(items) -> float:
    """MME paired scoring (tasks/mme/utils.py:97-126): each image carries
    two yes/no questions; per pair score = acc(%) + acc_plus(%) where
    acc_plus requires BOTH answers correct; category scores are pair
    averages and the final number is the SUM over categories (perception
    max 2000, cognition max 800). items: dicts with question_id/category/
    score."""
    from collections import defaultdict

    cat2q = defaultdict(lambda: defaultdict(list))
    for it in items:
        cat2q[it["category"]][it["question_id"]].append(it["score"])
    total = 0.0
    for cat, q2s in cat2q.items():
        cat_total = 0.0
        for qid, scores in q2s.items():
            acc = sum(scores) / len(scores) * 100.0
            acc_plus = float(sum(scores) == len(scores) == 2) * 100.0
            cat_total += acc + acc_plus
        total += cat_total / len(q2s)
    return total


# -- filters (response post-processing pipeline) --

@register_filter("regex")
def regex_filter(resp: str, pattern: str, group: int = 1,
                 fallback: str = "[invalid]") -> str:
    m = re.search(pattern, resp)
    if m is None:
        return fallback
    try:
        return m.group(group)
    except IndexError:
        return m.group(0)


@register_filter("take_first_line")
def take_first_line(resp: str) -> str:
    return resp.strip().split("\n")[0]


@register_filter("strip")
def strip_filter(resp: str) -> str:
    return resp.strip()


def bootstrap_stderr(values, n_resamples: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (the reference's stderr
    machinery behind metric aggregation, evaluator.py:~330-560 /
    lm-eval's bootstrap_stderr): resample the per-sample scores with
    replacement, take the std of the resampled means."""
    import numpy as np

    values = np.asarray(values, np.float64)
    if values.size <= 1:
        return 0.0
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, values.size, size=(n_resamples, values.size))
    means = values[idx].mean(axis=1)
    return float(means.std(ddof=1))


def pooled_stderr(stderrs, sizes) -> float:
    """Combine member-task stderrs into a group stderr (size-weighted
    pooled variance of the mean)."""
    import math
    total = sum(sizes)
    if total == 0:
        return 0.0
    var = sum((n / total) ** 2 * s ** 2 for s, n in zip(stderrs, sizes))
    return math.sqrt(var)
