"""Zero-shot LM downstream evaluation: probability compare over choices
(port of competesmoe_tpu/eval/lm_zeroshot.py).

Each doc gives a prefix and candidate continuations; the model scores
each (prefix + choice), and the gold choice must beat every other one
strictly. Sequences are padded to a multiple of `pad_quantum` (at most
`max_len`) and scored a bucket of one length at a time, so the model sees
a handful of shapes; the model reads `tokens[:, :-1]`, so a bucket of
length L runs attention at T = L - 1. Scoring runs under
`torch.no_grad()` on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ChoiceDoc:
    prefix_ids: List[int]
    choices_ids: List[List[int]]
    answer: int
    normalize_by_length: bool = False
    # optional group label (e.g. the BLiMP phenomenon); the evaluator
    # reports accuracy/{group} and accuracy/group_average like the
    # reference's ProbabilityCompareTest.plot
    group: Optional[str] = None


class LMZeroShotEvaluator:
    """Scores choice docs with the LM, one forward per length bucket."""

    def __init__(self, model, pad_quantum: int = 64, max_len: int = 1024):
        self.model = model
        self.pad_quantum = pad_quantum
        self.max_len = max_len

    @torch.no_grad()
    def score(self, tokens: torch.Tensor, choice_mask: torch.Tensor):
        """tokens [B, L]; choice_mask 1 where the CHOICE tokens sit ->
        (total logprob, mean logprob, greedy) per row."""
        logits, _ = self.model(tokens[:, :-1], train=False)
        lp = torch.log_softmax(logits.float(), dim=-1)
        tgt = tokens[:, 1:]
        tok_lp = torch.gather(lp, -1, tgt[..., None])[..., 0]
        m = choice_mask[:, 1:]
        total = torch.sum(tok_lp * m, dim=-1)
        n = torch.clamp(torch.sum(m, dim=-1), min=1)
        greedy = torch.where(m > 0, lp.argmax(-1) == tgt,
                             torch.ones_like(tgt, dtype=torch.bool)).all(-1)
        return total, total / n, greedy

    def _quantize(self, n: int) -> int:
        q = self.pad_quantum
        return min(max(q, ((n + q - 1) // q) * q), self.max_len)

    def score_sequences(self, seqs: List[Tuple[List[int], List[int]]]
                        ) -> List[Tuple[float, float, bool]]:
        """seqs: list of (prefix_ids, choice_ids). Returns per-sequence
        (total_lp, mean_lp, is_greedy), batched per quantized length."""
        results: List = [None] * len(seqs)
        buckets: Dict[int, List[int]] = {}
        for i, (p, c) in enumerate(seqs):
            L = self._quantize(len(p) + len(c))
            buckets.setdefault(L, []).append(i)
        for L, idxs in buckets.items():
            toks = np.zeros((len(idxs), L), np.int32)
            mask = np.zeros((len(idxs), L), np.float32)
            for row, i in enumerate(idxs):
                p, c = seqs[i]
                full = (p + c)[:L]
                toks[row, :len(full)] = full
                start = min(len(p), L)
                mask[row, start:len(full)] = 1.0
            dev = self.model.output.weight.device
            total, mean, greedy = (t.cpu() for t in self.score(
                torch.from_numpy(toks.astype(np.int64)).to(dev),
                torch.from_numpy(mask).to(dev)))
            for row, i in enumerate(idxs):
                results[i] = (float(total[row]), float(mean[row]),
                              bool(greedy[row]))
        return results

    def evaluate(self, docs: Iterable[ChoiceDoc]) -> Dict[str, float]:
        """Probability-compare accuracy. A doc counts as correct only if
        the gold option's (length-normalized) logprob is STRICTLY greater
        than every other option's — ties lose, exactly like the
        reference's `ok &= good_lprob > bad_lprob`
        (probability_compare_dataset.py:49-54). With `group` labels set,
        per-group accuracies plus the reference's `group_average` /
        `seq_average` channels are reported."""
        docs = list(docs)
        flat: List[Tuple[List[int], List[int]]] = []
        spans = []
        for d in docs:
            spans.append((len(flat), len(d.choices_ids)))
            for c in d.choices_ids:
                flat.append((d.prefix_ids, c))
        scores = self.score_sequences(flat)
        correct = 0
        groups: Dict[str, List[int]] = {}
        for d, (start, n) in zip(docs, spans):
            vals = [scores[start + j][1 if d.normalize_by_length else 0]
                    for j in range(n)]
            good = vals[d.answer]
            ok = all(good > v for j, v in enumerate(vals) if j != d.answer)
            correct += int(ok)
            if d.group is not None:
                groups.setdefault(d.group, []).append(int(ok))
        res = {"accuracy": correct / max(len(docs), 1),
               "n_docs": len(docs)}
        if groups:
            per_group = {g: sum(v) / len(v) for g, v in groups.items()}
            for g, acc in per_group.items():
                res[f"accuracy/{g}"] = acc
            res["accuracy/group_average"] = (
                sum(per_group.values()) / len(per_group))
            res["accuracy/seq_average"] = res["accuracy"]
        return res


# --- downstream task adapters (dataset -> ChoiceDoc stream) -------------

def binary_sentence_docs(pairs: Sequence[Tuple[List[int], List[int]]]
                         ) -> List[ChoiceDoc]:
    """BLiMP-style: (good_ids, bad_ids) pairs; empty prefix; answer=0."""
    return [ChoiceDoc(prefix_ids=[], choices_ids=[g, b], answer=0)
            for g, b in pairs]


def completion_docs(items: Sequence[Tuple[List[int], List[List[int]], int]],
                    normalize: bool = True) -> List[ChoiceDoc]:
    """HellaSwag/PIQA/ARC-style: (context, endings, answer)."""
    return [ChoiceDoc(prefix_ids=p, choices_ids=cs, answer=a,
                      normalize_by_length=normalize)
            for p, cs, a in items]


def lambada_docs(items: Sequence[Tuple[List[int], List[int]]]
                 ) -> List[ChoiceDoc]:
    """Lambada: the model must put the true last word first among
    {true word} — scored as greedy-match accuracy via single choice."""
    return [ChoiceDoc(prefix_ids=p, choices_ids=[w], answer=0)
            for p, w in items]


def lambada_accuracy(ev: LMZeroShotEvaluator,
                     items: Sequence[Tuple[List[int], List[int]]]
                     ) -> Dict[str, float]:
    """Exact last-word prediction accuracy (greedy match over the target
    tokens), the lm_eval_mixin lambada metric."""
    seqs = [(p, w) for p, w in items]
    scores = ev.score_sequences(seqs)
    acc = sum(1 for (_, _, g) in scores if g) / max(len(scores), 1)
    return {"accuracy": acc, "n_docs": len(scores)}
