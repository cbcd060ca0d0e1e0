"""VQA-family scoring utilities.

Implements the standard public evaluation procedures used by the reference's
task utils:

- EvalAI/VQAv2 answer normalization + 10-annotator consensus accuracy
  (ref evaluate/lmms_eval/tasks/_task_utils/vqa_eval_metric.py — itself
  copied from facebookresearch/mmf — and tasks/vqav2/utils.py:20-54).
  The contraction/number tables are the standard published VQA-eval data
  tables; they must match byte-for-byte for score parity.
- ChartQA relaxed correctness (tasks/chartqa/utils.py:25-67, from
  Methani et al. 2020: numeric answers within 5%, exact match otherwise).
- OCRBench containment scoring (tasks/ocrbench/utils.py:30-62).
- Corpus-level CIDEr-D for the captioning tasks (coco_cap/textcaps/nocaps/
  flickr30k; the reference vendors pycocoevalcap — same algorithm:
  tf-idf 1..4-gram consensus with count clipping and a gaussian length
  penalty, sigma=6).

The port's own copy of competesmoe_tpu/eval/vqa_metrics.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# EvalAI answer normalization (public VQA-eval data tables)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = ("a", "an", "the")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) \
                or _COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = _NUMBER_MAP.get(word, word)
        if word not in _ARTICLES:
            words.append(word)
    return " ".join(_CONTRACTIONS.get(w, w) for w in words)


def normalize_vqa_answer(item: str) -> str:
    """The EvalAIAnswerProcessor pipeline (vqa_eval_metric.py:208-214)."""
    item = item.lower().replace(",", "").replace("?", "") \
        .replace("'s", " 's").strip()
    item = item.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(item))


def vqa_accuracy(pred: str, answers: Sequence[str]) -> float:
    """10-annotator consensus accuracy (tasks/vqav2/utils.py:20-46):
    for each annotator, acc = min(1, #other annotators agreeing with the
    prediction / 3); report the mean. Normalization applies only when the
    annotators disagree among themselves (utils.py:34-39)."""
    if not answers:
        return 0.0
    pred = normalize_vqa_answer(pred)
    clean = [a.replace("\n", " ").replace("\t", " ").strip()
             for a in answers]
    if len(set(clean)) > 1:
        clean = [process_digit_article(process_punctuation(a))
                 for a in clean]
    accs = []
    for i in range(len(clean)):
        others = clean[:i] + clean[i + 1:]
        matching = sum(1 for o in others if o == pred)
        accs.append(min(1.0, matching / 3.0))
    return sum(accs) / len(accs)


# ---------------------------------------------------------------------------
# ChartQA relaxed correctness
# ---------------------------------------------------------------------------

def _to_float(text: str):
    try:
        if text.endswith("%"):
            return float(text.rstrip("%")) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_correctness(pred: str, target: str,
                        max_relative_change: float = 0.05) -> float:
    """Numeric answers within 5% relative error count as correct; other
    answers need a (case-insensitive) exact match
    (tasks/chartqa/utils.py:25-67)."""
    pred, target = str(pred).strip(), str(target).strip()
    p, t = _to_float(pred), _to_float(target)
    if p is not None and t:  # reference guards `target_float` truthiness
        return float(abs(p - t) / abs(t) <= max_relative_change)
    return float(pred.lower() == target.lower())


# ---------------------------------------------------------------------------
# OCRBench containment scoring
# ---------------------------------------------------------------------------

def ocrbench_contains(pred: str, answers) -> float:
    """1 if any ground-truth string is contained in the prediction after
    lowercasing and newline-stripping (tasks/ocrbench/utils.py:50-62)."""
    if isinstance(answers, str):
        answers = [answers]
    p = str(pred).lower().strip().replace("\n", " ")
    for a in answers:
        if str(a).lower().strip().replace("\n", " ") in p:
            return 1.0
    return 0.0


# ---------------------------------------------------------------------------
# CIDEr-D (corpus-level captioning consensus)
# ---------------------------------------------------------------------------

_CAP_PUNCT = re.compile(r"[^a-z0-9 ]+")


def _caption_tokens(s: str) -> List[str]:
    return _CAP_PUNCT.sub(" ", s.lower()).split()


def _ngram_counts(tokens: List[str], max_n: int = 4
                  ) -> List[Counter]:
    out = []
    for n in range(1, max_n + 1):
        out.append(Counter(tuple(tokens[i:i + n])
                           for i in range(len(tokens) - n + 1)))
    return out


def cider_d(items: Iterable[Tuple[str, Sequence[str]]], max_n: int = 4,
            sigma: float = 6.0) -> float:
    """CIDEr-D over (candidate, references) pairs.

    tf-idf n-gram consensus (n = 1..4): candidate counts clipped to the
    per-reference maximum, cosine similarity against each reference's
    tf-idf vector, gaussian length penalty exp(-(lc-lr)^2 / (2 sigma^2)),
    x10, averaged over refs then over n then over the corpus. Document
    frequencies come from the reference sets, as in pycocoevalcap's
    CiderScorer (which the reference harness vendors for coco_cap etc.).
    """
    items = [(str(c), [str(r) for r in refs]) for c, refs in items]
    if not items:
        return float("nan")
    # document frequency over reference sets
    df: List[Dict[tuple, int]] = [defaultdict(int) for _ in range(max_n)]
    for _, refs in items:
        seen = [set() for _ in range(max_n)]
        for ref in refs:
            for n, counts in enumerate(_ngram_counts(_caption_tokens(ref),
                                                     max_n)):
                seen[n].update(counts.keys())
        for n in range(max_n):
            for g in seen[n]:
                df[n][g] += 1
    log_total = math.log(max(len(items), 1))

    def tfidf(counts: Counter, n: int) -> Tuple[Dict[tuple, float], float]:
        vec, norm2 = {}, 0.0
        length = sum(counts.values())
        for g, c in counts.items():
            idf = log_total - math.log(max(df[n][g], 1))
            w = (c / max(length, 1)) * idf if length else 0.0
            vec[g] = w
            norm2 += w * w
        return vec, math.sqrt(norm2)

    scores = []
    for cand, refs in items:
        ctoks = _caption_tokens(cand)
        cgrams = _ngram_counts(ctoks, max_n)
        per_n = [0.0] * max_n
        for ref in refs:
            rtoks = _caption_tokens(ref)
            rgrams = _ngram_counts(rtoks, max_n)
            delta = len(ctoks) - len(rtoks)
            penalty = math.exp(-(delta ** 2) / (2.0 * sigma ** 2))
            for n in range(max_n):
                # CIDEr-D: clip candidate counts to the reference's
                clipped = Counter({g: min(c, rgrams[n].get(g, 0))
                                   for g, c in cgrams[n].items()})
                cv, cn = tfidf(clipped, n)
                rv, rn = tfidf(rgrams[n], n)
                dot = sum(w * rv.get(g, 0.0) for g, w in cv.items())
                sim = dot / (cn * rn) if cn and rn else 0.0
                per_n[n] += penalty * sim
        n_refs = max(len(refs), 1)
        scores.append(10.0 * sum(p / n_refs for p in per_n) / max_n)
    return sum(scores) / len(scores)
