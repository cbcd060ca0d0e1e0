"""Downstream zero-shot QA datasets (copy of
competesmoe_tpu/data/qa_datasets.py): raw dataset files ->
`eval.lm_zeroshot.ChoiceDoc` streams with the reference's prompt
constructions ("Question: {q}\nAnswer:" contexts, " "-prefixed endings,
length-normalised probability compare).

Loaders read local paths; `ensure_file` downloads the reference's URL
(`URLS`) into the cache only when no path is given. Every loader takes
`encode: str -> List[int]`, so any tokenizer plugs in.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

from ..eval.lm_zeroshot import ChoiceDoc

Encode = Callable[[str], List[int]]

URLS = {
    # reference URL constants (hellaswag.py:14, piqa.py:13-14,
    # lambada.py:77, winogrande.py:21, blimp.py:7, ...)
    "hellaswag": "https://huggingface.co/datasets/DavidNguyen/"
                 "Data_Language_Pretrain/resolve/main/hellaswag_val.jsonl.txt",
    "piqa": "https://huggingface.co/datasets/DavidNguyen/"
            "Data_Language_Pretrain/resolve/main/valid.jsonl",
    "piqa_labels": "https://huggingface.co/datasets/DavidNguyen/"
                   "Data_Language_Pretrain/resolve/main/valid-labels.lst",
    "lambada": "https://openaipublic.blob.core.windows.net/gpt-2/data/"
               "lambada_test.jsonl",
    "winogrande": "https://storage.googleapis.com/ai2-mosaic/public/"
                  "winogrande/winogrande_1.1.zip",
    "blimp": "https://huggingface.co/datasets/DavidNguyen/"
             "Data_Language_Pretrain/resolve/main/BLiMP.zip",
}

_HSWAG_CLEANUP = re.compile(r"\[.*?\]")


def ensure_file(path_or_none: Optional[str], url_key: str,
                cache_dir: str = "./cache") -> Path:
    """Return a local file, downloading the reference URL if absent."""
    if path_or_none:
        return Path(path_or_none)
    from .streaming import fetch_to_cache
    return fetch_to_cache(URLS[url_key], Path(cache_dir) / url_key)


def _jsonl(path: os.PathLike) -> Iterable[dict]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _question_answer_docs(records, encode: Encode, question_key,
                          choices_fn, answer_fn,
                          ctx_fmt="Question: {}\nAnswer:") -> List[ChoiceDoc]:
    """Shared "Question: ...\nAnswer:" + " {ending}" construction
    (ai2arc.py:54-64, openbookqa.py:62-74, commonsenseqa.py:61-73,
    winogrande.py:66-76)."""
    docs = []
    for r in records:
        prefix = encode(ctx_fmt.format(question_key(r)))
        choices = [encode(" " + c) for c in choices_fn(r)]
        docs.append(ChoiceDoc(prefix_ids=prefix, choices_ids=choices,
                              answer=answer_fn(r),
                              normalize_by_length=True))
    return docs


def hellaswag_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """hellaswag_val.jsonl (ref hellaswag.py:44-75): context =
    "{activity_label}: {ctx_a} {Ctx_b}", wikihow-bracket cleanup."""
    def preprocess(t: str) -> str:
        t = t.strip().replace(" [title]", ". ")
        t = _HSWAG_CLEANUP.sub("", t)
        return t.replace("  ", " ")

    docs = []
    for r in _jsonl(path):
        ctx = preprocess(r["activity_label"] + ": " + r["ctx_a"] + " "
                         + r["ctx_b"].capitalize())
        endings = [encode(" " + preprocess(e)) for e in r["endings"]]
        docs.append(ChoiceDoc(prefix_ids=encode(ctx), choices_ids=endings,
                              answer=int(r["label"]),
                              normalize_by_length=True))
    return docs


def piqa_docs(path: os.PathLike, labels_path: os.PathLike,
              encode: Encode) -> List[ChoiceDoc]:
    """valid.jsonl + valid-labels.lst (ref piqa.py:45-70)."""
    labels = Path(labels_path).read_text().splitlines()
    docs = []
    for i, r in enumerate(_jsonl(path)):
        label = int(labels[i])
        prefix = encode(f"Question: {r['goal'].strip()}\nAnswer:")
        choices = [encode(" " + r["sol1"]), encode(" " + r["sol2"])]
        docs.append(ChoiceDoc(prefix_ids=prefix, choices_ids=choices,
                              answer=label, normalize_by_length=True))
    return docs


def arc_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """ARC {Easy,Challenge} *-Test.jsonl (ref ai2arc.py:47-75); questions
    whose option count differs from 4 are skipped like the reference."""
    records = [r for r in _jsonl(path)
               if len(r["question"]["choices"]) == 4
               and r["answerKey"] in
               [c["label"] for c in r["question"]["choices"]]]
    return _question_answer_docs(
        records, encode,
        question_key=lambda r: r["question"]["stem"],
        choices_fn=lambda r: [c["text"] for c in r["question"]["choices"]],
        answer_fn=lambda r: [c["label"] for c in
                             r["question"]["choices"]].index(r["answerKey"]))


def openbookqa_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """OpenBookQA Main/*.jsonl (ref openbookqa.py:54-80)."""
    return arc_docs(path, encode)  # identical record schema + prompt


def commonsenseqa_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """dev_rand_split.jsonl (ref commonsenseqa.py:55-78); 5 options."""
    records = [r for r in _jsonl(path)
               if len(r["question"]["choices"]) == 5]
    return _question_answer_docs(
        records, encode,
        question_key=lambda r: r["question"]["stem"],
        choices_fn=lambda r: [c["text"] for c in r["question"]["choices"]],
        answer_fn=lambda r: [c["label"] for c in
                             r["question"]["choices"]].index(r["answerKey"]))


def winogrande_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """winogrande_1.1/{split}.jsonl (ref winogrande.py:54-79)."""
    return _question_answer_docs(
        _jsonl(path), encode,
        question_key=lambda r: r["sentence"],
        choices_fn=lambda r: [r["option1"], r["option2"]],
        answer_fn=lambda r: int(r["answer"]) - 1)


def siqa_docs(path: os.PathLike, labels_path: os.PathLike,
              encode: Encode) -> List[ChoiceDoc]:
    """socialiqa {split}.jsonl + {split}-labels.lst (ref siqa.py:54-80)."""
    labels = Path(labels_path).read_text().splitlines()
    docs = []
    for i, r in enumerate(_jsonl(path)):
        prefix = encode(f"Context: {r['context']}\n"
                        f"Question: {r['question']}\nAnswer:")
        choices = [encode(" " + r[k])
                   for k in ("answerA", "answerB", "answerC")]
        docs.append(ChoiceDoc(prefix_ids=prefix, choices_ids=choices,
                              answer=int(labels[i]) - 1,
                              normalize_by_length=True))
    return docs


def blimp_docs(root: os.PathLike, encode: Encode,
               phenomena: Optional[List[str]] = None) -> List[ChoiceDoc]:
    """BLiMP: per-phenomenon jsonl of {sentence_good, sentence_bad} pairs;
    group label = file stem so the evaluator reports per-phenomenon and
    group-average accuracies (ref blimp.py + probability_compare plot)."""
    root = Path(root)
    files = sorted(root.glob("*.jsonl"))
    if phenomena:
        files = [f for f in files if f.stem in phenomena]
    docs = []
    for f in files:
        for r in _jsonl(f):
            docs.append(ChoiceDoc(
                prefix_ids=[],
                choices_ids=[encode(r["sentence_good"]),
                             encode(r["sentence_bad"])],
                answer=0, normalize_by_length=False, group=f.stem))
    return docs


def lambada_items(path: os.PathLike, encode: Encode):
    """lambada_test.jsonl: last-word greedy-match items
    (ref lambada.py:77-120); returns (prefix_ids, word_ids) pairs for
    eval.lm_zeroshot.lambada_accuracy."""
    items = []
    for r in _jsonl(path):
        text = r["text"].strip()
        prefix, _, word = text.rpartition(" ")
        items.append((encode(prefix), encode(" " + word)))
    return items


def race_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """RACE jsonl ({article, question, options, answer:'A'..'D'}), prompt
    per ref race.py: article as context + Question/Answer scaffold."""
    docs = []
    for r in _jsonl(path):
        prefix = encode(f"Article: {r['article']}\n"
                        f"Question: {r['question']}\nAnswer:")
        choices = [encode(" " + o) for o in r["options"]]
        docs.append(ChoiceDoc(prefix_ids=prefix, choices_ids=choices,
                              answer="ABCD".index(r["answer"]),
                              normalize_by_length=True))
    return docs


def cbt_docs(path: os.PathLike, encode: Encode) -> List[ChoiceDoc]:
    """Children's Book Test jsonl ({context, question(with XXXXX),
    options, answer}) — the cloze is filled per option (ref cbt.py)."""
    docs = []
    for r in _jsonl(path):
        prefix = encode(r["context"] + "\n")
        choices = [encode(r["question"].replace("XXXXX", o))
                   for o in r["options"]]
        docs.append(ChoiceDoc(prefix_ids=prefix, choices_ids=choices,
                              answer=r["options"].index(r["answer"]),
                              normalize_by_length=True))
    return docs


# registry: name -> (loader kwargs schema) used by the LM task flags
QA_LOADERS: Dict[str, Callable] = {
    "hellaswag": hellaswag_docs,
    "piqa": piqa_docs,
    "ai2arc": arc_docs,
    "openbookqa": openbookqa_docs,
    "commonsenseqa": commonsenseqa_docs,
    "winogrande": winogrande_docs,
    "siqa": siqa_docs,
    "blimp": blimp_docs,
    "race": race_docs,
    "cbt": cbt_docs,
}
