"""Import-compatibility shim so REFERENCE task files run unmodified.

The reference's per-task `utils.py` modules (loaded through our
`load_task_yaml`'s `!function` resolution) import pieces of the
`lmms_eval` package and `loguru`. This module registers stand-ins in
`sys.modules` for exactly the surface those utils use (survey over
`tasks/*/utils.py`: 31x `_task_utils.file_utils`, 9x filters, 4x
`vqa_eval_metric`, plus the ubiquitous loguru logger), implemented
against this framework's own metric/filter code. Nothing is shimmed if
the real package is importable.

Semantics mirror the reference implementations:
- `generate_submission_file` — evaluate/lmms_eval/tasks/_task_utils/
  file_utils.py:4-10 (output_path/subpath/file_name, makedirs, abspath)
- `EvalAIAnswerProcessor` — vqa_eval_metric.py:4-214 via
  `eval.vqa_metrics.normalize_vqa_answer`
- filters — filters/extraction.py (Whitespace/Regex/ExtendedRegex) and
  filters/transformation.py (Lowercase/Uppercase/Map)

The port's own copy of competesmoe_tpu/eval/lmms_compat.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

import re
import sys
import types
import unicodedata


def _module(name: str) -> types.ModuleType:
    import importlib.machinery
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    sys.modules[name] = mod
    return mod


def _have(name: str) -> bool:
    try:
        __import__(name)
        return True
    except ImportError:
        return False


# ---------------------------------------------------------------------------
# Pluggable frame sampler: the decord.VideoReader role for video tasks
# ---------------------------------------------------------------------------

_FRAME_SAMPLER = None


def set_frame_sampler(fn) -> None:
    """Install a frame source for video-family tasks: fn(path) -> sequence
    of HxWx3 uint8 frames. The reference decodes videos with decord
    (e.g. evaluate/lmms_eval/tasks/videomme/utils.py); offline, tests and
    pipelines supply frames directly (synthetic, or pre-extracted)."""
    global _FRAME_SAMPLER
    _FRAME_SAMPLER = fn


def _default_frame_sampler(path):
    """Images-from-frames default: a directory of image files (sorted) or
    an .npy [N, H, W, 3] array acts as the 'video'."""
    import os

    import numpy as np
    if str(path).endswith(".npy"):
        return list(np.load(path))
    if os.path.isdir(path):
        from PIL import Image
        frames = []
        for name in sorted(os.listdir(path)):
            if name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                frames.append(np.asarray(
                    Image.open(os.path.join(path, name)).convert("RGB")))
        if frames:
            return frames
    raise RuntimeError(
        f"no frame source for {path!r}: real video decoding is "
        "unavailable offline — pass a frame directory/.npy, or install "
        "a sampler via eval.lmms_compat.set_frame_sampler")


class _FrameBatch:
    def __init__(self, arr):
        self._arr = arr

    def asnumpy(self):
        return self._arr


class _frame_sampler_video_reader:
    """decord.VideoReader stand-in backed by the pluggable frame sampler:
    supports len(), get_avg_fps(), get_batch(indices).asnumpy() — the
    surface the reference video tasks use."""

    def __init__(self, path, *args, **kwargs):
        import numpy as np
        sampler = _FRAME_SAMPLER or _default_frame_sampler
        self._frames = np.stack([np.asarray(f) for f in sampler(path)])

    def __len__(self):
        return len(self._frames)

    def get_avg_fps(self):
        return 1.0

    def get_batch(self, indices):
        import numpy as np
        idx = np.asarray(indices, np.int64) % len(self._frames)
        return _FrameBatch(self._frames[idx])


class _Filter:
    """lmms_eval.api.filter.Filter protocol: apply(resps, docs)."""

    def __init__(self, *args, **kwargs):
        pass

    def apply(self, resps, docs):
        return resps


class _WhitespaceFilter(_Filter):
    def apply(self, resps, docs):
        return [[r[1:] if r.startswith(" ") else r for r in inst]
                for inst in resps]


class _RegexFilter(_Filter):
    def __init__(self, regex_pattern=r"#### (\-?[0-9\.\,]+)",
                 group_select=0, fallback="[invalid]"):
        self.regex_pattern = regex_pattern
        self.regex = re.compile(regex_pattern)
        self.group_select = group_select
        self.fallback = fallback

    def _one(self, resp):
        match = self.regex.findall(resp)
        if match:
            match = match[self.group_select]
            if isinstance(match, tuple):
                match = [m for m in match if m][0]
            return match.strip()
        return self.fallback

    def apply(self, resps, docs):
        return [[self._one(r) for r in inst] for inst in resps]


class _ExtendedRegexFilter(_RegexFilter):
    punct_tbl = dict.fromkeys(
        i for i in range(sys.maxunicode)
        if unicodedata.category(chr(i)).startswith("P"))

    def __init__(self, regex_pattern=r"#### (\-?[0-9\.\,]+)",
                 group_select=0, fallback="[invalid]", ignore_case=False,
                 ignore_punctuation=False, regexes_to_ignore=None):
        super().__init__(regex_pattern, group_select, fallback)
        self.ignore_case = ignore_case
        self.ignore_punctuation = ignore_punctuation
        self.regexes_to_ignore = regexes_to_ignore

    def filter_ignores(self, st):
        if self.regexes_to_ignore is not None:
            for s in self.regexes_to_ignore:
                st = re.sub(s, "", st)
        if self.ignore_case:
            st = st.lower()
        if self.ignore_punctuation:
            st = st.translate(self.punct_tbl)
        return st

    def find_match(self, regex, resp, convert_dict={}):
        match = regex.findall(resp)
        if match:
            match = match[self.group_select]
            if isinstance(match, tuple):
                match = [m for m in match if m][0]
            match = match.strip()
            if match and match in convert_dict:
                match = convert_dict[match]
        return match


class _MapFilter(_Filter):
    def __init__(self, mapping_dict=None, default_value=None):
        self.mapping_dict = mapping_dict or {}
        self.default_value = default_value

    def apply(self, resps, docs):
        return [[self.mapping_dict.get(r, self.default_value)
                 for r in inst] for inst in resps]


class _LowercaseFilter(_Filter):
    def apply(self, resps, docs):
        return [[r.lower() for r in inst] for inst in resps]


class _UppercaseFilter(_Filter):
    def apply(self, resps, docs):
        return [[r.upper() for r in inst] for inst in resps]


class _TasksRootFinder:
    """Meta-path finder resolving `lmms_eval.tasks.<dir>.<mod>` imports to
    .py files under a registered reference tasks root, so task utils that
    import SIBLING modules (e.g. mmbench_evals next to mmbench's yaml)
    work unmodified."""

    def __init__(self):
        self.roots = []

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith("lmms_eval.tasks."):
            return None
        parts = fullname.split(".")[2:]
        import importlib.util
        from pathlib import Path
        for root in self.roots:
            p = Path(root).joinpath(*parts)
            if p.with_suffix(".py").exists():
                return importlib.util.spec_from_file_location(
                    fullname, p.with_suffix(".py"))
            if p.is_dir():
                init = p / "__init__.py"
                if init.exists():
                    spec = importlib.util.spec_from_file_location(
                        fullname, init,
                        submodule_search_locations=[str(p)])
                    return spec
                import importlib.machinery
                spec = importlib.machinery.ModuleSpec(
                    fullname, None, is_package=True)
                spec.submodule_search_locations = [str(p)]
                return spec
        return None


_TASKS_FINDER = _TasksRootFinder()


def register_tasks_root(root) -> None:
    """Make `lmms_eval.tasks.*` imports resolve under `root` (the
    directory holding the reference's per-task folders)."""
    ensure_lmms_compat()
    root = str(root)
    if root not in _TASKS_FINDER.roots:
        _TASKS_FINDER.roots.append(root)
    if _TASKS_FINDER not in sys.meta_path:
        sys.meta_path.append(_TASKS_FINDER)


def _install_pycocoevalcap():
    """Caption-metric stand-ins backed by this framework's CIDEr-D and a
    standard corpus BLEU; Meteor/Spice (Java-backed in the real package)
    report 0 with a warning. Interface: scorer.compute_score(gts, res)
    with {id: [captions]} dicts, like pycocoevalcap."""
    import math
    from collections import Counter

    from .vqa_metrics import _caption_tokens, cider_d

    def _pairs(gts, res):
        return [(res[k][0], gts[k]) for k in res]

    class Cider:
        def method(self):
            return "CIDEr"

        def compute_score(self, gts, res):
            items = _pairs(gts, res)
            score = cider_d(items)
            return score, [score] * len(items)

    class Bleu:
        def __init__(self, n=4):
            self.n = n

        def method(self):
            return "Bleu"

        def compute_score(self, gts, res):
            # corpus BLEU-1..n with brevity penalty
            scores = []
            for n in range(1, self.n + 1):
                match, total, clen, rlen = 0, 0, 0, 0
                for cand, refs in _pairs(gts, res):
                    c = _caption_tokens(cand)
                    rs = [_caption_tokens(r) for r in refs]
                    cg = Counter(tuple(c[i:i + n])
                                 for i in range(len(c) - n + 1))
                    mx = Counter()
                    for r in rs:
                        rg = Counter(tuple(r[i:i + n])
                                     for i in range(len(r) - n + 1))
                        for g, ct in rg.items():
                            mx[g] = max(mx[g], ct)
                    match += sum(min(ct, mx[g]) for g, ct in cg.items())
                    total += max(sum(cg.values()), 0)
                    clen += len(c)
                    rlen += min((abs(len(r) - len(c)), len(r))
                                for r in rs)[1] if rs else 0
                p = match / total if total else 0.0
                bp = 1.0 if clen > rlen else math.exp(
                    1 - rlen / max(clen, 1))
                scores.append(bp * p)
            return scores, [scores] * len(res)

    class _Zero:
        def __init__(self, name):
            self._name = name

        def method(self):
            return self._name

        def compute_score(self, gts, res):
            import warnings
            warnings.warn(f"{self._name} needs the Java-backed "
                          "pycocoevalcap; reporting 0")
            return 0.0, [0.0] * len(res)

    class PTBTokenizer:
        def tokenize(self, captions):
            return {k: [" ".join(_caption_tokens(c["caption"]
                                 if isinstance(c, dict) else c))
                        for c in v] for k, v in captions.items()}

    class COCOEvalCap:
        def __init__(self, coco=None, coco_res=None):
            self.coco = coco
            self.cocoRes = coco_res
            self.eval = {}
            self.params = {"image_id": []}

        def evaluate(self):
            gts = getattr(self.coco, "imgToAnns", {})
            res = getattr(self.cocoRes, "imgToAnns", {})
            tok = PTBTokenizer()
            gts = tok.tokenize(gts)
            res = tok.tokenize(res)
            for scorer, name in ((Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3",
                                            "Bleu_4"]),
                                 (Cider(), "CIDEr")):
                score, _ = scorer.compute_score(gts, res)
                if isinstance(name, list):
                    for n, s in zip(name, score):
                        self.eval[n] = s
                else:
                    self.eval[name] = score

    pkg = _module("pycocoevalcap")
    ev = _module("pycocoevalcap.eval")
    ev.COCOEvalCap = COCOEvalCap
    ev.Bleu, ev.Cider = Bleu, Cider
    ev.Meteor = lambda: _Zero("METEOR")
    ev.Rouge = lambda: _Zero("ROUGE_L")
    ev.Spice = lambda: _Zero("SPICE")
    tok_pkg = _module("pycocoevalcap.tokenizer")
    ptb = _module("pycocoevalcap.tokenizer.ptbtokenizer")
    ptb.PTBTokenizer = PTBTokenizer
    tok_pkg.ptbtokenizer = ptb
    pkg.eval = ev
    pkg.tokenizer = tok_pkg

    if not _have("pycocotools"):
        import json as _json

        class COCO:
            def __init__(self, annotation_file=None):
                self.imgToAnns = {}
                if annotation_file:
                    data = _json.loads(open(annotation_file).read())
                    for ann in data.get("annotations", []):
                        self.imgToAnns.setdefault(
                            ann["image_id"], []).append(ann)

            def loadRes(self, res_file):
                other = COCO()
                data = _json.loads(open(res_file).read())
                for ann in data:
                    other.imgToAnns.setdefault(
                        ann["image_id"], []).append(ann)
                return other

            def getImgIds(self):
                return list(self.imgToAnns)

        pct = _module("pycocotools")
        pcoco = _module("pycocotools.coco")
        pcoco.COCO = COCO
        pct.coco = pcoco


def _install_hf_evaluate():
    """`evaluate.load("exact_match"|"accuracy")` backed by our metrics."""
    from .metrics import exact_match

    class _Metric:
        def __init__(self, name):
            self.name = name

        def compute(self, predictions=None, references=None, **kw):
            preds = list(predictions or [])
            refs = list(references or [])
            if self.name == "exact_match":
                vals = [exact_match(str(p), str(r), **{
                    k: v for k, v in kw.items()
                    if k in ("ignore_case", "ignore_punctuation")})
                    for p, r in zip(preds, refs)]
                return {"exact_match": sum(vals) / max(len(vals), 1)}
            if self.name == "accuracy":
                vals = [float(p == r) for p, r in zip(preds, refs)]
                return {"accuracy": sum(vals) / max(len(vals), 1)}
            raise NotImplementedError(self.name)

    mod = _module("evaluate")
    mod.load = lambda name, **kw: _Metric(name)


def ensure_lmms_compat() -> None:
    """Install the shims (idempotent; no-op where real packages exist)."""
    if not _have("loguru"):
        import logging
        loguru = _module("loguru")
        loguru.logger = logging.getLogger("lmms_eval_compat")
    if not _have("pycocoevalcap"):
        _install_pycocoevalcap()
    if not _have("evaluate"):
        _install_hf_evaluate()
    # import-only stubs: GPT-judge and video tasks can LOAD their configs
    # offline; the client constructs but any API call raises clearly
    import os
    os.environ.setdefault(
        "HF_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                "huggingface"))
    if not _have("openai"):
        mod = _module("openai")

        class _LazyUnavailable:
            """Constructs fine (module-level clients are common); every
            attribute access / call raises with a clear message."""

            def __init__(self, *a, **k):
                pass

            def __getattr__(self, name):
                raise RuntimeError(
                    "openai is unavailable offline; this task's "
                    "GPT-judge scoring needs it (config loading is fine)")

            def __call__(self, *a, **k):
                raise RuntimeError("openai is unavailable offline")

        mod.OpenAI = _LazyUnavailable
        mod.AzureOpenAI = _LazyUnavailable
        mod.Client = _LazyUnavailable
        mod.api_key = ""
        mod.api_base = ""
    if not _have("decord"):
        mod = _module("decord")
        mod.VideoReader = _frame_sampler_video_reader
        mod.cpu = lambda *a, **k: None
        mod.gpu = lambda *a, **k: None
        mod.bridge = types.SimpleNamespace(set_bridge=lambda *a, **k: None)
    if not _have("spacy"):
        # vcr_wiki tokenization (tasks/vcr_wiki/utils.py:8-41,88-99): the
        # tasks only use `[t.text for t in nlp(text)]`, so a light
        # tokenizer (wordpunct for en, per-character for zh) is a faithful
        # offline stand-in.
        import re as _re
        mod = _module("spacy")

        class _Tok:
            __slots__ = ("text",)

            def __init__(self, t):
                self.text = t

        def _load(name, *a, **k):
            zh = name.startswith("zh")

            def nlp(text):
                if zh:
                    return [_Tok(c) for c in text if not c.isspace()]
                return [_Tok(t) for t in
                        _re.findall(r"\w+|[^\w\s]", text)]
            return nlp

        mod.load = _load
        cli = _module("spacy.cli")
        cli.download = lambda *a, **k: None
        mod.cli = cli
    if not _have("anls"):
        # conbench (tasks/conbench/utils.py:3): pip `anls`'s anls_score ->
        # our registered ANLS metric (eval/metrics.py)
        from .metrics import anls as _anls_metric
        mod = _module("anls")

        def anls_score(prediction="", gold_labels=(), threshold=0.5):
            return _anls_metric(prediction, list(gold_labels), threshold)
        mod.anls_score = anls_score
    if not _have("zss"):
        # synthdog tree-edit-distance accuracy
        # (tasks/synthdog/donut_evaluator.py:16-21): real Zhang-Shasha,
        # not a stub — the task runs fully offline.
        from . import zss_compat
        sys.modules["zss"] = zss_compat
    if not _have("capture_metric"):
        # detailcaps CAPTURE metric needs a parser model download; config
        # loading works, scoring raises clearly offline.
        mod = _module("capture_metric")
        cap = _module("capture_metric.capture")

        class CAPTURE:
            def compute_score(self, *a, **k):
                raise RuntimeError(
                    "CAPTURE metric needs its parser model (offline "
                    "n/a); detailcaps' other metrics still work")
        cap.CAPTURE = CAPTURE
        mod.capture = cap
    if not _have("reka"):
        # vibe_eval judge client (tasks/vibe_eval/utils.py:7-8)
        mod = _module("reka")

        class ChatMessage:
            def __init__(self, *a, **k):
                self.__dict__.update(k)
        mod.ChatMessage = ChatMessage
        client = _module("reka.client")

        class Reka:
            def __init__(self, *a, **k):
                pass

            def __getattr__(self, name):
                raise RuntimeError(
                    "reka API is unavailable offline; vibe_eval's judge "
                    "scoring needs it (config loading is fine)")
        client.Reka = Reka
        mod.client = client

    if _have("lmms_eval"):
        return

    root = _module("lmms_eval")
    root.__path__ = []
    api = _module("lmms_eval.api")
    api.__path__ = []
    api_filter = _module("lmms_eval.api.filter")
    api_filter.Filter = _Filter
    api.filter = api_filter
    api_metrics = _module("lmms_eval.api.metrics")

    def levenshtein_distance(a, b):
        from .metrics import _levenshtein
        return _levenshtein(a, b)

    api_metrics.levenshtein_distance = levenshtein_distance
    api.metrics = api_metrics
    root.api = api

    tasks = _module("lmms_eval.tasks")
    tasks.__path__ = []
    tutils = _module("lmms_eval.tasks._task_utils")
    tutils.__path__ = []
    file_utils = _module("lmms_eval.tasks._task_utils.file_utils")

    def generate_submission_file(file_name, args, subpath="submissions"):
        import os
        out = getattr(args, "output_path", None) or "./"
        path = os.path.join(out, subpath)
        os.makedirs(path, exist_ok=True)
        return os.path.abspath(os.path.join(path, file_name))

    file_utils.generate_submission_file = generate_submission_file

    vqa_metric = _module("lmms_eval.tasks._task_utils.vqa_eval_metric")

    from .vqa_metrics import (
        normalize_vqa_answer,
        process_digit_article,
        process_punctuation,
    )

    class EvalAIAnswerProcessor:
        def __init__(self, *a, **k):
            pass

        def word_tokenize(self, word):
            word = word.lower()
            word = word.replace(",", "").replace("?", "") \
                .replace("'s", " 's")
            return word.strip()

        def process_punctuation(self, s):
            return process_punctuation(s)

        def process_digit_article(self, s):
            return process_digit_article(s)

        def __call__(self, item):
            return normalize_vqa_answer(item)

    vqa_metric.EvalAIAnswerProcessor = EvalAIAnswerProcessor
    tutils.file_utils = file_utils
    tutils.vqa_eval_metric = vqa_metric
    tasks._task_utils = tutils
    root.tasks = tasks

    filters = _module("lmms_eval.filters")
    extraction = _module("lmms_eval.filters.extraction")
    extraction.WhitespaceFilter = _WhitespaceFilter
    extraction.RegexFilter = _RegexFilter
    extraction.ExtendedRegexFilter = _ExtendedRegexFilter
    extraction.MultiChoiceRegexFilter = _ExtendedRegexFilter
    extraction.SimpleMultiChoiceRegexFilter = _ExtendedRegexFilter
    transformation = _module("lmms_eval.filters.transformation")
    transformation.MapFilter = _MapFilter
    transformation.LowercaseFilter = _LowercaseFilter
    transformation.UppercaseFilter = _UppercaseFilter
    filters.extraction = extraction
    filters.transformation = transformation
    root.filters = filters
