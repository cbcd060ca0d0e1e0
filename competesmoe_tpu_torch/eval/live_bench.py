"""LiveBench dataset generator — offline-first rebuild.

Reference: `evaluate/tools/live_bench/` (create_dataset.py +
data_generator/live_bench.py:48-163). The reference pipeline is
websites -> selenium screenshots -> GPT-4V question generation ->
Gemini checking -> GPT-4V scoring -> HF dataset; its snapshot ships only
the orchestrator (the qa_generator/score_getter/websites leaf modules
are absent) and every stage needs live web + API keys.

This rebuild keeps the reference's pipeline shape and dataset schema
(the same 15 columns, LiveBenchData.features) behind REGISTRIES so the
online stages plug in where keys/network exist, and ships offline
defaults for every stage:

  shoter    'human'      local image files (the reference's own offline
                         entry, create_dataset.py:11 load_websites_from_
                         file + screen_shoter='human')
  generator 'template'   deterministic image-derived QA (dominant color,
                         orientation, brightness) — no API
  checker   'identity'   passes QA through unchanged
  scorer    'constant'   max score with an 'offline' reason, flagged
                         `scorer_name='constant(offline)'` so consumers
                         can tell containment data from GPT-scored data

Beyond the reference: `LiveBench.register_as_task()` registers the
generated dataset as a ready-to-run eval task for `cli/eval_mm.py`.

CLI:  python -m competesmoe_tpu_torch.eval.live_bench --images DIR --out DIR

The port's own copy of competesmoe_tpu/eval/live_bench.py: it imports
neither JAX nor that package, and PIL only inside the functions that
need it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# data records (live_bench_data.LiveBenchData role)
# ---------------------------------------------------------------------------

COLUMNS = ["id", "images", "website", "question", "answer", "criteria",
           "subtask", "data_generator", "checker", "date_time",
           "screen_shoter", "screen_size", "score", "reason",
           "scorer_name"]


@dataclasses.dataclass
class QAData:
    question: str
    answer: str
    criteria: str = ""
    subtask: str = "Basic Understanding"


@dataclasses.dataclass
class ScreenImage:
    """A captured 'website': one or more PIL images + capture
    metadata."""
    images: List[Any]
    website: str
    shoter: str
    screen_size: str


@dataclasses.dataclass
class Website:
    """URL or local image path (websites/website.py role)."""
    path: str

    def get_info(self) -> Dict:
        return {"path": self.path}


def load_websites_from_file(image_dir) -> List[Website]:
    """The reference's offline entry (create_dataset.py:11): every image
    file in the directory becomes one 'website'."""
    image_dir = Path(image_dir)
    exts = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
    return [Website(str(p)) for p in sorted(image_dir.iterdir())
            if p.suffix.lower() in exts]


def load_websites(*_a, **_k) -> List[Website]:
    raise RuntimeError(
        "load_websites() needs live web access (the reference drives "
        "selenium over a curated URL list); this environment is "
        "air-gapped — use load_websites_from_file(image_dir) with "
        "screen_shoter='human', the reference's own offline entry.")


# ---------------------------------------------------------------------------
# pluggable stages (screen_shoter / qa_generator / score_getter roles)
# ---------------------------------------------------------------------------

SHOTERS: Dict[str, Callable] = {}
GENERATORS: Dict[str, Callable] = {}
SCORERS: Dict[str, Callable] = {}


def register_shoter(name):
    def deco(fn):
        SHOTERS[name] = fn
        return fn
    return deco


def register_generator(name):
    def deco(fn):
        GENERATORS[name] = fn
        return fn
    return deco


def register_scorer(name):
    def deco(fn):
        SCORERS[name] = fn
        return fn
    return deco


def _need_api(name):
    def fn(*a, **k):
        raise RuntimeError(
            f"{name} needs a live API key + network; register a real "
            f"implementation via register_generator/register_scorer, or "
            f"use the offline defaults (template/constant).")
    return fn


@register_shoter("human")
def human_shoter(website: Website, **_k) -> ScreenImage:
    """Local image file as the captured screen (the reference's 'human'
    shoter used with load_websites_from_file)."""
    from PIL import Image
    img = Image.open(website.path).convert("RGB")
    return ScreenImage(images=[img], website=website.path,
                       shoter="human", screen_size=f"{img.size}")


@register_shoter("single_screen")
def selenium_shoter(website: Website, **_k) -> ScreenImage:
    raise RuntimeError(
        "the 'single_screen' shoter drives selenium over live web; "
        "air-gapped — use 'human' with local images.")


@register_generator("template")
def template_generator(screen: ScreenImage, **_k) -> List[QAData]:
    """Deterministic image-derived QA — the offline stand-in for the
    GPT-4V generator. Answers are computed from the pixels, so the
    generated dataset is non-trivial to models."""
    img = screen.images[0]
    w, h = img.size
    small = img.resize((32, 32))
    px = list(small.getdata())
    n = len(px)
    means = [sum(c[i] for c in px) / n for i in range(3)]
    color = ["red", "green", "blue"][means.index(max(means))]
    orient = ("landscape" if w > h else
              "portrait" if h > w else "square")
    brightness = "light" if sum(means) / 3 > 127 else "dark"
    return [
        QAData("What is the dominant color channel of the page shown "
               "in the image?", color,
               criteria="Award 10 marks for naming the dominant "
                        "channel, 0 otherwise.",
               subtask="Basic Understanding"),
        QAData("Is the page screenshot in landscape, portrait, or "
               "square orientation?", orient,
               criteria="Award 10 marks for the correct orientation.",
               subtask="Analytical Questions"),
        QAData("Does the page look light or dark overall?", brightness,
               criteria="Award 10 marks for the correct impression.",
               subtask="Basic Understanding"),
    ]


GENERATORS["gpt4v"] = _need_api("gpt4v qa_generator")
GENERATORS["gemini"] = _need_api("gemini checker")
GENERATORS["claude"] = _need_api("claude qa_generator")


@register_scorer("constant")
def constant_scorer(qa: QAData, screen: ScreenImage) -> Dict:
    return {"score": 10, "reason": "offline containment score "
                                   "(no judge API available)"}


SCORERS["gpt4v"] = _need_api("gpt4v scorer")


# ---------------------------------------------------------------------------
# orchestrator (data_generator/live_bench.py:48-163 role)
# ---------------------------------------------------------------------------

class LiveBench:
    """Accumulates generated rows in the reference's column schema;
    save() writes JSON + images (an HF `datasets` layout is one
    Dataset.from_dict away, kept optional so the core path has no heavy
    dependency)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or time.strftime("%Y-%m")
        self.rows: List[Dict] = []
        self._images: List[List[Any]] = []

    def clear(self):
        self.rows, self._images = [], []

    def add(self, row: Dict, images: List[Any]):
        row = dict(row)
        row["id"] = len(self.rows)
        assert set(row) == set(COLUMNS), set(COLUMNS) ^ set(row)
        self.rows.append(row)
        self._images.append(images)

    def capture(self, websites: Sequence[Website], *,
                screen_shoter: str = "human",
                qa_generator: str = "template",
                checker: str = "identity",
                scorer: str = "constant",
                score_threshold: int = 5,
                shoter_kwargs: Optional[Dict] = None,
                generator_kwargs: Optional[Dict] = None) -> List[Dict]:
        """website -> screenshot -> QA -> check -> score -> row; items
        under score_threshold are dropped (live_bench.py:41-44)."""
        shoter = SHOTERS[screen_shoter]
        generator = GENERATORS[qa_generator]
        score_fn = SCORERS[scorer]
        check_fn = (GENERATORS[checker] if checker != "identity"
                    else None)
        logs = []
        for site in websites:
            try:
                screen = shoter(site, **(shoter_kwargs or {}))
                qas = generator(screen, **(generator_kwargs or {}))
                if check_fn is not None:
                    qas = check_fn(screen, qas=qas)
                for qa in qas:
                    scored = score_fn(qa, screen)
                    if score_threshold and scored["score"] < \
                            score_threshold:
                        continue
                    self.add({
                        "id": None,
                        "images": [site.path],
                        "website": screen.website,
                        "question": qa.question,
                        "answer": qa.answer,
                        "criteria": qa.criteria,
                        "subtask": qa.subtask,
                        "data_generator": qa_generator,
                        "checker": checker,
                        "date_time": time.strftime(
                            "%Y-%m-%d %H:%M:%S"),
                        "screen_shoter": screen.shoter,
                        "screen_size": screen.screen_size,
                        "score": scored["score"],
                        "reason": scored["reason"],
                        "scorer_name": f"{scorer}(offline)"
                        if scorer == "constant" else scorer,
                    }, screen.images)
                logs.append({"success": True,
                             "website": site.get_info(),
                             "n_qa": len(qas)})
            except Exception as e:  # noqa: BLE001 — per-site isolation,
                # same containment as the reference loop (:120-137)
                logs.append({"success": False,
                             "website": site.get_info(),
                             "error": str(e)})
        return logs

    def save(self, out_dir) -> Path:
        out_dir = Path(out_dir)
        (out_dir / "images").mkdir(parents=True, exist_ok=True)
        rows = []
        for row, images in zip(self.rows, self._images):
            row = dict(row)
            paths = []
            for j, img in enumerate(images):
                p = out_dir / "images" / f"{row['id']:05d}_{j}.png"
                img.save(p)
                paths.append(str(p.relative_to(out_dir)))
            row["images"] = paths
            rows.append(row)
        (out_dir / f"live_bench_{self.name}.json").write_text(
            json.dumps({"name": self.name, "columns": COLUMNS,
                        "rows": rows}, indent=1))
        return out_dir / f"live_bench_{self.name}.json"

    def register_as_task(self, task_name: Optional[str] = None,
                         max_new_tokens: int = 16):
        """Beyond the reference: make the generated dataset directly
        runnable by the eval harness / cli.eval_mm."""
        from .task import TaskConfig, register_task

        docs = [{**row, "_img": imgs[0]}
                for row, imgs in zip(self.rows, self._images)]
        name = task_name or f"live_bench_{self.name}"
        return register_task(name, TaskConfig(
            task=name, output_type="generate_until",
            doc_to_text=lambda d: (d["question"]
                                   + "\nAnswer the question using a "
                                     "single word or phrase."),
            doc_to_visual=lambda d: [d["_img"]],
            doc_to_target=lambda d: d["answer"],
            generation_kwargs={"max_new_tokens": max_new_tokens},
            metric_list=[{"metric": "exact_match",
                          "aggregation": "mean"}],
            docs=docs))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Generate a LiveBench-format dataset offline from "
                    "local screenshots (create_dataset.py role)")
    ap.add_argument("--images", required=True,
                    help="directory of page screenshots")
    ap.add_argument("--out", required=True)
    ap.add_argument("--name", default=None)
    ap.add_argument("--qa-generator", default="template",
                    choices=sorted(GENERATORS))
    ap.add_argument("--scorer", default="constant",
                    choices=sorted(SCORERS))
    a = ap.parse_args(argv)
    bench = LiveBench(name=a.name)
    logs = bench.capture(load_websites_from_file(a.images),
                         qa_generator=a.qa_generator, scorer=a.scorer)
    path = bench.save(a.out)
    ok = sum(1 for l in logs if l["success"])
    print(json.dumps({"rows": len(bench.rows), "websites_ok": ok,
                      "websites_failed": len(logs) - ok,
                      "dataset": str(path)}))


if __name__ == "__main__":
    main()
