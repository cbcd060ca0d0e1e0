"""Parity of the port's eval harness with the JAX package where no model
runs: metrics and stderrs, the collator, task yaml loading through the
`lmms_eval` stand-ins, few-shot contexts and filters, the rank split and
its padding, the built-in task registrations, and the offline tools
(`lite`, `live_bench`).

Each case feeds the same seeded inputs to `competesmoe_tpu.eval` and to
`competesmoe_tpu_torch.eval`; results must be equal (floats bit for bit:
both sides run the same Python and numpy arithmetic).
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
from PIL import Image

import competesmoe_tpu.eval as jeval
import competesmoe_tpu_torch.eval as teval
from competesmoe_tpu.eval import collator as jcoll
from competesmoe_tpu.eval import evaluator as jevaluator
from competesmoe_tpu.eval import lite as jlite
from competesmoe_tpu.eval import live_bench as jlive
from competesmoe_tpu.eval import metrics as jmetrics
from competesmoe_tpu.eval import task as jtask
from competesmoe_tpu.eval import vqa_metrics as jvqa
from competesmoe_tpu.eval import zss_compat as jzss
from competesmoe_tpu_torch.eval import collator as tcoll
from competesmoe_tpu_torch.eval import evaluator as tevaluator
from competesmoe_tpu_torch.eval import lite as tlite
from competesmoe_tpu_torch.eval import live_bench as tlive
from competesmoe_tpu_torch.eval import metrics as tmetrics
from competesmoe_tpu_torch.eval import task as ttask
from competesmoe_tpu_torch.eval import vqa_metrics as tvqa
from competesmoe_tpu_torch.eval import zss_compat as tzss

# the modules `ensure_lmms_compat` may put in sys.modules
STAND_INS = ("lmms_eval", "loguru", "pycocoevalcap", "pycocotools",
             "evaluate", "openai", "decord", "spacy", "anls", "zss",
             "capture_metric", "reka")


def drop_stand_ins():
    """Forget the `lmms_eval` (and other) stand-ins one package's
    `ensure_lmms_compat` installed, so that the other package installs
    its own: a stand-in is a module without a file, or one registered
    under another name than its own (`zss`)."""
    for key in list(sys.modules):
        if key.split(".")[0] not in STAND_INS:
            continue
        mod = sys.modules[key]
        if getattr(mod, "__file__", None) is None or mod.__name__ != key:
            del sys.modules[key]


def stand_ins_of(package: str):
    """Install `package`'s stand-ins in place of any other's."""
    drop_stand_ins()
    lmms_compat = __import__(f"{package}.eval.lmms_compat",
                             fromlist=["ensure_lmms_compat"])
    lmms_compat.ensure_lmms_compat()
    filt = sys.modules["lmms_eval.filters.extraction"].RegexFilter
    assert filt.__module__ == f"{package}.eval.lmms_compat"
    return lmms_compat


# ---------------------------------------------------------------------------
# 1. metrics
# ---------------------------------------------------------------------------

WORDS = ["a", "the", "cat", "Cat.", "two", "2", "3.5", "3.6", "10,000",
         "dog's", "red", "blue", "yes", "no", "Yes,", "n", "don't",
         "(none)", "42%", "x-ray"]


def battery(seed=0, n=40):
    """Seeded (prediction, targets) pairs over words that take the
    normalizers' branches: articles, numbers, contractions, punctuation,
    case."""
    rng = np.random.default_rng(seed)

    def phrase():
        k = int(rng.integers(1, 4))
        return " ".join(rng.choice(WORDS, k))

    out = []
    for _ in range(n):
        pred = phrase()
        refs = [phrase() for _ in range(int(rng.integers(1, 4)))]
        if rng.random() < 0.3:
            refs[0] = pred
        out.append((pred, refs))
    return out


def _metric_cases():
    return {
        "exact_match": lambda m, v, p, r: m.exact_match(p, r[0]),
        "exact_match_punct": lambda m, v, p, r: m.exact_match(
            p, r[0], ignore_punctuation=True),
        "anls": lambda m, v, p, r: m.anls(p, r),
        "accuracy": lambda m, v, p, r: m.accuracy(p, r[0]),
        "vqa_accuracy": lambda m, v, p, r: v.vqa_accuracy(
            p, (r * 4)[:10]),
        "vqa_normalize": lambda m, v, p, r: v.normalize_vqa_answer(p),
        "relaxed_correctness": lambda m, v, p, r: v.relaxed_correctness(
            p, r[0]),
        "ocrbench": lambda m, v, p, r: m.get_metric("ocrbench_accuracy")(
            p, r),
        "mme_parse": lambda m, v, p, r: m.mme_parse_pred(p),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_metric_matches_jax(name):
    fn = _metric_cases()[name]
    for pred, refs in battery():
        assert fn(tmetrics, tvqa, pred, refs) == \
            fn(jmetrics, jvqa, pred, refs), (name, pred, refs)


def test_corpus_metrics_and_stderrs_match_jax():
    """CIDEr-D and the MME paired aggregation over the whole battery; the
    bootstrap stderr (numpy's generator from its seed) and the pooled
    stderr."""
    items = battery(1)
    assert tvqa.cider_d(items) == jvqa.cider_d(items)
    assert tmetrics.get_aggregation("cider")(
        [tmetrics.cider_item(p, r) for p, r in items]) == \
        jmetrics.get_aggregation("cider")(
            [jmetrics.cider_item(p, r) for p, r in items])
    rng = np.random.default_rng(2)
    mme = [{"category": str(rng.integers(0, 3)),
            "question_id": str(rng.integers(0, 8)),
            "score": float(rng.integers(0, 2))} for _ in range(30)]
    assert tmetrics.agg_mme(mme) == jmetrics.agg_mme(mme)
    for values in (rng.random(17).tolist(),
                   rng.integers(0, 2, 9).astype(float).tolist(), [1.0]):
        for seed in (1234, 7):
            assert tmetrics.bootstrap_stderr(values, 300, seed) == \
                jmetrics.bootstrap_stderr(values, 300, seed)
    errs, sizes = rng.random(4).tolist(), [3, 5, 0, 8]
    assert tmetrics.pooled_stderr(errs, sizes) == \
        jmetrics.pooled_stderr(errs, sizes)
    for name in ("mean", "median", "sum", "perplexity"):
        vals = (-rng.random(6)).tolist()
        assert tmetrics.get_aggregation(name)(vals) == \
            jmetrics.get_aggregation(name)(vals)
    assert sorted(tmetrics.METRIC_REGISTRY) == \
        sorted(jmetrics.METRIC_REGISTRY)
    assert sorted(tmetrics.AGGREGATION_REGISTRY) == \
        sorted(jmetrics.AGGREGATION_REGISTRY)
    assert sorted(tmetrics.FILTER_REGISTRY) == \
        sorted(jmetrics.FILTER_REGISTRY)


def _tree(z, rng, depth=0):
    node = z.Node(str(rng.integers(0, 4)))
    if depth < 3:
        for _ in range(int(rng.integers(0, 3))):
            node.addkid(_tree(z, rng, depth + 1))
    return node


def test_zss_distance_matches_jax():
    """Zhang-Shasha over seeded random trees, unit and label costs."""
    for seed in range(12):
        pair = {}
        for key, z in (("jax", jzss), ("port", tzss)):
            rng = np.random.default_rng(seed)
            pair[key] = (_tree(z, rng), _tree(z, rng))
        for kw in ({}, {"update_cost": lambda a, b: 2 * (a.label
                                                         != b.label)}):
            assert tzss.distance(*pair["port"], **kw) == \
                jzss.distance(*pair["jax"], **kw)
        assert tzss.simple_distance(*pair["port"]) == \
            jzss.simple_distance(*pair["jax"])


# ---------------------------------------------------------------------------
# 2. the collator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_collator_matches_jax(batch_size):
    rng = np.random.default_rng(batch_size)
    reqs = ["x" * int(n) for n in rng.integers(1, 6, 11)]
    out = {}
    for key, mod in (("jax", jcoll), ("port", tcoll)):
        c = mod.Collator(reqs, sort_fn=lambda r: -len(r),
                         batch_size=batch_size)
        chunks = [list(ch) for ch in c]
        flat = [f"{i}:{r}" for i, r in enumerate(x for ch in chunks
                                                 for x in ch)]
        out[key] = (chunks, c.get_original(flat))
    assert out["port"] == out["jax"]
    assert [r.split(":")[1] for r in out["port"][1]] == reqs


# ---------------------------------------------------------------------------
# 3. task yaml loading through the lmms_eval stand-ins
# ---------------------------------------------------------------------------

UTILS = '''
import json
from lmms_eval.filters.extraction import RegexFilter
from lmms_eval.filters.transformation import MapFilter
from lmms_eval.tasks._task_utils.file_utils import generate_submission_file


def doc_to_text(doc, kwargs):
    return kwargs.get("pre", "") + doc["q"] + kwargs.get("post", "")


def doc_to_target(doc):
    return doc["a"]


def process_results(doc, results):
    got = RegexFilter(r"answer: (\\w+)", fallback="none").apply(
        [results], None)[0][0]
    mapped = MapFilter({"yes": 1.0, "no": 0.0}, 0.5).apply(
        [[got]], None)[0][0]
    args = type("Args", (), {"output_path": OUT})()
    path = generate_submission_file(f"sub_{doc['id']}.json", args)
    with open(path, "w") as f:
        json.dump({"got": got}, f)
    return {"exact": float(got == doc["a"]), "mapped": mapped}
'''


def _write_yaml_task(tmp_path, name):
    d = tmp_path / "tasks" / name
    d.mkdir(parents=True)
    (d / "utils.py").write_text(
        UTILS.replace("OUT", repr(str(tmp_path / f"out_{name}"))))
    rng = np.random.default_rng(3)
    docs = [{"id": i, "q": f"question {i} {'yes' if i % 2 else 'no'}",
             "a": ["yes", "no"][int(rng.integers(0, 2))]} for i in range(8)]
    (d / "_template.yaml").write_text(
        "output_type: generate_until\n"
        "generation_kwargs:\n  max_new_tokens: 4\n"
        "filter_list:\n  - filter: strip\n")
    lines = [f"task: {name}", "include: _template.yaml",
             "doc_to_text: !function utils.doc_to_text",
             "doc_to_target: !function utils.doc_to_target",
             "process_results: !function utils.process_results",
             "num_fewshot: 2", "fewshot_seed: 11",
             "model_specific_prompt_kwargs:",
             "  default:", "    pre: 'Q: '", "    post: ' A:'",
             "metric_list:", "  - metric: exact", "    aggregation: mean",
             "    higher_is_better: true",
             "  - metric: mapped", "    aggregation: mean",
             "docs: " + json.dumps(docs)]
    (d / f"{name}.yaml").write_text("\n".join(lines) + "\n")
    return d / f"{name}.yaml"


def _run_yaml_task(package, path):
    mod = jtask if package == "competesmoe_tpu" else ttask
    stand_ins_of(package)
    cfg = mod.load_task_yaml(path)
    assert mod.get_task_config(cfg.task) is cfg
    task = mod.ConfigurableTask(cfg)
    insts = task.build_all_requests()
    rng = np.random.default_rng(5)
    for inst in insts:
        inst.resps.append(f"  answer: {['yes', 'no', 'maybe'][int(rng.integers(0, 3))]}  ")
    task.apply_filters()
    scores = task.score()
    return dict(docs=task.docs, contexts=[i.arguments[0] for i in insts],
                fewshot=[task.fewshot_context(d) for d in range(3)],
                args=[i.arguments[1:] for i in insts],
                filtered=[i.filtered_resps["default"] for i in insts],
                sample_scores=task.sample_scores, scores=scores)


def test_task_yaml_loading_matches_jax(tmp_path):
    """A yaml with include, !function hooks (one taking the prompt
    kwargs), few-shot and a filter, whose utils.py imports the stand-ins'
    RegexFilter, MapFilter and generate_submission_file: docs, contexts,
    few-shot contexts, filtered responses and scores equal JAX's, and
    both write the same submission files."""
    want = _run_yaml_task("competesmoe_tpu",
                          _write_yaml_task(tmp_path, "yaml_jax"))
    got = _run_yaml_task("competesmoe_tpu_torch",
                         _write_yaml_task(tmp_path, "yaml_port"))
    drop_stand_ins()
    assert got == want
    assert want["contexts"][0].endswith("Q: question 0 no A:")
    assert want["fewshot"][0].count("\n\n") == 2
    for i in range(8):
        a = json.loads((tmp_path / "out_yaml_jax" / "submissions"
                        / f"sub_{i}.json").read_text())
        b = json.loads((tmp_path / "out_yaml_port" / "submissions"
                        / f"sub_{i}.json").read_text())
        assert a == b


def test_stand_ins_match_jax(tmp_path):
    """The stand-ins' own surface: filters, the VQA answer processor,
    caption scorers, the frame reader, zss and anls."""
    outs = {}
    for package in ("competesmoe_tpu", "competesmoe_tpu_torch"):
        compat = stand_ins_of(package)
        from lmms_eval.filters.extraction import (ExtendedRegexFilter,
                                                  WhitespaceFilter)
        from lmms_eval.filters.transformation import (LowercaseFilter,
                                                      UppercaseFilter)
        from lmms_eval.tasks._task_utils.vqa_eval_metric import (
            EvalAIAnswerProcessor)
        from pycocoevalcap.eval import Bleu, Cider
        import anls
        import decord
        import zss
        frames = np.random.default_rng(0).integers(
            0, 255, (5, 6, 6, 3)).astype(np.uint8)
        compat.set_frame_sampler(lambda path: list(frames))
        vr = decord.VideoReader("clip.mp4")
        gts = {k: refs for k, (_, refs) in enumerate(battery(4, 10))}
        res = {k: [p] for k, (p, _) in enumerate(battery(4, 10))}
        erf = ExtendedRegexFilter(r"(\w+)", ignore_case=True,
                                  ignore_punctuation=True)
        outs[package] = dict(
            ws=WhitespaceFilter().apply([[" a", "b "]], None),
            case=(LowercaseFilter().apply([["Ab"]], None),
                  UppercaseFilter().apply([["Ab"]], None)),
            ext=[erf.filter_ignores(p) for p, _ in battery(5, 10)],
            proc=[EvalAIAnswerProcessor()(p) for p, _ in battery(6, 10)],
            cider=Cider().compute_score(gts, res),
            bleu=Bleu(4).compute_score(gts, res),
            frames=(len(vr), vr.get_batch([0, 3, 7]).asnumpy().tolist()),
            anls=anls.anls_score("cat", ["cat", "cats"]),
            zss=zss.simple_distance(zss.Node("a").addkid(zss.Node("b")),
                                    zss.Node("a")))
        compat.set_frame_sampler(None)
    drop_stand_ins()
    assert outs["competesmoe_tpu_torch"] == outs["competesmoe_tpu"]


# ---------------------------------------------------------------------------
# 8. the rank split and its padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world_size", [2, 3])
def test_rank_split_and_padding_match_jax(world_size):
    docs = [{"q": f"q{i}", "a": "x"} for i in range(7)]
    out = {}
    for key, tmod, emod in (("jax", jtask, jevaluator),
                            ("port", ttask, tevaluator)):
        per_rank = []
        for rank in range(world_size):
            task = tmod.ConfigurableTask(tmod.TaskConfig(
                task="pad_toy", doc_to_text=lambda d: d["q"],
                doc_to_target=lambda d: d["a"], docs=docs))
            insts = task.build_all_requests(rank=rank,
                                            world_size=world_size)
            pads = emod.pad_uneven_ranks(task, insts, rank, world_size)
            per_rank.append(([(i.doc_id, i.arguments, i.padded)
                              for i in insts],
                             [(p.doc_id, p.arguments, p.padded, p.resps)
                              for p in pads]))
        out[key] = per_rank
    assert out["port"] == out["jax"]
    sizes = {len(a) + len(b) for a, b in out["port"]}
    assert sizes == {-(-7 // world_size)}


# ---------------------------------------------------------------------------
# the built-in task registrations
# ---------------------------------------------------------------------------

def _plain_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if not callable(getattr(cfg, f.name))}


def test_builtin_tasks_match_jax():
    from competesmoe_tpu.eval import tasks_builtin as jb  # noqa: F401
    from competesmoe_tpu_torch.eval import tasks_builtin as tb  # noqa: F401
    names = sorted(n for n in jtask.TASK_REGISTRY
                   if jtask.TASK_REGISTRY[n].dataset_path)
    assert len(names) > 20
    for name in names:
        assert _plain_fields(ttask.get_task_config(name)) == \
            _plain_fields(jtask.get_task_config(name)), name
    docs = {"mmbench_en_dev": {"question": "Which?", "hint": "Look.",
                               "A": "cat", "B": "dog", "C": "", "D": None,
                               "answer": "A"},
            "mmmu_val": {"question": "What is <image 1>?",
                         "options": "['a', 'b']", "answer": "B"},
            "seedbench": {"question": "Q?", "choice_a": "1",
                          "choice_b": "2", "choice_c": "3",
                          "choice_d": "4", "answer": "C"},
            "ai2d": {"answer": "2", "question": "Q", "options": ["x", "y",
                                                               "z"]},
            "mathvista_testmini": {"query": "solve", "answer": "3"},
            "pope": {"question": "Is there a cat?", "answer": "yes"}}
    for name, doc in docs.items():
        for hook in ("doc_to_text", "doc_to_target"):
            j = getattr(jtask.get_task_config(name), hook)
            t = getattr(ttask.get_task_config(name), hook)
            assert (t(doc) if t else None) == (j(doc) if j else None), \
                (name, hook)


# ---------------------------------------------------------------------------
# 11. the offline tools
# ---------------------------------------------------------------------------

def test_lite_picks_the_same_indices(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 6)).astype(np.float32)
    for n, start in ((1, 0), (7, 0), (12, 5), (60, 3)):
        assert tlite.kcenter_greedy(X, n, start).tolist() == \
            jlite.kcenter_greedy(X, n, start).tolist()
    docs = [{"q": f"word{i} " * (i % 5 + 1),
             "img": Image.new("RGB", (8, 8), (i * 9 % 255, 40, 200))}
            for i in range(20)]
    assert np.array_equal(tlite.hashed_bow_embedder()(docs[3]),
                          jlite.hashed_bow_embedder()(docs[3]))
    for frac in (0.25, 6):
        assert tlite.shrink_task("t", frac, docs=docs) == \
            jlite.shrink_task("t", frac, docs=docs)
    cfg = dict(task="lite_port_toy", doc_to_text=lambda d: d["q"],
               doc_to_target=lambda d: "", docs=docs)
    jeval.register_task("lite_port_toy", jeval.TaskConfig(**cfg))
    teval.register_task("lite_port_toy", teval.TaskConfig(**cfg))
    jlite.main(["--tasks", "lite_port_toy", "--num_items", "5",
                "--output_path", str(tmp_path / "jax")])
    tlite.main(["--tasks", "lite_port_toy", "--num_items", "5",
                "--output_path", str(tmp_path / "port")])
    assert (tmp_path / "port" / "lite_port_toy_lite.json").read_text() == \
        (tmp_path / "jax" / "lite_port_toy_lite.json").read_text()


def test_live_bench_builds_the_same_dataset(tmp_path):
    shots = tmp_path / "shots"
    shots.mkdir()
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(((64, 32), (32, 64), (48, 48), (40, 30))):
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        arr[..., i % 3] = 250
        Image.fromarray(arr).save(shots / f"{i}.png")
    (shots / "notes.txt").write_text("not an image")
    out = {}
    for key, mod in (("jax", jlive), ("port", tlive)):
        bench = mod.LiveBench(name="t")
        logs = bench.capture(mod.load_websites_from_file(shots))
        path = bench.save(tmp_path / key)
        data = json.loads(path.read_text())
        for row in data["rows"]:
            assert set(row) == set(mod.COLUMNS)
            row.pop("date_time")
        imgs = sorted(p.name for p in (tmp_path / key / "images").iterdir())
        out[key] = (logs, data, imgs, mod.COLUMNS)
    assert out["port"] == out["jax"]
    assert len(out["port"][1]["rows"]) == 12 and len(tlive.COLUMNS) == 15
    with pytest.raises(RuntimeError):
        tlive.load_websites()
    with pytest.raises(RuntimeError):
        tlive.GENERATORS["gpt4v"](None)
    tlive.main(["--images", str(shots), "--out", str(tmp_path / "cli"),
                "--name", "cli"])
    assert (tmp_path / "cli" / "live_bench_cli.json").exists()


def test_distributed_env_matches_jax(monkeypatch):
    from competesmoe_tpu.parallel import distributed as jdist
    from competesmoe_tpu_torch.parallel import distributed as tdist
    envs = [{},
            {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
             "MASTER_ADDR": "h0", "MASTER_PORT": "2222"},
            {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
             "SLURM_JOB_NODELIST": "node[01-04],x", "SLURM_RESTART_COUNT":
             "2"}]
    for env in envs:
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
                  "SLURM_LOCALID", "SLURM_JOB_NODELIST",
                  "SLURM_RESTART_COUNT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert dataclasses.asdict(tdist.detect_env()) == \
            dataclasses.asdict(jdist.detect_env())
        assert tdist.detect_env().is_master == jdist.detect_env().is_master


def test_cache_keys_match_jax():
    from competesmoe_tpu.eval import cache as jcache
    from competesmoe_tpu_torch.eval import cache as tcache
    img = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    for args in (("hello", {"max_new_tokens": 2}, []),
                 ("what", "yes", [img])):
        assert tcache._key("generate_until", args) == \
            jcache._key("generate_until", args)


def test_results_logger_matches_jax(tmp_path):
    from competesmoe_tpu.eval.logging_utils import EvalResultsLogger as J
    from competesmoe_tpu_torch.eval.logging_utils import (
        EvalResultsLogger as T)
    results = {"results": {"t": {"acc": 0.5, "acc_stderr": 0.1}},
               "groups": {}, "samples": {"t": [{"doc_id": 0}]},
               "time_inference": {"total_s": 1.0}}
    paths = [cls(tmp_path / key).log_results(results, log_samples=True)
             for key, cls in (("jax", J), ("port", T))]
    assert paths[0].read_text() == paths[1].read_text()
