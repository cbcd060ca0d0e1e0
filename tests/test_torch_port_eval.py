"""Parity of the port's evaluation path with the JAX package on the tiny
MoE LLaVA of tests/test_torch_port_models.py (float32; weights from
JAX's init through `convert.from_jax_params`).

One `simple_evaluate` per package runs a battery of toy tasks with
`return_id_experts`: generate_until with and without images mixed in one
batch (batch_size 2), loglikelihood with images and without, a two-task
group, two-shot prompts, the offline-judge fallback and synthetic video
frames through `set_frame_sampler`. Generated texts must be identical,
loglikelihood totals within 1e-4 relative with identical greedy flags,
metrics, stderrs and group aggregates within 1e-9 relative, telemetry
histograms identical with entropies within 1e-5. Then the port alone:
the engine route against the solo route, batched against unbatched
loglikelihood (and against the model's own label splice), the two-rank
merge, the response cache and the engine's failure.
"""

import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import competesmoe_tpu.eval as jeval
import competesmoe_tpu_torch.eval as teval
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.multimodal.mm_utils import (
    ImageProcessorConfig as JProc)
from competesmoe_tpu_torch.constants import IGNORE_INDEX
from competesmoe_tpu_torch.multimodal.mm_utils import (
    ImageProcessorConfig as TProc)
from tests.test_torch_port_eval_offline import stand_ins_of
from tests.test_torch_port_llava import port_model
from tests.test_torch_port_models import _prompt, jax_llava_cfg

LL_RTOL = 1e-4
METRIC_RTOL = 1e-9
ENTROPY_TOL = 1e-5


class HashTok:
    """Word-level tokenizer without state: a word's id is 3 + its crc32
    modulo 61 (the tiny decoder's vocabulary is 64), with bos 1, eos 2 and
    pad 0; phi's `<|...|>` markers are words of their own. It decodes an
    id to `w<id>`, and encodes `w<id>` back to that id."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    _SPLIT = __import__("re").compile(r"<\|[a-z]+\|>|\S+?(?=<\|)|\S+")

    @staticmethod
    def _id(word):
        if word[:1] == "w" and word[1:].isdigit() and 3 <= int(word[1:]) < 64:
            return int(word[1:])
        return 3 + zlib.crc32(word.encode()) % 61

    def __call__(self, text):
        ids = [1] + [self._id(w) for w in self._SPLIT.findall(text)]
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids
                        if not (skip_special_tokens and int(i) < 3))


def image(seed, size=30):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (size, size + 4, 3))
                           .astype(np.uint8))


def frames(path):
    """Synthetic video: 5 frames from a seed taken from the path."""
    rng = np.random.default_rng(zlib.crc32(str(path).encode()))
    return list(rng.integers(0, 255, (5, 20, 24, 3)).astype(np.uint8))


def video_visual(doc):
    import decord
    vr = decord.VideoReader(doc["video"], ctx=decord.cpu(0))
    idx = np.linspace(0, len(vr) - 1, 2).astype(int).tolist()
    return [Image.fromarray(f) for f in vr.get_batch(idx).asnumpy()]


def judge(doc, resps):
    raise RuntimeError("openai is unavailable offline; this task's "
                       "GPT-judge scoring needs it")


def ll_scores(doc, resps):
    ll, greedy = resps[0]
    return {"ll": ll, "greedy": float(greedy)}


WORDS = "what color is this a cat yes red blue shape here count".split()


def question(rng, n):
    return " ".join(rng.choice(WORDS, n))


def ll_docs():
    rng = np.random.default_rng(1)
    return [{"q": question(rng, 3 + i % 3), "a": ["yes", "no red"][i % 2],
             "img": image(10 + i) if i < 3 else None} for i in range(6)]


def greedy_targets(models):
    """Each loglikelihood doc's two greedy tokens (the port's solo route):
    scored as targets, they must come out greedy."""
    reqs = [teval.Instance(request_type="generate_until",
                           arguments=(d["q"], {"max_new_tokens": 2},
                                      [d["img"]] if d["img"] else []),
                           idx=0, metadata=("ll", i, 1))
            for i, d in enumerate(ll_docs())]
    return port_lm(models).generate_until(reqs)


def battery_tasks(mod, targets):
    """Registers the battery's tasks in `mod` (either package's eval);
    every other loglikelihood doc takes its target from `targets`.
    Returns their names."""
    rng = np.random.default_rng(0)
    gen = [{"q": question(rng, 2 + i), "a": f"w{5 + i} w{9 + i}",
            "img": image(i) if i % 2 == 0 else None} for i in range(6)]
    ll = ll_docs()
    for i in range(0, 6, 2):
        if targets[i]:
            ll[i]["a"] = targets[i]
    grp = [{"q": question(rng, 4), "a": "w7 w11", "img": image(20 + i)}
           for i in range(4)]
    fewshot = [{"q": question(rng, 3), "a": question(rng, 1)}
               for _ in range(5)]
    video = [{"video": f"clip_{i}.mp4", "q": "what happens", "a": "w3"}
             for i in range(2)]
    vis = lambda d: [d["img"]] if d["img"] is not None else []  # noqa: E731
    tc = mod.TaskConfig
    # ANLS without its threshold scores every answer by its edit distance
    gen_metrics = [{"metric": "exact_match", "aggregation": "mean"},
                   {"metric": "anls", "aggregation": "mean",
                    "threshold": 0.0}]
    tasks = {
        "pe_gen": tc(task="pe_gen", output_type="generate_until",
                     doc_to_text=lambda d: d["q"], doc_to_visual=vis,
                     doc_to_target=lambda d: d["a"],
                     generation_kwargs={"max_new_tokens": 3},
                     metric_list=gen_metrics, docs=gen),
        "pe_ll": tc(task="pe_ll", output_type="loglikelihood",
                    doc_to_text=lambda d: d["q"], doc_to_visual=vis,
                    doc_to_target=lambda d: d["a"],
                    metric_list=[{"metric": "accuracy",
                                  "aggregation": "mean"}], docs=ll),
        "pe_ll_scores": tc(task="pe_ll_scores",
                           output_type="loglikelihood",
                           doc_to_text=lambda d: d["q"],
                           doc_to_visual=vis,
                           doc_to_target=lambda d: d["a"],
                           process_results=ll_scores, docs=ll),
        "pe_fewshot": tc(task="pe_fewshot", output_type="generate_until",
                         doc_to_text=lambda d: d["q"],
                         doc_to_target=lambda d: d["a"],
                         generation_kwargs={"max_new_tokens": 3},
                         metric_list=gen_metrics, num_fewshot=2,
                         docs=fewshot),
        "pe_judge": tc(task="pe_judge", output_type="generate_until",
                       doc_to_text=lambda d: d["q"], doc_to_visual=vis,
                       doc_to_target=lambda d: d["a"],
                       generation_kwargs={"max_new_tokens": 3},
                       process_results=judge,
                       metric_list=[{"metric": "gpt_eval",
                                     "aggregation": "mean"}],
                       docs=gen[:2]),
        "pe_video": tc(task="pe_video", output_type="generate_until",
                       doc_to_text=lambda d: d["q"],
                       doc_to_visual=video_visual,
                       doc_to_target=lambda d: d["a"],
                       generation_kwargs={"max_new_tokens": 3},
                       metric_list=gen_metrics, docs=video),
    }
    for name in ("pe_grp_a", "pe_grp_b"):
        docs = grp if name.endswith("a") else grp[::-1]
        tasks[name] = tc(task=name, output_type="generate_until",
                         doc_to_text=lambda d: d["q"], doc_to_visual=vis,
                         doc_to_target=lambda d: d["a"],
                         generation_kwargs={"max_new_tokens": 3},
                         metric_list=gen_metrics[1:], group="pe_group",
                         docs=docs)
    for name, cfg in tasks.items():
        mod.register_task(name, cfg)
    return sorted(tasks)


GEN_TASKS = ["pe_gen", "pe_fewshot", "pe_judge", "pe_video", "pe_grp_a",
             "pe_grp_b"]
LL_TASKS = ["pe_ll", "pe_ll_scores"]


@pytest.fixture(scope="module")
def models():
    cfg = jax_llava_cfg()
    ids, px = _prompt()
    params = jllava.LlavaModel(cfg).init(jax.random.PRNGKey(0), ids, px)
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, port_model(cfg, params)


def jax_lm(models, **kw):
    cfg, params, _ = models
    return jeval.JaxLlava(jllava.LlavaModel(cfg), params, HashTok(),
                          JProc(size=28), **{"batch_size": 2,
                                             "max_new_tokens": 3, **kw})


def port_lm(models, **kw):
    return teval.TorchLlava(models[2], HashTok(), TProc(size=28),
                            **{"batch_size": 2, "max_new_tokens": 3, **kw})


@pytest.fixture(scope="module")
def runs(models):
    """The battery through JAX's harness, then through the port's, each
    with its own lmms_eval stand-ins (the video task reads frames through
    the installed `decord`)."""
    out = {"targets": greedy_targets(models)}
    for key, package, mod, make in (
            ("jax", "competesmoe_tpu", jeval, jax_lm),
            ("port", "competesmoe_tpu_torch", teval, port_lm)):
        compat = stand_ins_of(package)
        compat.set_frame_sampler(frames)
        names = battery_tasks(mod, out["targets"])
        lm = make(models)
        try:
            out[key] = mod.simple_evaluate(lm, names,
                                           return_id_experts=True)
        finally:
            compat.set_frame_sampler(None)
        out[key + "_reader"] = __import__("decord").VideoReader.__module__
    return out


@pytest.mark.parametrize("task", GEN_TASKS)
def test_generated_texts_match_jax(runs, task):
    got = [s["resps"] for s in runs["port"]["samples"][task]]
    want = [s["resps"] for s in runs["jax"]["samples"][task]]
    assert got == want
    assert [s["doc_id"] for s in runs["port"]["samples"][task]] == \
        [s["doc_id"] for s in runs["jax"]["samples"][task]]
    assert [s["filtered"] for s in runs["port"]["samples"][task]] == \
        [s["filtered"] for s in runs["jax"]["samples"][task]]


@pytest.mark.parametrize("task", LL_TASKS)
def test_loglikelihood_matches_jax(runs, task):
    got = [s["resps"][0] for s in runs["port"]["samples"][task]]
    want = [s["resps"][0] for s in runs["jax"]["samples"][task]]
    assert len(got) == len(want) == 6
    for (ll, greedy), (ll_j, greedy_j) in zip(got, want):
        assert np.isfinite(ll) and ll < 0
        np.testing.assert_allclose(ll, ll_j, rtol=LL_RTOL)
        assert bool(greedy) == bool(greedy_j)
    # a doc whose target is its own greedy continuation scores greedy
    for i in range(0, 6, 2):
        if runs["targets"][i]:
            assert got[i][1], (i, runs["targets"][i])
    assert sum(runs["targets"][i] != "" for i in range(0, 6, 2)) >= 2


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, bool) or want is None:
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL,
                                   err_msg=path)


@pytest.mark.parametrize("task", GEN_TASKS + LL_TASKS)
def test_task_metrics_match_jax(runs, task):
    """Each task's metrics and bootstrap stderrs; the loglikelihood
    scores within the loglikelihood tolerance (they are the totals)."""
    got, want = (runs[k]["results"][task] for k in ("port", "jax"))
    if task == "pe_ll_scores":
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LL_RTOL)
        return
    _close(got, want, task)


def test_group_and_fallbacks_match_jax(runs):
    _close(runs["port"]["groups"], runs["jax"]["groups"], "groups")
    group = runs["port"]["groups"]["pe_group"]
    assert group["n_samples"] == 8 and "anls_stderr" in group
    judge_scores = runs["port"]["results"]["pe_judge"]
    assert judge_scores["offline_metric"] is True
    assert "offline_judge_containment" in judge_scores
    # the video task read its frames through the port's own stand-in
    assert runs["port_reader"] == "competesmoe_tpu_torch.eval.lmms_compat"
    assert runs["jax_reader"] == "competesmoe_tpu.eval.lmms_compat"
    for key in ("port", "jax"):
        assert runs[key]["time_inference"]["n_batches"] > 0


@pytest.mark.parametrize("task", ["pe_gen", "pe_grp_a", "pe_video"])
def test_routing_telemetry_matches_jax(runs, task):
    """Per layer of the vision tower and the projector: histograms
    identical, entropy within 1e-5. A request decoded in a batch without
    an image has none."""
    n_images = 0
    for got, want in zip(runs["port"]["samples"][task],
                         runs["jax"]["samples"][task]):
        n_images += bool(got["logs_metrics_vision"])
        for part in ("logs_metrics_vision", "logs_metrics_mlp"):
            g, w = got[part], want[part]
            assert sorted(g) == sorted(w)
            for layer in w:
                assert g[layer]["top1_hist"] == w[layer]["top1_hist"]
                assert g[layer]["top2_hist"] == w[layer]["top2_hist"]
                assert abs(g[layer]["entropy"] - w[layer]["entropy"]) \
                    <= ENTROPY_TOL
                assert sorted(g[layer]["losses"]) == \
                    sorted(w[layer]["losses"])
        if got["logs_metrics_vision"]:
            assert len(got["logs_metrics_vision"]) == 2    # tower layers
            assert list(got["logs_metrics_mlp"]) == ["layer_0"]
    assert n_images >= 2


def test_table_matches_jax(runs):
    assert teval.make_table(runs["port"]) == jeval.make_table(runs["jax"])


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def gen_requests(tag="eng"):
    img = image(99)
    return [teval.Instance(request_type="generate_until",
                           arguments=(q, {"max_new_tokens": 4}, v),
                           idx=0, metadata=(tag, i, 1))
            for i, (q, v) in enumerate(
                [("what color is this", [img]), ("is this a cat", [img]),
                 ("yes red blue a cat what", []), ("what color", [image(3)]),
                 ("blue a", []), ("count the shape here", [])])]


@pytest.mark.parametrize("pipeline", [1, 2])
def test_engine_route_equals_solo_route(models, pipeline):
    want = port_lm(models).generate_until(gen_requests())
    lm = port_lm(models, engine_slots=2, engine_max_len=96,
                 engine_pipeline=pipeline)
    try:
        got = lm.generate_until(gen_requests())
        assert lm._engine is not None
    finally:
        lm.close()
    assert got == want


def test_engine_route_raises_when_the_engine_died(models):
    class Dead:
        error = RuntimeError("boom")

        def submit(self, *a, **k):
            return iter([])

    lm = port_lm(models, engine_slots=2)
    lm._engine = Dead()
    with pytest.raises(RuntimeError, match="eval engine died"):
        lm.generate_until(gen_requests())
    lm._engine = None


def test_telemetry_runs_take_the_solo_route(models):
    lm = port_lm(models, engine_slots=2)
    reqs = gen_requests()
    got = lm.generate_until(reqs, return_id_experts=True)
    assert lm._engine is None
    assert got == port_lm(models).generate_until(gen_requests())
    assert any(r.logs_metrics_vision for r in reqs)


def ll_requests():
    return [teval.Instance(request_type="loglikelihood",
                           arguments=(f"what color {'x ' * i}",
                                      ["red blue", "no", "a cat yes"][i % 3],
                                      [image(i)] if i % 2 else []),
                           idx=0, metadata=("t", i, 1)) for i in range(7)]


def spliced_loglikelihood(lm, req):
    """The target's log-probability from the model's own label splice:
    prompt + target as labels with the prompt ignored, each label scored
    by the logits one position before it."""
    ctx, target, visuals = req.arguments
    prompt = lm._build_prompt(ctx, bool(visuals))
    tgt = lm.tokenizer(target).input_ids[1:]
    ids = torch.as_tensor([prompt + tgt])
    labels = torch.as_tensor([[IGNORE_INDEX] * len(prompt) + tgt])
    px = None
    if visuals:
        from competesmoe_tpu_torch.multimodal.mm_utils import process_images
        px = torch.as_tensor(process_images(visuals[:1],
                                            lm.image_processor))
    with torch.no_grad():
        out = lm.model(ids, px, labels=labels)
    lp = torch.log_softmax(out.logits[0, :-1].float(), -1)
    lab = out.labels[0, 1:]
    keep = lab != IGNORE_INDEX
    assert int(keep.sum()) == len(tgt)
    return float(lp[keep].gather(-1, lab[keep][:, None]).sum())


def test_batched_loglikelihood_equals_unbatched(models):
    """batch_size 3 against batch_size 1 within 1e-5, and both against an
    independent scoring through the model's label splice (the image
    offset P - 1 and the shift by one)."""
    batched = port_lm(models, batch_size=3).loglikelihood(ll_requests())
    lm1 = port_lm(models, batch_size=1)
    single = lm1.loglikelihood(ll_requests())
    assert len(lm1.time_inference) == 7
    for (a, ga), (b, gb), req in zip(batched, single, ll_requests()):
        np.testing.assert_allclose(a, b, rtol=1e-5)
        assert ga == gb
        np.testing.assert_allclose(b, spliced_loglikelihood(lm1, req),
                                   rtol=1e-5)


def test_two_rank_merge_equals_single_rank(models, tmp_path):
    docs = [{"q": question(np.random.default_rng(i), 3 + i % 2),
             "a": "w5 w9", "img": image(i)} for i in range(5)]
    teval.register_task("pe_merge", teval.TaskConfig(
        task="pe_merge", output_type="generate_until",
        doc_to_text=lambda d: d["q"], doc_to_visual=lambda d: [d["img"]],
        doc_to_target=lambda d: d["a"],
        generation_kwargs={"max_new_tokens": 3},
        metric_list=[{"metric": "exact_match", "aggregation": "mean"},
                     {"metric": "anls", "aggregation": "mean"}],
        docs=docs))
    full = teval.simple_evaluate(port_lm(models), ["pe_merge"])
    md = tmp_path / "merge"
    r1 = teval.simple_evaluate(port_lm(models), ["pe_merge"], rank=1,
                               world_size=2, merge_dir=md)
    assert r1.get("partial_rank") == 1
    r0 = teval.simple_evaluate(port_lm(models), ["pe_merge"], rank=0,
                               world_size=2, merge_dir=md)
    assert r0.get("merged_ranks") == 2
    assert len(r0["samples"]["pe_merge"]) == 5
    _close(r0["results"]["pe_merge"], full["results"]["pe_merge"])
    assert sorted((s["doc_id"], s["resps"])
                  for s in r0["samples"]["pe_merge"]) == \
        sorted((s["doc_id"], s["resps"])
               for s in full["samples"]["pe_merge"])


def test_caching_lm_answers_from_the_cache(models, tmp_path):
    calls = []

    class Counting:
        def __init__(self, lm):
            self.lm = lm

        def generate_until(self, reqs, **kw):
            calls.append(len(reqs))
            return self.lm.generate_until(reqs, **kw)

        def loglikelihood(self, reqs, **kw):
            calls.append(len(reqs))
            return self.lm.loglikelihood(reqs, **kw)

    path = str(tmp_path / "cache.db")
    first = teval.CachingLM(Counting(port_lm(models)), path)
    want = (first.generate_until(gen_requests()),
            first.loglikelihood(ll_requests()))
    assert first.misses == 13 and calls == [6, 7]
    calls.clear()
    again = teval.CachingLM(Counting(port_lm(models)), path)
    got = (again.generate_until(gen_requests()),
           again.loglikelihood(ll_requests()))
    assert calls == [] and again.hits == 13 and again.misses == 0
    assert got == want
