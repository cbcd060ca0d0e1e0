"""Parity of the port's LM data, logging, eval and sweep modules with the
JAX package: token chunks and the native loader, the tokenize flow, the
streaming corpus over shards the test writes, the shard specs, the QA
loaders, the zero-shot evaluator, eval-time routing telemetry, plots, the
loggers, `run_sweep`, and the LM tasks end to end on the CPU.

Every file is written by the test from a seed; no test reads a URL.
Bytes, ids and documents must be equal; the evaluator's loglikelihoods
agree within 1e-4 relative (float32 forwards on both sides) and its
accuracies exactly.
"""

import gzip
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.cli import run_sweep as jsweep
from competesmoe_tpu.data import lm_data as jdata
from competesmoe_tpu.data import native_loader as jnative
from competesmoe_tpu.data import qa_datasets as jqa
from competesmoe_tpu.data import streaming as jstream
from competesmoe_tpu.eval import lm_zeroshot as jzs
from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.train import lm_task as jtask
from competesmoe_tpu.train import logger as jlogger
from competesmoe_tpu.train import plots as jplots
from competesmoe_tpu_torch.cli import run_sweep as tsweep
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.data import lm_data as tdata
from competesmoe_tpu_torch.data import native_loader as tnative
from competesmoe_tpu_torch.data import qa_datasets as tqa
from competesmoe_tpu_torch.data import streaming as tstream
from competesmoe_tpu_torch.eval import lm_zeroshot as tzs
from competesmoe_tpu_torch.models import lm as tlm
from competesmoe_tpu_torch.moe import MoEArgs
from competesmoe_tpu_torch.parallel import mesh as tmesh
from competesmoe_tpu_torch.train import lm_task as ttask
from competesmoe_tpu_torch.train import logger as tlogger
from competesmoe_tpu_torch.train import plots as tplots
from competesmoe_tpu_torch.utils.argparser import build_parser

REPO = Path(__file__).resolve().parents[1]
WORDS = ("the quick brown fox jumps over a lazy dog pack my box with five "
         "dozen liquor jugs how vexingly daft zebras jump sphinx of black "
         "quartz judge vow").split()


def docs_from(seed: int, n: int, lo: int = 4, hi: int = 30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def write_shard(path: Path, docs) -> Path:
    with gzip.open(path, "wt", encoding="utf-8") as f:
        for d in docs:
            f.write(json.dumps({"text": d}) + "\n")
    return path


def write_chunks(d: Path, seed: int = 0, sizes=(1000, 37, 520)):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        p = d / f"chunk_{i}.bin"
        rng.integers(0, 65535, n).astype(np.uint16).tofile(p)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# token chunks, the native loader, samplers, collate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_token_chunks_and_native_loader_match_jax(tmp_path, native,
                                                  monkeypatch):
    """TokenChunkDataset windows and batches, and the loader's three entry
    points, byte for byte against JAX's, through the port's g++ build of
    native/dataloader.cpp and through its numpy path."""
    if native:
        assert tnative.native_available()
        assert tnative._LIB_PATH.parent.name == "_build"
    else:
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    paths = write_chunks(tmp_path)
    jd, td = (m.TokenChunkDataset(paths, 15) for m in (jdata, tdata))
    assert len(jd) == len(td) == 62 + 2 + 32
    idx = np.random.default_rng(1).integers(0, len(td), 40)
    np.testing.assert_array_equal(jd.batch(idx), td.batch(idx))
    for i in (0, 61, 62, 63, 64, len(td) - 1):
        np.testing.assert_array_equal(jd[i], td[i])
    chunk = np.fromfile(paths[0], np.uint16)
    w = np.array([0, 5, 61])
    np.testing.assert_array_equal(jnative.gather_windows(chunk, w, 16),
                                  tnative.gather_windows(chunk, w, 16))
    seqs = [np.arange(n, dtype=np.int32) + 1 for n in (0, 3, 9, 12)]
    for a, b in zip(jnative.pad_batch(seqs, 10, pad_id=7),
                    tnative.pad_batch(seqs, 10, pad_id=7)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        tnative.gather_windows(chunk, np.array([62]), 16)


def test_samplers_collate_and_synthetic_corpora_match_jax():
    """InfiniteRandomSampler, BucketedSampler (two epochs),
    var_length_collate, SyntheticMixtureLMDataset and BackgroundFetcher."""
    for j, t in ((jdata.InfiniteRandomSampler(100, 8, seed=3),
                  tdata.InfiniteRandomSampler(100, 8, seed=3)),):
        for _ in range(3):
            np.testing.assert_array_equal(next(j), next(t))
        assert j.state_dict() == t.state_dict()
    lengths = list(np.random.default_rng(0).integers(5, 100, 64))
    js = jdata.BucketedSampler(lengths, batch_size=8, bucket_size_mult=2)
    ts = tdata.BucketedSampler(lengths, batch_size=8, bucket_size_mult=2)
    for _ in range(2):
        for a, b in zip(iter(js), iter(ts), strict=True):
            np.testing.assert_array_equal(a, b)
    samples = [{"input_ids": np.arange(n), "labels": np.arange(n),
                "n": np.int32(n)} for n in (3, 7, 5)]
    jc, tc = jdata.var_length_collate(samples), \
        tdata.var_length_collate(samples)
    assert set(jc) == set(tc)
    for k in jc:
        np.testing.assert_array_equal(jc[k], tc[k])
    jm = jdata.SyntheticMixtureLMDataset(97, 31, n_windows=64, seed=2)
    tm = tdata.SyntheticMixtureLMDataset(97, 31, n_windows=64, seed=2)
    np.testing.assert_array_equal(jm.batch(np.arange(5)),
                                  tm.batch(np.arange(5)))
    assert jm.mode_of(9) == tm.mode_of(9)
    counter = iter(range(100))
    f = tdata.BackgroundFetcher(lambda: next(counter), depth=2)
    assert [f.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    f.stop()


# ---------------------------------------------------------------------------
# tokenizers, the streaming corpus, the shard specs
# ---------------------------------------------------------------------------

def test_tokenize_to_chunks_matches_jax(tmp_path):
    """A byte-level BPE vocab trained on the same documents is the same
    vocab, and `tokenize_to_chunks` writes the same chunk bytes and
    manifest; `open_chunk_dir` reads the same windows."""
    docs = docs_from(0, 60)
    jtok = jdata.train_tokenizer(iter(docs), 300, tmp_path / "j.json")
    ttok = tdata.train_tokenizer(iter(docs), 300, tmp_path / "t.json")
    assert jtok.get_vocab() == ttok.get_vocab()
    tok = tdata.load_tokenizer(tmp_path / "t.json")
    jp = jdata.tokenize_to_chunks(iter(docs), tok, tmp_path / "jc",
                                  chunk_tokens=200)
    tp = tdata.tokenize_to_chunks(iter(docs), tok, tmp_path / "tc",
                                  chunk_tokens=200)
    assert len(jp) == len(tp) > 2
    for a, b in zip(jp, tp):
        assert a.read_bytes() == b.read_bytes()
    assert (tmp_path / "jc" / "manifest.json").read_text() == \
        (tmp_path / "tc" / "manifest.json").read_text()
    jw, tw = (m.open_chunk_dir(tmp_path / d, 7) for m, d in
              ((jdata, "jc"), (tdata, "tc")))
    np.testing.assert_array_equal(jw.batch(np.arange(len(jw))),
                                  tw.batch(np.arange(len(tw))))


def test_chunked_corpus_matches_jax(tmp_path):
    """ChunkedLMCorpus over three jsonl.gz shards (two for the vocab).
    HF's Unigram trainer is not deterministic from run to run (two runs
    in one process can part), so the port's corpus is given the vocab
    file JAX's trained in its cache, which it must load and not train
    again; then the same chunk bytes and the same windows. The port's own
    training (a fresh cache) gives a vocab of at most the asked size with the
    three special tokens; a second corpus on a cache tokenizes nothing."""
    shards = [str(write_shard(tmp_path / f"s{i}.jsonl.gz",
                              docs_from(10 + i, 40))) for i in range(3)]
    kw = dict(vocab_size=120, n_shards=3, tokenizer_n_files=2)
    jc = jstream.ChunkedLMCorpus(jstream.LocalShardSpec(shards=shards), 15,
                                 tmp_path / "jcache", **kw)
    vocab = "tokenizer-unigram-120.json"
    (tmp_path / "tcache").mkdir()
    (tmp_path / "tcache" / vocab).write_bytes(
        (tmp_path / "jcache" / vocab).read_bytes())
    tc = tstream.ChunkedLMCorpus(tstream.LocalShardSpec(shards=shards), 15,
                                 tmp_path / "tcache", **kw)
    assert jc.tokenizer.get_vocab() == tc.tokenizer.get_vocab()
    own = tstream.ChunkedLMCorpus(tstream.LocalShardSpec(shards=shards), 15,
                                  tmp_path / "own", **kw)
    assert 3 < own.tokenizer.get_vocab_size() <= 120
    for special in ("<eos>", tstream.STORY_SEP, "<unk>"):
        assert own.tokenizer.token_to_id(special) is not None
    assert [p.name for p in jc.chunk_paths] == [p.name for p in
                                                tc.chunk_paths]
    for a, b in zip(jc.chunk_paths, tc.chunk_paths):
        assert a.read_bytes() == b.read_bytes()
    assert len(jc) == len(tc) > 0
    np.testing.assert_array_equal(jc.batch(np.arange(len(jc))),
                                  tc.batch(np.arange(len(tc))))
    mtimes = [p.stat().st_mtime_ns for p in tc.chunk_paths]
    again = tstream.ChunkedLMCorpus(tstream.LocalShardSpec(shards=shards),
                                    15, tmp_path / "tcache", **kw)
    assert [p.stat().st_mtime_ns for p in again.chunk_paths] == mtimes
    assert [json.loads(x)["text"] for x in tstream.shard_lines(shards[0])] \
        == docs_from(10, 40)


def test_shard_specs_match_jax():
    """URLs and shard counts of every spec, SlimPajama's and TheStack's
    seeded shard orders included (no URL is fetched)."""
    for split in ("train", "validation", "test"):
        js, ts = jstream.SlimPajamaSpec(), tstream.SlimPajamaSpec()
        assert js.get_n_shards(split) == ts.get_n_shards(split)
        for i in (0, 1, 2, 777, js.get_n_shards(split) - 1):
            assert js.get_url(i, split) == ts.get_url(i, split)
    for jcls, tcls, kw in ((jstream.C4Spec, tstream.C4Spec, {}),
                           (jstream.PES2OSpec, tstream.PES2OSpec, {}),
                           (jstream.TheStackSpec, tstream.TheStackSpec,
                            {"languages": "python,rust,haskell"})):
        js, ts = jcls(**kw), tcls(**kw)
        for split in ("train", "validation"):
            n = js.get_n_shards(split)
            assert n == ts.get_n_shards(split)
            assert [js.get_url(i, split) for i in range(min(n, 30))] == \
                [ts.get_url(i, split) for i in range(min(n, 30))]
    assert tstream.fetch_to_cache("/x/y.jsonl", "/nonexistent") == \
        Path("/x/y.jsonl")


# ---------------------------------------------------------------------------
# QA loaders and the zero-shot evaluator
# ---------------------------------------------------------------------------

def write_qa_files(d: Path, seed: int, n: int = 6):
    """One file (or directory) in each QA dataset's format."""
    rng = np.random.default_rng(seed)

    def s(lo=3, hi=9):
        return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))

    def jl(name, rows):
        p = d / name
        p.write_text("".join(json.dumps(r) + "\n" for r in rows))
        return p

    def mc(k):
        labels = "ABCDE"[:k]
        return [{"question": {"stem": s(), "choices": [
            {"label": c, "text": s(1, 4)} for c in labels]},
            "answerKey": labels[int(rng.integers(k))]} for _ in range(n)]

    (d / "blimp").mkdir(exist_ok=True)
    for ph in ("anaphor", "island"):
        jl(f"blimp/{ph}.jsonl", [{"sentence_good": s(),
                                  "sentence_bad": s()} for _ in range(n)])
    (d / "piqa_labels.lst").write_text(
        "\n".join(str(int(rng.integers(2))) for _ in range(n)))
    (d / "siqa_labels.lst").write_text(
        "\n".join(str(int(rng.integers(1, 4))) for _ in range(n)))
    return dict(
        hellaswag=jl("hs.jsonl", [{
            "activity_label": s(1, 2), "ctx_a": s() + " [title] x",
            "ctx_b": s(), "endings": [s() for _ in range(4)],
            "label": int(rng.integers(4))} for _ in range(n)]),
        piqa=jl("piqa.jsonl", [{"goal": s(), "sol1": s(), "sol2": s()}
                               for _ in range(n)]),
        ai2arc=jl("arc.jsonl", mc(4)),
        openbookqa=jl("obqa.jsonl", mc(4)),
        commonsenseqa=jl("csqa.jsonl", mc(5)),
        winogrande=jl("wg.jsonl", [{"sentence": s(), "option1": s(1, 2),
                                    "option2": s(1, 2),
                                    "answer": str(int(rng.integers(1, 3)))}
                                   for _ in range(n)]),
        siqa=jl("siqa.jsonl", [{"context": s(), "question": s(),
                                "answerA": s(), "answerB": s(),
                                "answerC": s()} for _ in range(n)]),
        race=jl("race.jsonl", [{"article": s(10, 30), "question": s(),
                                "options": [s() for _ in range(4)],
                                "answer": "ABCD"[int(rng.integers(4))]}
                               for _ in range(n)]),
        cbt=jl("cbt.jsonl", [{"context": s(), "question": "a XXXXX b",
                              "options": ["fox", "dog", "box"],
                              "answer": "dog"} for _ in range(n)]),
        blimp=d / "blimp",
        lambada=jl("lambada.jsonl", [{"text": s(5, 40)} for _ in range(n)]),
        piqa_labels=d / "piqa_labels.lst",
        siqa_labels=d / "siqa_labels.lst")


def qa_docs(qa, files, encode):
    """Every loader's documents (lambada's items) on `files`."""
    out = {name: qa.QA_LOADERS[name](files[name], encode)
           for name in ("hellaswag", "ai2arc", "openbookqa", "commonsenseqa",
                        "winogrande", "race", "cbt", "blimp")}
    out["piqa"] = qa.piqa_docs(files["piqa"], files["piqa_labels"], encode)
    out["siqa"] = qa.siqa_docs(files["siqa"], files["siqa_labels"], encode)
    out["lambada"] = qa.lambada_items(files["lambada"], encode)
    return out


def word_encode(s: str):
    return [1 + WORDS.index(w) if w in WORDS else 1 + len(WORDS) + len(w)
            for w in s.replace("\n", " ").replace(":", " ").split()]


def test_qa_loaders_match_jax(tmp_path):
    """The eleven loaders on files in each format: equal documents."""
    files = write_qa_files(tmp_path, 0)
    jdocs, tdocs = qa_docs(jqa, files, word_encode), \
        qa_docs(tqa, files, word_encode)
    assert set(jdocs) == set(tdocs) and len(tdocs) == 11
    for name in jdocs:
        j = [d if isinstance(d, tuple) else vars(d) for d in jdocs[name]]
        t = [d if isinstance(d, tuple) else vars(d) for d in tdocs[name]]
        assert j == t and len(t) > 0, name
    assert {d.group for d in tdocs["blimp"]} == {"anaphor", "island"}
    assert tqa.URLS == jqa.URLS
    assert tqa.ensure_file(str(files["piqa"]), "piqa") == files["piqa"]


@pytest.fixture(scope="module")
def tiny_models():
    """A tiny float32 smoe LM in both packages, the same weights."""
    base = dict(vocab_size=48, d_model=32, n_layers=2, n_heads=2,
                n_experts=4, expert_size=8, moe_topk=2, moe_name="smoe")
    jcfg = jlm.LMConfig(**base, moe_args=JMoEArgs(), dtype=jnp.float32,
                        attn_backend="einsum")
    jm = jlm.MoELanguageModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))
    tm = tlm.MoELanguageModel(tlm.LMConfig(**base, moe_args=MoEArgs(),
                                           attn_backend="flash"),
                              device="cpu")
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def test_zeroshot_evaluator_matches_jax(tmp_path, tiny_models):
    """LMZeroShotEvaluator on the QA files (buckets of 16 and 32 tokens,
    sequences cut at max_len): per-sequence totals and means within 1e-4
    relative, greedy flags, accuracies (strict-greater), group averages
    and lambada equal."""
    jm, params, tm = tiny_models
    files = write_qa_files(tmp_path, 1, n=5)

    def enc(s):
        return [i % 47 + 1 for i in word_encode(s)]

    jdocs, tdocs = qa_docs(jqa, files, enc), qa_docs(tqa, files, enc)
    jev = jzs.LMZeroShotEvaluator(jm, params, pad_quantum=16, max_len=32)
    tev = tzs.LMZeroShotEvaluator(tm, pad_quantum=16, max_len=32)
    seqs = [(d.prefix_ids, c) for d in tdocs["hellaswag"]
            for c in d.choices_ids] + tdocs["lambada"]
    js, ts = jev.score_sequences(seqs), tev.score_sequences(seqs)
    for (a, b, c), (x, y, z) in zip(js, ts, strict=True):
        np.testing.assert_allclose([a, b], [x, y], rtol=1e-4)
        assert c == z
    assert sorted(jev._fns) == [16, 32]
    for name in ("hellaswag", "piqa", "blimp", "winogrande", "race"):
        assert jev.evaluate(jdocs[name]) == tev.evaluate(tdocs[name]), name
    assert "accuracy/group_average" in tev.evaluate(tdocs["blimp"])
    assert jzs.lambada_accuracy(jev, jdocs["lambada"]) == \
        tzs.lambada_accuracy(tev, tdocs["lambada"])


# ---------------------------------------------------------------------------
# telemetry, plots, loggers
# ---------------------------------------------------------------------------

def test_expert_usage_telemetry_matches_jax(tmp_path, tiny_models):
    """`_log_expert_usage` on one batch: the same per-layer histograms
    (the bincount of the router's selections), nonzero shares and
    entropies, and the same heatmap record."""
    jm, params, tm = tiny_models
    batch = np.random.default_rng(5).integers(0, 48, (4, 17))
    records = []
    for pkg, model, logger_mod, arr in (
            (jtask, jm, jlogger, jnp.asarray(batch, jnp.int32)),
            (ttask, tm, tlogger, torch.from_numpy(batch))):
        logger = logger_mod.MetricLogger(tmp_path / pkg.__name__,
                                         use_tensorboard=False)
        # the port's task sums the histograms over its ranks' rows (one
        # rank here)
        stub = SimpleNamespace(model=model, logger=logger,
                               cfg=SimpleNamespace(n_experts=4),
                               state=SimpleNamespace(params=params["params"],
                                                     step=3),
                               mesh=tmesh.make_mesh(), is_master=True)
        with torch.no_grad():
            pkg.SyntheticTransformerTask._log_expert_usage(stub, arr)
        logger.close()
        recs = [json.loads(x) for x in (tmp_path / pkg.__name__
                                        / "log_trainer.jsonl").read_text()
                .splitlines()]
        for r in recs:
            r.pop("time", None)
        records.append(recs)
    assert len(records[1]) == 2
    assert records[0][1] == records[1][1]          # the heatmap
    j, t = records[0][0], records[1][0]
    assert set(j) == set(t) and len(t) == 1 + 2 * 2
    for k in j:
        np.testing.assert_allclose(j[k], t[k], rtol=1e-6)
    _, aux = tm(torch.from_numpy(batch[:, :-1]), return_id_experts=True)
    hist = np.bincount(aux["layer1/selected_experts"].reshape(-1).numpy(),
                       minlength=4)
    np.testing.assert_allclose(records[1][1]["plots"][
        "expert_usage/heatmap"]["map"][1], hist / hist.sum())


def test_plots_and_loggers_match_jax(tmp_path, capsys):
    """log_plots writes JAX's JSONL record for each plot type (and TB
    images with tensorboardX); the async logger writes every record by
    close; -log wandb without the package prints JAX's "wandb
    unavailable" line and keeps logging."""
    plots = {
        "hist": dict(values=np.random.default_rng(0).normal(size=100)),
        "heat": dict(map=np.arange(12).reshape(3, 4), xlabel="expert",
                     ylabel="layer"),
        "xy": dict(curves={"loss": [3.0, 2.0, 1.5]}, xlabel="step"),
        "cm": dict(matrix=np.eye(3), class_names=list("abc")),
        "txt": dict(text="hello"),
    }
    kinds = {"hist": "Histogram", "heat": "Heatmap", "xy": "XYChart",
             "cm": "ConfusionMatrix", "txt": "TextPlot"}
    recs = []
    for name, lmod, pmod in (("j", jlogger, jplots), ("t", tlogger, tplots)):
        logger = lmod.MetricLogger(tmp_path / name)
        pmod.log_plots(logger, 7, {k: getattr(pmod, kinds[k])(**v)
                                   for k, v in plots.items()})
        logger.close()
        recs.append((tmp_path / name / "log_trainer.jsonl").read_text())
    assert recs[0] == recs[1]
    assert any((tmp_path / "t" / "tb").iterdir())
    alog = tlogger.AsyncMetricLogger(tmp_path / "a", use_tensorboard=False)
    for s in range(50):
        alog.log(s, {"x": s, "y": torch.tensor(2.0 * s)}, to_stdout=False)
    alog.close()
    lines = (tmp_path / "a" / "log_trainer.jsonl").read_text().splitlines()
    assert [json.loads(x)["y"] for x in lines] == [2.0 * s for s in
                                                   range(50)]
    capsys.readouterr()
    w = tlogger.MetricLogger(tmp_path / "w", use_tensorboard=False,
                             use_wandb=True)
    w.log(0, {"a": 1.0}, to_stdout=False)
    w.close()
    assert "wandb unavailable" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# sweeps and the tasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweep", sorted(p.name for p in
                                         (REPO / "sweeps").glob("*.yaml")))
def test_run_sweep_matches_jax(sweep, capsys):
    """parse_sweep / to_argv on each sweep file equal JAX's; the port's
    parser takes every flag; --dry-run prints the port's entry point with
    the extra flags after the sweep's."""
    path = str(REPO / "sweeps" / sweep)
    runs = tsweep.parse_sweep(path)
    assert runs == jsweep.parse_sweep(path)
    argv = tsweep.to_argv(runs[0])
    assert argv == jsweep.to_argv(runs[0])
    a = build_parser().parse(argv + ["-lm.shards", "x.jsonl"])
    assert a.task == "slimpajama_transformer" and a.lm.shards == "x.jsonl"
    assert ttask.get_task(a.task) is ttask.SlimPajamaTransformerTask
    tsweep.main([path, "--dry-run", "--", "-lm.shards", "x.jsonl"])
    out = capsys.readouterr().out
    assert "-m competesmoe_tpu_torch.cli.main" in out
    assert out.rstrip().endswith("-lm.shards x.jsonl")


TINY = ["-batch_size", "2", "-lm.unroll", "16", "-lm.vocab_size", "120",
        "-state_size", "32", "-transformer.encoder_n_layers", "2",
        "-transformer.n_heads", "2", "-moe.n_experts", "4",
        "-moe.expert_size", "8", "-pkm.n_heads", "2", "-moe.impl", "fused",
        "-transformer.attn_backend", "flash", "-rate_flip", "0.5",
        "-warm_up", "0.0", "-log_interval", "1", "-amp", "0",
        "-device", "cpu", "-valid_batches", "2"]


def test_tasks_train_validate_and_test_on_cpu(tmp_path, capsys):
    """The registry holds JAX's task names; slimpajama_transformer over
    local shards trains 4 steps with validation telemetry, the async
    logger, TensorBoard and a profiler trace, and its test() scores the
    QA battery on files in each format; chunked_transformer trains on
    the chunk directory that `tokenize_to_chunks` writes; a resumed run
    reads the consumed sampler position."""
    assert set(ttask.TASK_REGISTRY) == set(jtask.TASK_REGISTRY)
    shards = [write_shard(tmp_path / f"s{i}.jsonl.gz", docs_from(i, 40))
              for i in range(3)]
    files = write_qa_files(tmp_path, 2, n=4)
    qa_flags = ["-lm.eval.enabled", "1"]
    for name in ("hellaswag", "piqa", "ai2arc", "lambada", "blimp"):
        qa_flags += [f"-lm.eval.{name}.enabled", "1",
                     f"-lm.eval.{name}.path", str(files[name])]
    qa_flags += ["-lm.eval.piqa.labels_path", str(files["piqa_labels"]),
                 "-lm.eval.pad_quantum", "8"]
    flags = TINY + [
        "-task", "slimpajama_transformer", "-stop_after", "4",
        "-lm.shards", str(tmp_path / "s*.jsonl.gz"), "-lm.n_shards", "3",
        "-lm.tokenizer_n_files", "2", "-lm.cache_dir",
        str(tmp_path / "cache"), "-run_dir", str(tmp_path), "-name", "sp",
        "-valid_interval", "2", "-log_async", "1", "-log", "tb",
        "-profile.start_step", "1", "-profile.n_steps", "1"] + qa_flags
    task = ttask.get_task("slimpajama_transformer")(
        build_parser().parse(flags))
    assert task.dataset.tokenizer.get_vocab_size() <= 120
    task.train()
    assert task.sampler.pos == 4
    assert task.trace_path.exists()
    assert sum(task.expert_usage["layer0"]) == 2 * 16 * 2
    res = task.test()
    task.logger.close()
    recs = [json.loads(x) for x in
            (tmp_path / "sp" / "log_trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss/total" in r] == [0, 1, 2, 3]
    assert all("timing/ms_per_load" in r for r in recs if "loss/total" in r)
    assert any("expert_usage/layer1_entropy" in r for r in recs)
    assert any("plots" in r for r in recs)
    assert (tmp_path / "sp" / "tb").exists()
    assert {"hellaswag/accuracy", "piqa/accuracy", "ai2arc/accuracy",
            "lambada/accuracy", "blimp/accuracy/group_average",
            "valid/perplexity"} <= set(res)
    assert res["hellaswag/n_docs"] == 4

    data = tmp_path / "chunks"
    tok = tdata.train_tokenizer(iter(docs_from(7, 50)), 300,
                                tmp_path / "bpe.json")
    tdata.tokenize_to_chunks(iter(docs_from(8, 80)), tok, data / "train",
                             chunk_tokens=300)
    flags = TINY + ["-task", "chunked_transformer", "-stop_after", "3",
                    "-lm.data_dir", str(data), "-run_dir", str(tmp_path),
                    "-name", "ck", "-valid_interval", "0",
                    "-save_interval", "2", "-lm.vocab_size", "300"]
    ck = ttask.get_task("chunked_transformer")(build_parser().parse(flags))
    ck.train(n_steps=2)
    again = ttask.get_task("chunked_transformer")(build_parser().parse(
        flags))
    assert again.state.step == again.sampler.pos == 2
    again.train()
    assert again.state.step == 3
