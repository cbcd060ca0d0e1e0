"""The port's `cli/eval_mm` against JAX's `cli/eval_mm` on the same
synthetic HF checkpoint (tests/test_builder.py `make_fake_checkpoint`)
and the same local `tokenizers` BPE tokenizer, as tests/test_cli_mm.py
builds them: with `--return-id-experts --batch-size 2 --device cpu` both
write the same JSON results (texts identical, loglikelihood totals
within 1e-4 relative, metrics within 1e-9 relative, telemetry histograms
identical and entropies within 1e-5). Both CLIs load the checkpoint in
bf16; here both loaders are wrapped to load it in float32, where the two
packages' roundings agree that far (in bf16 a router's near tie may
choose another expert for one token). Also: `--mesh` needs as many
ranks as it names; without `--device cpu` and with no card the CLI
raises; the `--config` loop (bf16 and --load-8bit), `--task-yaml` and the
results logger.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import competesmoe_tpu.eval as jeval
import competesmoe_tpu_torch.eval as teval
from tests.test_builder import make_fake_checkpoint
from tests.test_torch_port_eval_offline import stand_ins_of


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A PreTrainedTokenizerFast trained locally (no network)."""
    d = tmp_path_factory.mktemp("tok")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=60, special_tokens=["<pad>", "<s>", "</s>", "<|end|>"])
    corpus = ["what is this a cat yes really sure red blue <|user|> "
              "<|assistant|> <|system|> You are helpful assistant"] * 20
    tok.train_from_iterator(corpus, trainer)
    from transformers import PreTrainedTokenizerFast
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", bos_token="<s>",
        eos_token="</s>")
    fast.save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    make_fake_checkpoint(d)
    return d


def register_cli_tasks(mod):
    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (30, 26, 3))
                            .astype(np.uint8)) for _ in range(3)]
    qs = ["what color", "is this a cat", "what is this really",
          "red or blue", "sure"]
    gen = [{"q": q, "a": "red", "img": imgs[i % 3] if i != 3 else None}
           for i, q in enumerate(qs)]
    mod.register_task("cli_port_gen", mod.TaskConfig(
        task="cli_port_gen", output_type="generate_until",
        doc_to_text=lambda d: d["q"],
        doc_to_visual=lambda d: [d["img"]] if d["img"] else [],
        doc_to_target=lambda d: d["a"],
        generation_kwargs={"max_new_tokens": 2},
        metric_list=[{"metric": "exact_match", "aggregation": "mean"},
                     {"metric": "anls", "aggregation": "mean",
                      "threshold": 0.0}],
        docs=gen))
    mod.register_task("cli_port_ll", mod.TaskConfig(
        task="cli_port_ll", output_type="loglikelihood",
        doc_to_text=lambda d: d["q"],
        doc_to_visual=lambda d: [d["img"]] if d["img"] else [],
        doc_to_target=lambda d: "yes",
        metric_list=[{"metric": "accuracy", "aggregation": "mean"}],
        docs=gen[:4]))


FLAGS = ["--tasks", "cli_port_gen,cli_port_ll", "--batch-size", "2",
         "--max-new-tokens", "2", "--return-id-experts", "--world-size",
         "1", "--rank", "0"]


def with_dtype(builder, dtype):
    """`builder.load_pretrained_model` with its dtype argument replaced."""
    load = builder.load_pretrained_model

    def loader(*args, **kw):
        kw["dtype"] = dtype
        return load(*args, **kw)
    return loader


@pytest.fixture(scope="module")
def cli_runs(ckpt_dir, tok_dir, tmp_path_factory):
    import jax.numpy as jnp

    from competesmoe_tpu.cli.eval_mm import main as jmain
    from competesmoe_tpu.models import builder as jbuilder
    from competesmoe_tpu_torch.cli.eval_mm import main as tmain
    from competesmoe_tpu_torch.models import builder as tbuilder
    out = tmp_path_factory.mktemp("cli")
    common = ["--model-dir", str(ckpt_dir), "--tokenizer", tok_dir] + FLAGS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuilder, "load_pretrained_model",
                   with_dtype(jbuilder, jnp.float32))
        mp.setattr(tbuilder, "load_pretrained_model",
                   with_dtype(tbuilder, torch.float32))
        stand_ins_of("competesmoe_tpu")
        register_cli_tasks(jeval)
        jmain(common + ["--output-path", str(out / "jax.json")])
        stand_ins_of("competesmoe_tpu_torch")
        register_cli_tasks(teval)
        got = tmain(common + ["--output-path", str(out / "port.json"),
                              "--device", "cpu"])
    return (json.loads((out / "jax.json").read_text()),
            json.loads((out / "port.json").read_text()), got)


def test_cli_writes_the_same_texts_and_scores(cli_runs):
    want, got, returned = cli_runs
    assert len(returned) == 1
    assert returned[0]["results"] == got["results"]
    for task in ("cli_port_gen", "cli_port_ll"):
        g = got["samples"][task]
        w = want["samples"][task]
        assert [s["doc_id"] for s in g] == [s["doc_id"] for s in w]
        if task == "cli_port_gen":
            assert [s["resps"] for s in g] == [s["resps"] for s in w]
        else:
            for a, b in zip(g, w):
                np.testing.assert_allclose(a["resps"][0][0],
                                           b["resps"][0][0], rtol=1e-4)
                assert a["resps"][0][1] == b["resps"][0][1]
    for task in want["results"]:
        assert sorted(got["results"][task]) == sorted(want["results"][task])
        for k, v in want["results"][task].items():
            np.testing.assert_allclose(got["results"][task][k], v,
                                       rtol=1e-9)


def test_cli_writes_the_same_telemetry(cli_runs):
    want, got, _ = cli_runs
    n = 0
    for g, w in zip(got["samples"]["cli_port_gen"],
                    want["samples"]["cli_port_gen"]):
        for part in ("logs_metrics_vision", "logs_metrics_mlp"):
            assert sorted(g[part]) == sorted(w[part])
            for layer in w[part]:
                n += 1
                assert g[part][layer]["top1_hist"] == \
                    w[part][layer]["top1_hist"]
                assert g[part][layer]["top2_hist"] == \
                    w[part][layer]["top2_hist"]
                assert abs(g[part][layer]["entropy"]
                           - w[part][layer]["entropy"]) <= 1e-5
    assert n >= 3 * 3          # two tower layers and the projector


def test_cli_mesh_raises_naming_the_roadmap_item(ckpt_dir, tok_dir):
    """--mesh is ported (tests/test_torch_port_tp_serving.py runs it over
    2 ranks): one process cannot hold a 1x8 mesh, as JAX's needs 8
    devices."""
    from competesmoe_tpu_torch.cli.eval_mm import main
    with pytest.raises(SystemExit, match="needs 8 devices, have 1"):
        main(["--model-dir", str(ckpt_dir), "--tokenizer", tok_dir,
              "--tasks", "cli_port_gen", "--mesh", "1x8",
              "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_needs_a_card_unless_asked(ckpt_dir, tok_dir):
    from competesmoe_tpu_torch.cli.eval_mm import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model-dir", str(ckpt_dir), "--tokenizer", tok_dir,
              "--tasks", "cli_port_gen"])


def test_cli_config_loop_task_yaml_and_logger(ckpt_dir, tok_dir,
                                              tmp_path):
    """A --config list of two runs (the second --load-8bit and engine
    backed), a --task-yaml task, and the results logger's directory."""
    from competesmoe_tpu_torch.cli.eval_mm import main
    stand_ins_of("competesmoe_tpu_torch")
    (tmp_path / "cli_port_yaml.yaml").write_text(
        "task: cli_port_yaml\noutput_type: generate_until\n"
        "doc_to_text: q\ndoc_to_target: a\n"
        "generation_kwargs:\n  max_new_tokens: 2\n"
        "docs:\n  - {q: what color, a: red}\n  - {q: is this, a: yes}\n")
    (tmp_path / "runs.yaml").write_text(
        f"- {{output-path: {tmp_path / 'a'}}}\n"
        f"- {{output-path: {tmp_path / 'b'}, load-8bit: true, "
        f"kv-quant: int8, engine-slots: 2, engine-max-len: 96}}\n")
    results = main(["--model-dir", str(ckpt_dir), "--tokenizer", tok_dir,
                    "--tasks", "cli_port_yaml", "--device", "cpu",
                    "--config", str(tmp_path / "runs.yaml"),
                    "--task-yaml", str(tmp_path / "cli_port_yaml.yaml"),
                    "--log-samples"])
    assert len(results) == 2
    for sub in ("a", "b"):
        files = list((tmp_path / sub).glob("results_*.json"))
        assert len(files) == 1
        data = json.loads(files[0].read_text())
        assert "cli_port_yaml" in data["results"]
        assert len(data["samples"]["cli_port_yaml"]) == 2
    assert results[1]["time_inference"]["n_batches"] == 1   # the engine
