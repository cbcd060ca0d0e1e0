"""Parity of the port's multimodal data pipeline (data/mm_data.py,
multimodal/mm_utils.py) with the JAX package's, and the port's
`cli.train_mm` on the CPU.

The seven conversation preprocessors run on the same conversations with
the same tokenizer (a `tokenizers` BPE wrapped as a fast tokenizer, built
here without a download, as tests/test_cli_mm.py builds one): tokens and
labels must be equal. The dataset reads a JSON and PNGs this test writes;
its items in the default, 'pad' and 'anyres' image modes, the collator's
batches and the sampler's order must be equal element for element (the
pixels too: both use PIL and the same float32 arithmetic).

The CLI trains a small model written by the port's exporter: 2 steps, a
resume that continues the run exactly (its third step equals an
uninterrupted run's), and the refusals.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from competesmoe_tpu.data import mm_data as jdata
from competesmoe_tpu.multimodal import mm_utils as jutils
from competesmoe_tpu_torch.data import mm_data as tdata
from competesmoe_tpu_torch.multimodal import mm_utils as tutils

VERSIONS = ["phi35", "phi3", "v1", "llama_2", "mpt", "smollm"]
PINPOINTS = [[56, 28], [28, 56], [56, 56]]


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    t = Tokenizer(models.BPE(unk_token=None))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=80, special_tokens=["<pad>", "<s>", "</s>", "<|end|>"])
    corpus = ["what is this a cat yes really sure red blue <|user|> "
              "<|assistant|> <|system|> You are helpful assistant "
              "USER ASSISTANT [INST] [/INST] <|im_start|> <|im_end|>"] * 20
    t.train_from_iterator(corpus, trainer)
    from transformers import PreTrainedTokenizerFast
    fast = PreTrainedTokenizerFast(tokenizer_object=t, pad_token="<pad>",
                                   bos_token="<s>", eos_token="</s>")
    fast.save_pretrained(str(d))
    return fast, str(d)


def convo(with_image=True, rounds=2):
    out = []
    for r in range(rounds):
        q = ("<image>\nwhat is this" if with_image and r == 0
             else "sure red ?")
        out += [{"from": "human", "value": q},
                {"from": "gpt", "value": "a cat yes really" * (r + 1)}]
    return out


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("image,rounds", [(True, 1), (True, 3), (False, 2)])
def test_preprocessors_match_jax(tok, version, image, rounds):
    fast, _ = tok
    src = [convo(image, rounds)]
    want = jdata.PREPROCESSORS[version](src, fast, has_image=image,
                                        model_max_length=64)
    got = tdata.PREPROCESSORS[version](src, fast, has_image=image,
                                       model_max_length=64)
    for key in ("input_ids", "labels"):
        assert len(got[key]) == len(want[key]) == 1
        np.testing.assert_array_equal(got[key][0], want[key][0])


def test_preprocess_plain_matches_jax(tok):
    fast, _ = tok
    src = [[{"from": "human", "value": "<image>"},
            {"from": "gpt", "value": "a red cat"}]]
    want = jdata.preprocess_plain(src, fast)
    got = tdata.preprocess_plain(src, fast)
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[key][0], want[key][0])


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    (d / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for name, size in (("a.png", (40, 30)), ("b.png", (30, 50)),
                       ("c.png", (28, 28))):
        px = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(px).save(d / "imgs" / name)
    records = []
    for i in range(8):
        rec = {"id": str(i), "conversations": convo(i % 4 != 3, 1 + i % 2)}
        if i % 4 != 3:
            rec["image"] = ("a.png", "b.png", "c.png")[i % 3]
        records.append(rec)
    records[5]["image"] = ["a.png", "b.png"]
    records[5]["conversations"][0]["value"] = "<image>\n<image>\nwhat"
    (d / "data.json").write_text(json.dumps(records))
    return d


@pytest.mark.parametrize("mode", [None, "pad", "anyres"])
def test_dataset_items_match_jax(tok, data_dir, mode):
    fast, _ = tok
    kw = dict(version="phi35", image_aspect_ratio=mode,
              image_grid_pinpoints=PINPOINTS if mode == "anyres" else None,
              model_max_length=64)
    want = jdata.LazySupervisedDataset(
        data_dir / "data.json", data_dir / "imgs", fast,
        image_processor=jutils.ImageProcessorConfig(size=28), **kw)
    got = tdata.LazySupervisedDataset(
        data_dir / "data.json", data_dir / "imgs", fast,
        image_processor=tutils.ImageProcessorConfig(size=28), **kw)
    assert len(got) == len(want) == 8
    assert got.modality_lengths == want.modality_lengths
    for i in range(len(want)):
        w, g = want[i], got[i]
        assert set(w) == set(g)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]),
                                          err_msg=f"{mode} item {i} {key}")
    if mode == "anyres":
        assert got[0]["image"].shape == (5, 28, 28, 3)   # base + 2 x 2 tiles
    coll_kw = dict(pad_token_id=0, pad_to=80, image_shape=(28, 28, 3))
    items = [got[i] for i in (0, 3)] if mode != "anyres" else [got[0]]
    wb = jdata.SupervisedCollator(**coll_kw)(
        [want[i] for i in ((0, 3) if mode != "anyres" else (0,))])
    gb = tdata.SupervisedCollator(**coll_kw)(items)
    assert set(wb) == set(gb)
    for key in wb:
        np.testing.assert_array_equal(gb[key], wb[key])


def test_image_utils_match_jax():
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (30, 50, 3), dtype=np.uint8))
    proc_j = jutils.ImageProcessorConfig(size=28)
    proc_t = tutils.ImageProcessorConfig(size=28)
    for mode in ("pad", "anyres", None):
        w = jutils.process_images([img, img], proc_j, mode, PINPOINTS)
        g = tutils.process_images([img, img], proc_t, mode, PINPOINTS)
        np.testing.assert_array_equal(g, w)
    sq = tutils.expand2square(img, (127, 127, 127))
    np.testing.assert_array_equal(
        np.asarray(sq), np.asarray(jutils.expand2square(img, (127,) * 3)))
    for size in ((50, 30), (30, 50), (28, 28), (100, 10)):
        assert tutils.select_best_resolution(size, PINPOINTS) == \
            jutils.select_best_resolution(size, PINPOINTS)
        assert tutils.get_anyres_image_grid_shape(size, str(PINPOINTS),
                                                  28) == \
            jutils.get_anyres_image_grid_shape(size, str(PINPOINTS), 28)
    for a, b in zip(tutils.divide_to_patches(sq, 14),
                    jutils.divide_to_patches(sq, 14)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_length_grouped_sampler_matches_jax():
    lengths = [10, 20, -5, -8, 15, -12, 30, 7, -3, 4, 9, -6, 11]
    w = jdata.LengthGroupedSampler(lengths, batch_size=2, seed=3)
    g = tdata.LengthGroupedSampler(lengths, batch_size=2, seed=3)
    for _ in range(3):                       # three epochs
        assert list(iter(g)) == list(iter(w))
    assert g.epoch == w.epoch == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A small CompeteSMoE model written by the port's exporter."""
    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, build_llava, llava_config_from_hf)
    from competesmoe_tpu_torch.models.hf_export import save_hf_checkpoint
    hf = dict(HF_5P1B, vocab_size=96, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, mm_hidden_size=16,
              vision_config=dict(hidden_size=16, intermediate_size=32,
                                 num_hidden_layers=2, num_attention_heads=2,
                                 image_size=28, patch_size=14))
    cfg = llava_config_from_hf(hf, "llava_phi", torch.float32)
    d = tmp_path_factory.mktemp("ckpt")
    save_hf_checkpoint(build_llava(cfg, seed=0, device="cpu"), cfg, d,
                       hf_config=hf)
    return d


@pytest.fixture(scope="module")
def cli_data_dir(tmp_path_factory):
    """Eight records, one image each but every fourth (text-only)."""
    d = tmp_path_factory.mktemp("cli_data")
    (d / "imgs").mkdir()
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    Image.fromarray(px).save(d / "imgs" / "a.png")
    records = [{"id": str(i), "conversations": convo(i % 4 != 3, 1 + i % 2),
                **({"image": "a.png"} if i % 4 != 3 else {})}
               for i in range(8)]
    (d / "data.json").write_text(json.dumps(records))
    return d


def _argv(ckpt_dir, tok, data_dir, out, *extra):
    return ["--data-path", str(data_dir / "data.json"),
            "--image-folder", str(data_dir / "imgs"), "--tokenizer", tok[1],
            "--model-dir", str(ckpt_dir), "--device", "cpu",
            "--image-aspect-ratio", "pad", "--model-max-length", "48",
            "--per-device-batch-size", "2", "--grad-accum", "2",
            "--opt-state-8bit", "--remat", "--rate-flip", "0.5",
            "--learning-rate", "1e-3", "--log-interval", "1",
            "--output-dir", str(out), *extra]


def _losses(out):
    recs = [json.loads(line) for line in
            (out / "log_trainer.jsonl").read_text().splitlines()]
    return {r["step"]: (r["loss/total"], r["grad_norm"]) for r in recs
            if "loss/total" in r}


def test_train_mm_cli_trains_and_resumes_on_cpu(ckpt_dir, tok, cli_data_dir,
                                                tmp_path):
    data_dir = cli_data_dir
    from competesmoe_tpu_torch.cli.train_mm import main
    straight = tmp_path / "straight"
    main(_argv(ckpt_dir, tok, data_dir, straight, "--num-train-steps", "3",
               "--save-interval", "2", "--profile-start-step", "1",
               "--profile-n-steps", "1"))
    want = _losses(straight)
    assert sorted(want) == [0, 1, 2]
    assert all(np.isfinite(v).all() for v in want.values())
    assert (straight / "checkpoint" / "model-3").exists()
    assert any((straight / "trace").glob("*.json"))
    # a run that saved at step 2 resumes there and takes step 3 as the
    # uninterrupted run did
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    import shutil
    (resumed / "checkpoint").mkdir()
    shutil.copytree(straight / "checkpoint" / "model-2",
                    resumed / "checkpoint" / "model-2")
    main(_argv(ckpt_dir, tok, data_dir, resumed, "--num-train-steps", "3",
               "--resume"))
    got = _losses(resumed)
    assert sorted(got) == [2]
    assert got[2] == want[2]
    # LoRA through the CLI, with the eval loss of the adapted model
    lora = tmp_path / "lora"
    main(_argv(ckpt_dir, tok, data_dir, lora, "--num-train-steps", "2",
               "--lora-enable", "--lora-r", "4", "--lora-alpha", "8",
               "--eval-interval", "1", "--eval-data-path",
               str(data_dir / "data.json"), "--eval-batches", "2"))
    recs = [json.loads(line) for line in
            (lora / "log_trainer.jsonl").read_text().splitlines()]
    evals = [r["eval/loss"] for r in recs if "eval/loss" in r]
    assert len(evals) == 1 and np.isfinite(evals[0])
    assert sorted(_losses(lora)) == [0, 1]


def test_train_mm_cli_refusals(ckpt_dir, tok, cli_data_dir, tmp_path):
    data_dir = cli_data_dir
    from competesmoe_tpu_torch.cli.train_mm import main
    # --n-expert is ported (tests/test_torch_port_parallel_train.py): one
    # process cannot hold 2 expert shards, as JAX's mesh refuses it
    with pytest.raises(ValueError, match="not divisible"):
        main(_argv(ckpt_dir, tok, data_dir, tmp_path, "--n-expert", "2"))
    # --moe-name is parsed and chooses nothing, as in JAX: the router is
    # the checkpoint's (competesmoe), so the losses are those of a run
    # without the flag
    runs = {}
    for name, flags in (("xmoe", ("--moe-name", "xmoe")), ("default", ())):
        runs[name] = tmp_path / f"moe-name-{name}"
        main(_argv(ckpt_dir, tok, data_dir, runs[name], "--num-train-steps",
                   "1", *flags))
    assert _losses(runs["xmoe"]) == _losses(runs["default"])
    assert list(_losses(runs["xmoe"])) == [0]
    with pytest.raises(ValueError, match="allow-tiny-dataset"):
        main(_argv(ckpt_dir, tok, data_dir, tmp_path,
                   "--per-device-batch-size", "16"))
    with pytest.raises(SystemExit):
        main(["--data-path", "x", "--tokenizer", tok[1], "--device", "cpu"])
