"""Parity of the PyTorch port's checkpoint slice with the JAX package: the
safetensors reader and writer, the HF -> port converters, the loader
(bf16/f32, --load-8bit, --load-4bit, LoRA), the exporter, and the LM
trainer's Saver with -restore.

Both packages read the same files: the released-layout checkpoint
`tests/fixtures/golden_tiny_ckpt/` (weights out of the reference model,
greedy tokens recorded in `golden_tiny_digests.json`), the 5.1B key
manifest, and files the tests write. Greedy tokens must be identical and
converted weights bit for bit equal; other tolerances are stated with
their tests.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import hf_export as jexport
from competesmoe_tpu.models import hf_loader as jloader
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import hf_export as texport
from competesmoe_tpu_torch.models import hf_loader as tloader
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.models import safetensors_io as sio
from competesmoe_tpu_torch.train.checkpoint import Saver
from tests.test_torch_port_lm import _TINY_FLAGS

FIXTURES = Path(__file__).parent / "fixtures"
GOLDEN = FIXTURES / "golden_tiny_ckpt"
DIGESTS = json.loads((FIXTURES / "golden_tiny_digests.json").read_text())


def golden_inputs():
    """The generator's prompts and pixels, in its draw order
    (tests/test_golden_layout.py)."""
    vocab = DIGESTS["geometry"]["vocab_size"]
    rng = np.random.default_rng(4)
    ids_img = rng.integers(2, vocab, (1, 7)).astype(np.int32)
    ids_img[0, 1] = tllava.IMAGE_TOKEN_INDEX
    px = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    ids_txt = rng.integers(2, vocab, (1, 9)).astype(np.int32)
    assert ids_img[0].tolist() == DIGESTS["prompt_image"]
    assert ids_txt[0].tolist() == DIGESTS["prompt_text"]
    return ids_img, px, ids_txt


def port_load(path=GOLDEN, **kw):
    _, model, _, _ = tbuilder.load_pretrained_model(
        path, dtype=torch.float32, device="cpu", **kw)
    return model


def jax_load(path=GOLDEN, **kw):
    _, model, variables, _, _ = jbuilder.load_pretrained_model(
        path, dtype=jnp.float32, **kw)
    return model, variables


def port_tokens(model, ids, px, n=8):
    return tllava.generate(model, ids, px, max_new_tokens=n)[0][0].tolist()


def jax_tokens(model, variables, ids, px, n=8):
    toks, _ = jllava.generate(model, variables, ids, px, max_new_tokens=n)
    return np.asarray(toks)[0].tolist()


def spliced_labels(model, ids, px):
    """The labels of the image splice for labels = the prompt."""
    with torch.no_grad():
        ids_t = torch.as_tensor(ids, dtype=torch.long)
        feats = model.encode_images(torch.as_tensor(px))[0]
        embeds = model.language_model.embed(torch.clamp(ids_t, min=0))
        out = tllava.splice_image_tokens(ids_t, embeds, feats, labels=ids_t)
    return out["labels"][0].tolist()


def assert_same_state(got, want):
    """Key for key, bit for bit (dtype and shape included)."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# (a), (b): the loader on the golden checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_port():
    return port_load()


@pytest.fixture(scope="module")
def golden_jax():
    return jax_load()


def test_loader_reproduces_the_golden_digests(golden_port):
    ids_img, px, ids_txt = golden_inputs()
    assert port_tokens(golden_port, ids_img, px) == \
        DIGESTS["greedy_tokens_image"]
    assert port_tokens(golden_port, ids_txt, None) == \
        DIGESTS["greedy_tokens_text"]
    assert spliced_labels(golden_port, ids_img, px) == \
        DIGESTS["spliced_labels_image"]


def test_loaded_logits_match_jax(golden_port, golden_jax):
    """Full-sequence logits of both prompts, within 1e-4 of the largest
    |logit| (float32 both sides, different summation orders)."""
    jm, jv = golden_jax
    ids_img, px, ids_txt = golden_inputs()
    for ids, pix in ((ids_img, px), (ids_txt, None)):
        want = np.asarray(jm.apply(jv, jnp.asarray(ids), None if pix is None
                                   else jnp.asarray(pix)).logits)
        with torch.no_grad():
            got = golden_port(torch.as_tensor(ids, dtype=torch.long),
                              None if pix is None else torch.as_tensor(pix)
                              ).logits.numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_checkpoint_with_phi35_sliding_window_loads_as_jax(tmp_path):
    """The golden checkpoint with Phi-3.5-mini's published
    `sliding_window: 262144` in its config.json: JAX's builder and the
    port's both load it with the field (the port used to refuse it), and
    the port's greedy tokens are the golden digests, as without it."""
    for f in GOLDEN.iterdir():
        shutil.copy(f, tmp_path / f.name)
    hf = json.loads((GOLDEN / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(
        dict(hf, sliding_window=262144)))
    assert jax_load(tmp_path)[0].cfg.decoder.sliding_window == 262144
    model = port_load(tmp_path)
    assert model.cfg.decoder.sliding_window == 262144
    ids_img, px, ids_txt = golden_inputs()
    assert port_tokens(model, ids_img, px) == DIGESTS["greedy_tokens_image"]
    assert port_tokens(model, ids_txt, None) == \
        DIGESTS["greedy_tokens_text"]


# ---------------------------------------------------------------------------
# (c), (d): the converters
# ---------------------------------------------------------------------------

def _dense_tower_sd(sd):
    """A dense SigLIP tower from the golden MoE tower: expert 0's MLP as
    `mlp.fc1/fc2`, no gate."""
    prefix = "model.vision_tower.vision_tower."
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix) or ".moelayer.gate." in k:
            continue
        k = k[len(prefix):]
        if ".moelayer.experts." in k:
            head, rest = k.split(".moelayer.experts.")
            expert, rest = rest.split(".", 1)
            if expert != "0":
                continue
            k = f"{head}.mlp.{rest}"
        out[k] = v
    return out


@pytest.mark.parametrize("case", ["trained", "upcycle"])
def test_converted_state_dict_equals_jax_bit_for_bit(case):
    """trained: `convert_llava_checkpoint` of the golden checkpoint;
    upcycle: a dense tower and a dense 2-layer projector replicated into
    every expert with fresh gates from default_rng(42). Either way the
    port's state dict equals `from_jax_params` of JAX's conversion."""
    tsd = tloader.load_torch_state_dict(GOLDEN)
    jsd = jloader.load_torch_state_dict(GOLDEN)
    if case == "trained":
        jcfg = jbuilder.llava_config_from_hf(
            json.loads((GOLDEN / "config.json").read_text()), GOLDEN.name,
            jnp.float32)
        tcfg = tbuilder.llava_config_from_hf(
            json.loads((GOLDEN / "config.json").read_text()), GOLDEN.name,
            torch.float32)
        want = from_jax_params(jbuilder.convert_llava_checkpoint(jsd, jcfg))
        got = tbuilder.convert_llava_checkpoint(tsd, tcfg)
        assert_same_state(got, want)
        return
    tcfg = tbuilder.llava_config_from_hf(
        json.loads((GOLDEN / "config.json").read_text()), "", torch.float32)
    jcfg = jbuilder.llava_config_from_hf(
        json.loads((GOLDEN / "config.json").read_text()), "", jnp.float32)
    dense_t = _dense_tower_sd(tsd)
    dense_j = {k: v.numpy() for k, v in dense_t.items()}
    got = tloader.convert_siglip_tower(dense_t, tcfg.vision, prefix="",
                                       upcycle=True)
    want = from_jax_params(jloader.convert_siglip_tower(
        dense_j, jcfg.vision, prefix="", upcycle=True))
    assert_same_state(got, want)
    proj = {f"{i}.{kind}": tsd[f"model.mm_projector.moelayer.experts.1."
                               f"{i}.{kind}"]
            for i in ("0", "2") for kind in ("weight", "bias")}
    got = tloader.convert_mlpmoe_projector({}, 4, prefix="",
                                           upcycle_from=proj)
    want = from_jax_params(jloader.convert_mlpmoe_projector(
        {}, 4, prefix="", upcycle_from={k: v.numpy()
                                        for k, v in proj.items()}))
    assert_same_state(got, want)
    # every expert is the dense MLP; the gates are fresh, not zero
    w1 = got["moelayer.experts_w1"]
    assert all(torch.equal(w1[i], w1[0]) for i in range(4))
    assert got["moelayer.gate_kernel"].abs().max() > 0


def test_5p1b_manifest_fills_every_parameter():
    """Meta tensors of every key and shape of the released 5.1B layout:
    the converter reads all 998 and fills every parameter of
    LlavaModel(HF_5P1B) on the meta device with its shape, none left over
    or missing."""
    manifest = json.loads((FIXTURES / "golden_5p1b_keys.json").read_text())
    assert manifest["n_keys"] == len(manifest["keys"]) == 998
    geo = manifest["geometry"]
    hf = tbuilder.HF_5P1B
    for key in ("hidden_size", "intermediate_size", "num_hidden_layers",
                "vocab_size", "num_experts", "mm_hidden_size"):
        assert hf[key] == geo[key], key
    for key, val in geo["vis"].items():
        assert hf["vision_config"][key] == val, key
    sd = tloader.ReadTracker({k: torch.empty(shape, device="meta")
                   for k, shape in manifest["keys"].items()})
    cfg = tbuilder.llava_config_from_hf(hf, "llava_phi", torch.bfloat16)
    got = tbuilder.convert_llava_checkpoint(sd, cfg)
    assert sd.read == set(manifest["keys"]) and not sd.unread()
    model = tllava.LlavaModel(cfg, device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert sum(int(np.prod(s)) for s in want.values()) == \
        manifest["total_params"]


def test_loader_is_strict(tmp_path):
    """A missing or an extra tensor fails the load, naming it; nothing is
    filled from a seed."""
    sd = sio.load_file(GOLDEN / "model.safetensors")
    shutil.copy(GOLDEN / "config.json", tmp_path / "config.json")
    missing = dict(sd)
    del missing["model.layers.1.mlp.down_proj.weight"]
    sio.save_file(missing, tmp_path / "model.safetensors")
    with pytest.raises(KeyError, match="down_proj"):
        port_load(tmp_path)
    extra = dict(sd)
    extra["model.layers.2.mlp.down_proj.weight"] = torch.zeros(3)
    sio.save_file(extra, tmp_path / "model.safetensors")
    with pytest.warns(UserWarning, match=r"layers\.2"):
        port_load(tmp_path)
    model = tllava.LlavaModel(port_load().cfg, device="meta")
    converted = tbuilder.convert_llava_checkpoint(sd, model.cfg)
    converted["vision_tower.extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match=r"vision_tower\.extra"):
        tbuilder._load_converted(model, converted, torch.device("cpu"))
    wrong = dict(sd)
    wrong["model.norm.weight"] = torch.ones(47)
    sio.save_file(wrong, tmp_path / "model.safetensors")
    with pytest.raises(ValueError, match="norm"):
        port_load(tmp_path)


# ---------------------------------------------------------------------------
# (e): the safetensors reader and writer, and the file rules
# ---------------------------------------------------------------------------

def test_safetensors_reader_agrees_with_the_safetensors_package():
    from safetensors.numpy import load_file
    want = load_file(str(GOLDEN / "model.safetensors"))
    got = sio.load_file(GOLDEN / "model.safetensors")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int8])
def test_safetensors_round_trip(tmp_path, dtype):
    """Writer then reader, several shapes (0-d, empty, odd sizes) in one
    file with an int64 and a uint8 tensor beside them; the file also reads
    with the safetensors package, for the dtypes numpy has."""
    g = torch.Generator().manual_seed(0)
    tensors = {}
    for i, shape in enumerate([(), (0,), (3,), (5, 7), (2, 3, 4)]):
        x = torch.randn(shape, generator=g) * 50
        tensors[f"t{i}"] = x.to(dtype)
    tensors["index"] = torch.arange(5, dtype=torch.int64)
    tensors["byte"] = torch.arange(3, dtype=torch.uint8)
    path = sio.save_file(tensors, tmp_path / "x.safetensors",
                         metadata={"format": "pt"})
    assert (8 + len(json.dumps(sio.read_header(path),
                               separators=(",", ":")))) <= \
        path.stat().st_size
    assert sio.read_header(path)["__metadata__"] == {"format": "pt"}
    got = sio.load_file(path)
    assert_same_state(got, tensors)
    if dtype != torch.bfloat16:
        from safetensors.numpy import load_file
        other = load_file(str(path))
        for k, v in tensors.items():
            np.testing.assert_array_equal(other[k], v.numpy())


def test_two_shards_load_like_one_file(tmp_path):
    sd = sio.load_file(GOLDEN / "model.safetensors")
    names = sorted(sd)
    half = len(names) // 2
    sio.save_file({k: sd[k] for k in names[:half]},
                  tmp_path / "model-00001-of-00002.safetensors")
    sio.save_file({k: sd[k] for k in names[half:]},
                  tmp_path / "model-00002-of-00002.safetensors")
    assert_same_state(tloader.load_torch_state_dict(tmp_path), sd)
    shutil.copy(GOLDEN / "config.json", tmp_path / "config.json")
    assert_same_state(port_load(tmp_path).state_dict(),
                      port_load().state_dict())


def test_state_dict_file_rules(tmp_path):
    """A directory's *.bin files load when it has no *.safetensors; a
    directory with neither raises naming what it holds."""
    sd = sio.load_file(GOLDEN / "model.safetensors")
    names = sorted(sd)
    torch.save({k: sd[k] for k in names[:10]}, tmp_path / "a.bin")
    torch.save({k: sd[k].to(torch.bfloat16) for k in names[10:]},
               tmp_path / "b.bin")
    got = tloader.load_torch_state_dict(tmp_path)
    assert sorted(got) == names
    assert torch.equal(got[names[0]], sd[names[0]])
    assert got[names[-1]].dtype == torch.bfloat16
    assert_same_state(tloader.load_torch_state_dict(tmp_path / "a.bin"),
                      {k: sd[k] for k in names[:10]})
    lone = tmp_path / "lone"
    lone.mkdir()
    torch.save({}, lone / "weights.pt")
    with pytest.raises(FileNotFoundError, match=r"weights\.pt"):
        tloader.load_torch_state_dict(lone)
    # the CLIP tower and MPT convert now (held to JAX in
    # tests/test_torch_port_clip.py and test_torch_port_decoder_opts.py)
    from competesmoe_tpu_torch.models.decoder import DecoderConfig
    from competesmoe_tpu_torch.models.vision import VisionConfig
    vis = VisionConfig(hidden_size=8, num_hidden_layers=0, image_size=28,
                       tower_type="clip", use_cls_token=True)
    clip = {"vision_model.embeddings.patch_embedding.weight":
            torch.zeros(8, 3, 14, 14),
            "vision_model.embeddings.class_embedding": torch.zeros(8),
            "vision_model.embeddings.position_embedding.weight":
            torch.zeros(5, 8),
            "vision_model.pre_layrnorm.weight": torch.ones(8),
            "vision_model.pre_layrnorm.bias": torch.zeros(8)}
    assert sorted(tloader.convert_clip_tower(clip, vis)) == [
        "embeddings.class_embedding", "embeddings.patch_embedding.weight",
        "embeddings.position_embedding", "pre_layrnorm.bias",
        "pre_layrnorm.weight"]
    mpt = {"transformer.wte.weight": torch.zeros(16, 8),
           "transformer.norm_f.weight": torch.ones(8)}
    assert sorted(tloader.convert_mpt(mpt, DecoderConfig(
        num_hidden_layers=0, tie_word_embeddings=True))) == [
            "embed_tokens.weight", "norm.weight"]


# ---------------------------------------------------------------------------
# (f): --load-4bit and --load-8bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["load_4bit", "load_8bit"])
def test_quantized_load_matches_jax(flag):
    """The quantized model's buffers (kernel_q bytes, scales) and every
    other tensor equal `from_jax_params` of JAX's quantized params; greedy
    tokens of both prompts are identical."""
    model = port_load(**{flag: True, "kv_quant": "int8"})
    jm, jv = jax_load(**{flag: True, "kv_quant": "int8"})
    want = from_jax_params(jv)
    got = model.state_dict()
    assert any(k.endswith("kernel_q") for k in got)
    assert_same_state(got, want)
    assert model.cfg.decoder.kv_quant == "int8"
    assert model.cfg.decoder.quant == ("int4" if flag == "load_4bit"
                                       else "int8")
    ids_img, px, ids_txt = golden_inputs()
    for ids, pix in ((ids_img, px), (ids_txt, None)):
        assert port_tokens(model, ids, pix) == jax_tokens(jm, jv, ids, pix)


# ---------------------------------------------------------------------------
# (g): LoRA
# ---------------------------------------------------------------------------

def _write_lora(path: Path, use_safetensors: bool) -> None:
    """A LoRA adapter for the golden checkpoint (r 4, alpha 8) on two
    decoder projections, and a non-LoRA projector gate."""
    g = torch.Generator().manual_seed(3)
    path.mkdir()
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": 4, "lora_alpha": 8}))
    adapter = {}
    for target, (o, i) in (("model.layers.0.self_attn.qkv_proj", (144, 48)),
                           ("model.layers.1.mlp.down_proj", (48, 96))):
        base = f"base_model.model.{target}"
        adapter[f"{base}.lora_A.weight"] = torch.randn(4, i, generator=g)
        adapter[f"{base}.lora_B.weight"] = torch.randn(o, 4, generator=g)
    if use_safetensors:
        sio.save_file(adapter, path / "adapter_model.safetensors")
    else:
        torch.save(adapter, path / "adapter_model.bin")
    torch.save({"base_model.model.model.mm_projector.moelayer.gate.weight":
                torch.randn(4, 32, generator=g)},
               path / "non_lora_trainables.bin")
    shutil.copy(GOLDEN / "config.json", path / "config.json")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_lora_merge_matches_jax(tmp_path, fmt):
    """Merged weights within 1e-6 of JAX's `merge_lora_checkpoint`; the
    adapter loads through `load_pretrained_model` with a base, and its
    logits match JAX's loader within 1e-4 of the largest."""
    lora = tmp_path / "tiny-lora"
    _write_lora(lora, fmt == "safetensors")
    got = tbuilder.merge_lora_checkpoint(
        tloader.load_torch_state_dict(GOLDEN), lora)
    want = jbuilder.merge_lora_checkpoint(
        jloader.load_torch_state_dict(GOLDEN), lora)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-6)
    assert not np.array_equal(
        want["model.layers.0.self_attn.qkv_proj.weight"],
        jloader.load_torch_state_dict(GOLDEN)[
            "model.layers.0.self_attn.qkv_proj.weight"])
    model = port_load(lora, model_name="tiny-lora", model_base=str(GOLDEN))
    jm, jv = jax_load(lora, model_name="tiny-lora", model_base=str(GOLDEN))
    ids_img, px, _ = golden_inputs()
    want_l = np.asarray(jm.apply(jv, jnp.asarray(ids_img),
                                 jnp.asarray(px)).logits)
    with torch.no_grad():
        got_l = model(torch.as_tensor(ids_img, dtype=torch.long),
                      torch.as_tensor(px)).logits.numpy()
    assert np.abs(got_l - want_l).max() <= 1e-4 * np.abs(want_l).max()


# ---------------------------------------------------------------------------
# (h): the exporter
# ---------------------------------------------------------------------------

def test_export_loads_in_jax_and_equals_jax_export(tmp_path, golden_port,
                                                   golden_jax):
    hf_cfg = json.loads((GOLDEN / "config.json").read_text())
    path = texport.save_hf_checkpoint(golden_port, golden_port.cfg,
                                      tmp_path / "out", hf_config=hf_cfg)
    assert path.name == "model.safetensors"
    jm, jv = jax_load(tmp_path / "out")
    ids_img, px, ids_txt = golden_inputs()
    assert jax_tokens(jm, jv, ids_img, px) == DIGESTS["greedy_tokens_image"]
    assert jax_tokens(jm, jv, ids_txt, None) == DIGESTS["greedy_tokens_text"]
    _, gv = golden_jax
    want = jexport.export_llava_checkpoint(gv["params"], _jax_cfg())
    got = sio.load_file(path)
    assert sorted(got) == sorted(want) == sorted(DIGESTS["state_dict_keys"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_export_keeps_bf16_and_refuses_quantized(tmp_path):
    model = tbuilder.load_pretrained_model(GOLDEN, dtype=torch.bfloat16,
                                           device="cpu")[1]
    path = texport.save_hf_checkpoint(
        model, model.cfg, tmp_path,
        hf_config=json.loads((GOLDEN / "config.json").read_text()))
    assert {v["dtype"] for k, v in sio.read_header(path).items()} == {"BF16"}
    back = tbuilder.load_pretrained_model(tmp_path, dtype=torch.bfloat16,
                                          device="cpu")[1]
    assert_same_state(back.state_dict(), model.state_dict())
    tbuilder.apply_load_4bit(model)
    with pytest.raises(ValueError, match="before quantizing"):
        texport.export_llava_checkpoint(model)


def _jax_cfg():
    return jbuilder.llava_config_from_hf(
        json.loads((GOLDEN / "config.json").read_text()), GOLDEN.name,
        jnp.float32)


# ---------------------------------------------------------------------------
# (i): the Saver and the LM trainer's -restore
# ---------------------------------------------------------------------------

class _Counter:
    def __init__(self):
        self.n = 0

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, d):
        self.n = d["n"]


def test_saver_retention_atomic_publish_and_tick(tmp_path):
    lin = torch.nn.Linear(3, 2)
    counter = _Counter()
    saver = Saver(tmp_path, save_interval=2, keep_last=2)
    saver["model"], saver["counter"], saver["args"] = lin, counter, {"a": 1}
    assert saver.tick(1) is None and saver.tick(0) is None
    for step in (2, 3, 4, 6):
        counter.n = step
        if saver.tick(step) is None:
            saver.save(step)
    assert saver.saved_steps() == [4, 6] and saver.latest_step() == 6
    meta = json.loads((tmp_path / "model-6" / "META.json").read_text())
    assert meta == {"step": 6, "elements": {
        "model": "torch", "counter": "json", "args": "json_value"}}
    assert not list(tmp_path.glob(".tmp-*"))
    # a half-written checkpoint is never read
    (tmp_path / ".tmp-model-8").mkdir()
    assert saver.latest_step() == 6
    want = {k: v.clone() for k, v in lin.state_dict().items()}
    with torch.no_grad():
        lin.weight.zero_()
    counter.n, saver["args"] = -1, {}
    assert saver.restore() == 6
    assert_same_state(lin.state_dict(), want)
    assert counter.n == 6 and saver["args"] == {"a": 1}
    assert saver.restore(4) == 4 and counter.n == 4
    with pytest.raises(FileNotFoundError):
        Saver(tmp_path / "empty").restore()


def _task(run_dir, *flags):
    from competesmoe_tpu_torch.train.lm_task import get_task
    from competesmoe_tpu_torch.utils.argparser import build_parser
    a = build_parser().parse(_TINY_FLAGS + ["-run_dir", str(run_dir),
                                            "-name", "t", "-device", "cpu",
                                            *flags])
    return get_task(a.task)(a)


def _logged(run_dir, key):
    recs = [json.loads(line) for line in
            (run_dir / "t" / "log_trainer.jsonl").read_text().splitlines()]
    return [(r["step"], r[key]) for r in recs]


def test_lm_restore_continues_the_run_exactly(tmp_path):
    """4 steps straight, against 2 steps, a save, a fresh task with
    -restore of the step directory and 2 more: the same losses and grad
    norms, bit for bit, on the CPU. A task in the run directory resumes
    by itself; the run's end is saved."""
    straight = _task(tmp_path / "a")
    straight.train()
    cut = _task(tmp_path / "b", "-save_interval", "2")
    cut.train(n_steps=2)
    step_dir = tmp_path / "b" / "t" / "checkpoint" / "model-2"
    assert step_dir.is_dir()
    resumed = _task(tmp_path / "c", "-restore", str(step_dir))
    assert resumed.state.step == 2 and resumed.sampler.pos == 2
    resumed.train()
    for key in ("loss/total", "grad_norm"):
        assert _logged(tmp_path / "a", key)[2:] == \
            _logged(tmp_path / "c", key)
        assert _logged(tmp_path / "a", key)[:2] == \
            _logged(tmp_path / "b", key)
    # the foreign checkpoint directory took the later saves
    assert Saver(step_dir.parent).saved_steps() == [2, 4]
    auto = _task(tmp_path / "b")
    assert auto.state.step == 4 and auto.sampler.pos == 4
    for a, b in zip(auto.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="step 7"):
        _task(tmp_path / "d", "-restore", "7")


def test_restored_flip_schedule_replaces_a_rebuilt_one(tmp_path, capsys):
    """The flip schedule rides along as JSON; a restore under another
    -stop_after (so another rebuilt schedule) competes by the saved one."""
    first = _task(tmp_path, "-save_interval", "2")
    first.train(n_steps=2)
    saved = first.schedule
    other = _task(tmp_path / "x", "-stop_after", "9", "-restore",
                  str(tmp_path / "t" / "checkpoint"))
    assert "restoring original flip schedule from checkpoint" in \
        capsys.readouterr().out
    assert np.array_equal(other.schedule.flips, saved.flips)
    assert other.model.flip_schedule is other.schedule
    assert other.schedule.step_warm == saved.step_warm
    same = _task(tmp_path)
    assert "restoring original" not in capsys.readouterr().out
    assert same.state.step == 2


def test_args_round_trip_through_the_checkpoint(tmp_path):
    from competesmoe_tpu_torch.utils.argparser import ArgumentParser
    task = _task(tmp_path, "-save_interval", "2")
    task.train(n_steps=2)
    saved = json.loads((tmp_path / "t" / "checkpoint" / "model-2" /
                        "args.json").read_text())
    assert saved == ArgumentParser.namespace_to_dict(task.a)
    assert saved["lm.unroll"] == 16 and saved["moe.impl"] == "fused"
    assert dataclasses.is_dataclass(task.state)
