"""Parity of the PyTorch port's ops and MoE layers with the JAX package.

Inputs are made with numpy from a seed and fed to both; weights go from
the flax param tree to the port through `convert.from_jax_params`.
Tolerance: float32 rtol/atol 1e-4 (reordered f32 sums) unless a test
states another.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu.moe import MoEArgs as JMoEArgs
from competesmoe_tpu.moe import layers as jlayers
from competesmoe_tpu.ops import expert_compute as jec
from competesmoe_tpu.ops import matvec as jmatvec
from competesmoe_tpu.ops import routing as jrouting
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.ops import expert_compute as tec
from competesmoe_tpu_torch.ops import matvec as tmatvec
from competesmoe_tpu_torch.ops import routing as trouting

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_topk_softmax_forced_ties():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    logits[:16] = 0.5                              # all eight tied
    logits[16:32, 2] = logits[16:32, 5]            # pairwise ties
    logits[32:48] = np.round(logits[32:48])        # many small-int ties
    jw, jsel, jsm = jrouting.topk_softmax(jnp.asarray(logits), 3)
    tw, tsel, tsm = trouting.topk_softmax(t(logits), 3)
    np.testing.assert_array_equal(np.asarray(jsel), tsel.numpy())
    close(jw, tw)
    close(jsm, tsm)
    close(jrouting.normalize_weights(jw), trouting.normalize_weights(tw))


# ---------------------------------------------------------------------------
# expert compute
# ---------------------------------------------------------------------------

def _ffn_inputs(T=24, d=16, h=12, v=20, E=8, k=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    sel = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    sel[:5] = sel[0]                               # crowd one expert
    w = rng.uniform(0.1, 1.0, size=(T, k)).astype(np.float32)
    w1 = rng.normal(size=(E, d, h)).astype(np.float32) * 0.3
    b1 = rng.normal(size=(E, h)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(E, h, v)).astype(np.float32) * 0.3
    b2 = rng.normal(size=(E, v)).astype(np.float32) * 0.1
    return x, sel.astype(np.int32), w, w1, b1, w2, b2


@pytest.mark.parametrize("impl", ["dense", "grouped", "auto"])
def test_moe_ffn_mlp2(impl):
    args = _ffn_inputs()
    want = jec.moe_ffn_mlp2(*map(jnp.asarray, args), impl=impl)
    got = tec.moe_ffn_mlp2(*map(t, args), impl=impl)
    close(want, got)


def test_sort_by_expert_stable():
    sel = _ffn_inputs()[1]
    jg = jec.sort_by_expert(jnp.asarray(sel), 8)
    tg = tec.sort_by_expert(t(sel), 8)
    for f in ("perm", "inv_perm", "token_ids", "sel_sorted",
              "group_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f).numpy())


# ---------------------------------------------------------------------------
# MoE layers
# ---------------------------------------------------------------------------

def _port_moe_args(a: JMoEArgs):
    from competesmoe_tpu_torch.moe import MoEArgs
    return MoEArgs(**dataclasses.asdict(a))


@pytest.mark.parametrize("name,act,return_ids", [
    ("smoe", "gelu", True), ("smoe", "gelu_tanh", False),
    ("competesmoe", "gelu", True), ("competesmoe", "quick_gelu", False)])
def test_moe_layer_router_branch(name, act, return_ids):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    jcls = {"smoe": jlayers.SMoELayer,
            "competesmoe": jlayers.CompeteSMoELayer}[name]
    jl = jcls(in_dim=16, out_dim=12, n_experts=4, n_selected=2,
              expert_hidden_dim=20, expert_act=act)
    params = jl.init(jax.random.PRNGKey(3), jnp.asarray(x))
    jout, jaux = jl.apply(params, jnp.asarray(x),
                          return_id_experts=return_ids)
    from competesmoe_tpu_torch.moe import get_moe
    pl = get_moe(name)(16, 12, n_experts=4, n_selected=2,
                       args=_port_moe_args(jl.args), expert_hidden_dim=20,
                       expert_act=act, device="cpu")
    pl.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        tout, taux = pl(t(x), return_id_experts=return_ids)
    close(jout, tout)
    close(jaux.aux_loss, taux.aux_loss)
    assert set(jaux.losses) == set(taux.losses)
    for key in jaux.losses:
        close(jaux.losses[key], taux.losses[key])
    if jaux.selected_experts is not None:
        np.testing.assert_array_equal(np.asarray(jaux.selected_experts),
                                      taux.selected_experts.numpy())
        close(jaux.gate_softmax, taux.gate_softmax)


def test_competesmoe_training_schedule_raises():
    from competesmoe_tpu_torch.moe import get_moe
    layer = get_moe("competesmoe")(8, 8, device="cpu",
                                   flip_schedule=np.ones(4, bool))
    tbuilder.init_random_(layer)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer(torch.zeros(1, 2, 8), step=1, train=True)


# ---------------------------------------------------------------------------
# K5: packed-int4 decode matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 40, 128])   # plain / verify / cap
def test_int4_reference_matches_pallas_kernel(m):
    """The port's plain version of the kernel against JAX's Pallas kernel
    in interpret mode, in the kernel's working type (bf16 out). Both sum
    exact bf16 x int4 products in float32 in different orders, so the
    bf16 outputs may differ by one ulp: tolerance 2^-7 * max|ref|."""
    k, n = 1024, 256
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-8, 8, size=(k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-3, size=(n,)).astype(np.float32)
    assert jmatvec.small_m_viable_int4(m, k, n)
    assert tmatvec.small_m_viable_int4(m, k, n)
    want = jmatvec.quant_small_m_matmul_int4(
        jnp.asarray(x, jnp.bfloat16), jdec.pack_int4(jnp.asarray(q)),
        jnp.asarray(scale), interpret=True)
    xb = t(x).to(torch.bfloat16)
    packed = tdec.pack_int4(t(q))
    before = tmatvec.quant_small_m_matmul_int4.launches
    got = tmatvec.quant_small_m_matmul_int4(xb, packed, t(scale))
    ref = tmatvec.quant_small_m_matmul_int4_reference(xb, packed, t(scale))
    # a CPU tensor runs the plain version, never the kernel
    assert tmatvec.quant_small_m_matmul_int4.launches == before
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    want = np.asarray(want.astype(jnp.float32))
    tol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_pack_int4_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.integers(-8, 8, size=(64, 24)).astype(np.int8)
    tp = tdec.pack_int4(t(q))
    np.testing.assert_array_equal(np.asarray(jdec.pack_int4(jnp.asarray(q))),
                                  tp.numpy())
    np.testing.assert_array_equal(
        torch.cat(tmatvec.unpack_int4_halves(tp)).numpy(), q)
    for a, b in zip(jdec.unpack_int4_halves(jnp.asarray(tp.numpy())),
                    tmatvec.unpack_int4_halves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_split_k_covers_decode_shapes():
    """The cluster splits of K3, K4 and K5 at the decode shapes. K3 (64
    outputs a block, 128-K stages, one block an SM), K4 (128 outputs,
    64-K stages, 1.5 blocks an SM) and K5 (128 outputs, 64 packed rows of
    K a stage, 1.5 blocks an SM) share one rule: the splits of a block of
    outputs are one thread-block cluster (at most 8), each a whole number
    of stages, covering K (K5: its packed rows, K / 2) once, with enough
    blocks for their share of 132 SMs where K allows two stages a split.
    K4 and K5 take every row of x in one pass, so their splits are the same
    at M 1, 8, 40 and 128 (K5's old rule grew the grid by one block per 8
    rows)."""
    mv = tmatvec
    for k, n in ((3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072),
                 (256, 768), (512, 256), (128, 384), (1024, 256)):
        for geometry, rows in ((mv._K3_GEOMETRY, k), (mv._K4_GEOMETRY, k),
                               (mv._K5_GEOMETRY, k // 2)):
            block_out, stage_k, fill = geometry
            splits, chunk = mv._cluster_splits(rows, n, 132, geometry)
            blocks = -(-n // block_out)
            assert 1 <= splits <= mv._MAX_SPLITS
            assert chunk % stage_k == 0
            assert splits * chunk >= rows > (splits - 1) * chunk
            assert (blocks * splits >= fill * 132
                    or splits == mv._MAX_SPLITS
                    or rows < 4 * splits * stage_k)
    # the 5.1B decoder's projections: K3 splits o_proj and down_proj in
    # clusters of 4; K4 (half the blocks) splits all four, as does K5, the
    # same at every M the engine gives them (decode 8, verify 40, prefill
    # 128)
    decode = ((3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072))
    assert [mv._cluster_splits(k, n, 132, mv._K3_GEOMETRY)
            for k, n in decode] == [(1, 3072), (4, 768), (1, 3072),
                                    (4, 2048)]
    for m in (1, 8, 40, 128):
        assert tmatvec.small_m_viable(m, 3072, 3072,
                                      max_m=tmatvec.MAX_QUANT_M)
        assert tmatvec.small_m_viable_int4(m, 3072, 3072)
        assert [mv._cluster_splits(k, n, 132, mv._K4_GEOMETRY)
                for k, n in decode] == [(4, 768), (8, 384), (2, 1536),
                                        (8, 1024)]
        assert [mv._cluster_splits(k // 2, n, 132, mv._K5_GEOMETRY)
                for k, n in decode] == [(4, 384), (8, 192), (2, 768),
                                        (8, 512)]


def test_small_m_viability_matches_jax():
    for m in (1, 7, 8, 32, 33, 40, 127, 128, 136):
        for k, n in ((3072, 9216), (8192, 3072), (3072, 32064), (24, 72)):
            assert (tmatvec.small_m_viable_int4(m, k, n)
                    == jmatvec.small_m_viable_int4(m, k, n)), (m, k, n)


# ---------------------------------------------------------------------------
# Quantizers and QuantDense
# ---------------------------------------------------------------------------

def _tiny_decoder_cfgs(**kw):
    jcfg = jdec.DecoderConfig(vocab_size=96, hidden_size=32,
                              intermediate_size=48, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              fused_qkv=True, max_position_embeddings=128,
                              original_max_position_embeddings=128,
                              dtype=jnp.float32, **kw)
    return jcfg, port_config(jcfg, tdec.DecoderConfig)


def port_config(jcfg, cls):
    """The port's config dataclass with the same field values."""
    from competesmoe_tpu_torch.moe import MoEArgs
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcfg, f.name)
        if f.name == "dtype":
            v = torch.float32
        elif f.name == "moe_args":
            v = MoEArgs(**dataclasses.asdict(v))
        kw[f.name] = v
    return cls(**kw)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_decoder_matches_jax(bits):
    jcfg, tcfg = _tiny_decoder_cfgs()
    ids = np.random.default_rng(6).integers(0, 96, (1, 5))
    params = jdec.DecoderLM(jcfg).init(jax.random.PRNGKey(7),
                                       jnp.asarray(ids))["params"]
    jq = jbuilder.quantize_decoder_to_int8(
        jax.tree_util.tree_map(np.asarray, params), bits=bits)
    model = tdec.DecoderLM(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    tbuilder.quantize_decoder_to_int8(model, bits=bits)
    assert model.cfg.quant == ("int4" if bits == 4 else "int8")
    want = from_jax_params(jq)
    got = model.state_dict()
    assert set(want) == set(got)
    for key, v in want.items():
        if key.endswith("kernel_q"):
            assert torch.equal(v, got[key]), key
        else:
            close(v, got[key], rtol=1e-6, atol=1e-7)


def test_quantize_nf4_matches_jax():
    from competesmoe_tpu.models.vision import SiglipSMoEVisionTower
    from competesmoe_tpu.models.vision import VisionConfig as JVis
    from competesmoe_tpu_torch.models.vision import (SiglipSMoEVisionTower as
                                                     TTower)
    from competesmoe_tpu_torch.models.vision import VisionConfig as TVis
    jcfg = JVis(hidden_size=48, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, image_size=28, patch_size=14,
                moe_name="competesmoe")
    px = np.zeros((1, 28, 28, 3), np.float32)
    params = SiglipSMoEVisionTower(jcfg).init(jax.random.PRNGKey(8),
                                              jnp.asarray(px))["params"]
    jq = jbuilder.quantize_nf4_weight_only(
        jax.tree_util.tree_map(np.asarray, params))
    tower = TTower(port_config(jcfg, TVis), device="cpu")
    tower.load_state_dict(from_jax_params(params))
    tbuilder.quantize_nf4_weight_only(tower)
    want = from_jax_params(jq)
    for key, v in tower.state_dict().items():
        np.testing.assert_array_equal(want[key].numpy(), v.numpy(), key)
    # the 48x48 attention kernels (2304 values >= min_size) changed
    assert not torch.equal(want["layers.0.self_attn.q_proj.weight"],
                           from_jax_params(params)[
                               "layers.0.self_attn.q_proj.weight"])


@pytest.mark.parametrize("mode,lead", [("int4", (3, 5)), ("int4", (40,)),
                                       ("int8", (2, 4))])
def test_quant_dense_matches_jax(mode, lead):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(*lead, 256)).astype(np.float32)
    jl = jdec.QuantDense(128, mode=mode, use_bias=True, dtype=jnp.float32)
    params = jl.init(jax.random.PRNGKey(10), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 if a.dtype == jnp.float32 and a.ndim == 1
        and a.shape == (128,) else a, params)
    want = jl.apply(params, jnp.asarray(x))
    tl = tdec.QuantDense(256, 128, mode=mode, use_bias=True, device="cpu",
                         dtype=torch.float32)
    tl.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        close(want, tl(t(x)))


# ---------------------------------------------------------------------------
# Package boundary
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import competesmoe_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'flax', 'competesmoe_tpu.', "
            "'safetensors', 'transformers')) or "
            "k == 'competesmoe_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_port_sources_import_no_jax():
    files = sorted((REPO / "competesmoe_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "chip_faults.py",
              REPO / "chip_variants.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax",
                                    "competesmoe_tpu"), (path, name)
        # the card machine has neither package: never at module level
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in ("safetensors",
                                                   "transformers")
                               for n in names), (path, names)


def _entry_point(name):
    """Build one of the port's standalone modules at a tiny size, passing
    device only when one is given."""
    from competesmoe_tpu_torch.models.llava import LlavaConfig, LlavaModel
    from competesmoe_tpu_torch.models.projector import (ProjectorConfig,
                                                        VisionProjector)
    from competesmoe_tpu_torch.models.vision import (SiglipSMoEVisionTower,
                                                     VisionConfig)
    from competesmoe_tpu_torch.moe import get_moe
    vis = VisionConfig(hidden_size=8, intermediate_size=8,
                       num_hidden_layers=1, num_attention_heads=2,
                       image_size=28, patch_size=14)
    proj = ProjectorConfig(mm_hidden_size=8, hidden_size=8)
    dec = _tiny_decoder_cfgs()[1]
    return {
        "llava": lambda **kw: LlavaModel(LlavaConfig(vis, proj, dec), **kw),
        "decoder": lambda **kw: tdec.DecoderLM(dec, **kw),
        "vision_tower": lambda **kw: SiglipSMoEVisionTower(vis, **kw),
        "projector": lambda **kw: VisionProjector(proj, **kw),
        "moe_layer": lambda **kw: get_moe("competesmoe")(8, 8, **kw),
    }[name]


@pytest.mark.parametrize("name", ["llava", "decoder", "vision_tower",
                                  "projector", "moe_layer"])
def test_entry_points_need_a_card_unless_asked(name):
    """Built on cuda by default; without a GPU that raises unless the
    caller passes device='cpu'."""
    from competesmoe_tpu_torch import resolve_device
    build = _entry_point(name)
    module = build(device="cpu")
    assert {p.device.type for p in module.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
