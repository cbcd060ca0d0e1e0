"""Parity of the port's blockwise 8-bit Adam state (train/quant_opt.py) with
competesmoe_tpu/train/quant_opt.py, and of the LM trainer's
`-opt.state_8bit` with JAX's LM trainer under the same flag.

Inputs are numpy from a seed. Quantization and dequantization must agree
bit for bit (codes and scales, ragged last dims, padding only inside the
quantizer); three Adam updates give the same codes and scales and
directions within rtol 1e-6; small leaves keep float moments; state_bytes
counts what JAX's counts. The LM's three steps: metrics rtol 1e-4,
parameters rtol 1e-4 + atol 1e-5, except that at most 0.5% of a tensor's
elements may sit a neighbouring 8-bit code's step away (within 3 lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import lm as jlm
from competesmoe_tpu.moe import schedule as jsched
from competesmoe_tpu.train import lm_trainer as jtrainer
from competesmoe_tpu.train import quant_opt as jq
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import lm as tlm
from competesmoe_tpu_torch.moe import schedule as tsched
from competesmoe_tpu_torch.train import lm_trainer as ttrainer
from competesmoe_tpu_torch.train import quant_opt as tq
from tests.test_torch_port_lm import _cfgs, close, t

SHAPES = [(4, 256), (3, 300), (2, 5, 700), (1000,), (7, 40)]


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_dequantize_bit_for_bit(shape, block):
    rng = np.random.default_rng(len(shape) * 7 + block)
    x = (rng.normal(size=shape) * 10.0 ** rng.uniform(-6, 1, size=shape)
         ).astype(np.float32)
    x.reshape(-1)[:5] = 0.0
    jl, tl = jq.quantize_signed(jnp.asarray(x), block), \
        tq.quantize_signed(torch.from_numpy(x), block)
    assert tl.q.dtype == torch.int8 and tl.q.shape == x.shape
    assert tl.scale.shape == shape[:-1] + (-(-shape[-1] // block),)
    _bits_equal(tl.q.numpy(), jl.q)
    _bits_equal(tl.scale.numpy(), jl.scale)
    _bits_equal(tq.dequantize_signed(tl, block).numpy(),
                jq.dequantize_signed(jl, block))
    nu = x * x
    jl, tl = jq.quantize_sqrt(jnp.asarray(nu), block), \
        tq.quantize_sqrt(torch.from_numpy(nu), block)
    assert tl.q.dtype == torch.uint8
    _bits_equal(tl.q.numpy(), jl.q)
    _bits_equal(tl.scale.numpy(), jl.scale)
    _bits_equal(tq.dequantize_sqrt(tl, block).numpy(),
                jq.dequantize_sqrt(jl, block))


def test_three_updates_match_jax():
    """scale_by_quant_adam's three updates against QuantAdamState's: the
    stored codes and scales bit for bit, the directions within rtol 1e-6,
    a small leaf's float moments too."""
    rng = np.random.default_rng(3)
    params = {"w": np.zeros((16, 300), np.float32),
              "b": np.zeros((30,), np.float32)}
    jopt = jq.scale_by_quant_adam(block=128, min_quant_size=1024)
    jstate = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tstate = tq.QuantAdamState.init({k: torch.from_numpy(v)
                                     for k, v in params.items()}, block=128,
                                    min_quant_size=1024)
    assert isinstance(tstate.mu["w"], tq.QuantLeaf)
    assert not isinstance(tstate.mu["b"], tq.QuantLeaf)
    for count in (1, 2, 3):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** -count).astype(
            np.float32) for k, v in params.items()}
        jd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate)
        for k in params:
            td = tstate.direction(k, torch.from_numpy(g[k]), count, 0.9,
                                  0.999, 1e-8)
            np.testing.assert_allclose(td.numpy(), jd[k], rtol=1e-6,
                                       atol=1e-7)
        tstate.count = count
        _bits_equal(tstate.mu["w"].q.numpy(), jstate.mu["w"].q)
        _bits_equal(tstate.mu["w"].scale.numpy(), jstate.mu["w"].scale)
        _bits_equal(tstate.nu["w"].q.numpy(), jstate.nu["w"].q)
        _bits_equal(tstate.nu["w"].scale.numpy(), jstate.nu["w"].scale)
        np.testing.assert_allclose(tstate.mu["b"].numpy(), jstate.mu["b"],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tstate.nu["b"].numpy(), jstate.nu["b"],
                                   rtol=1e-6, atol=1e-12)


def test_small_leaves_float_and_state_bytes():
    params = {"big": np.zeros((64, 128), np.float32),
              "ragged": np.zeros((9, 700), np.float32),
              "small": np.zeros((10, 10), np.float32)}
    jopt = jq.scale_by_quant_adam()
    jstate = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tstate = tq.QuantAdamState.init({k: torch.from_numpy(v)
                                     for k, v in params.items()})
    assert tstate.mu["small"].dtype == torch.float32
    assert tstate.nu["big"].q.dtype == torch.uint8
    jbytes = jq.state_bytes((jstate.mu, jstate.nu))
    assert tq.state_bytes(tstate) == jbytes


def test_checkpoint_round_trip_keeps_codes(tmp_path):
    """QuantAdamState through the Saver: codes, scales and count come back
    equal, into the tensors of a fresh state."""
    from competesmoe_tpu_torch.train.checkpoint import Saver
    p = {"w": torch.zeros(8, 600)}
    s = tq.QuantAdamState.init(p)
    g = torch.randn(8, 600, generator=torch.Generator().manual_seed(0))
    s.direction("w", g, 1, 0.9, 0.999, 1e-8)
    s.count = 1
    saver = Saver(tmp_path)
    saver["opt"] = s
    saver.save(1)
    fresh = tq.QuantAdamState.init(p)
    saver["opt"] = fresh
    saver.restore()
    assert fresh.count == 1
    for k in ("mu", "nu"):
        assert torch.equal(getattr(fresh, k)["w"].q, getattr(s, k)["w"].q)
        assert torch.equal(getattr(fresh, k)["w"].scale,
                           getattr(s, k)["w"].scale)


def test_lm_trainer_state_8bit_matches_jax():
    """A tiny CompeteSMoE LM (vocab 128 x d 32: the embedding and the
    output layer take 8-bit moments) takes 3 steps of make_train_step with
    -opt.state_8bit, from the same weights, batches and flip schedule, in
    both packages."""
    jcfg, tcfg = _cfgs()
    sched = jsched.build_flip_schedule(2, 12, 0.0, 0.5, 2, seed=0)
    tsch = tsched.build_flip_schedule(2, 12, 0.0, 0.5, 2, seed=0)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=12, grad_clip=0.1,
               weight_decay=0.01, state_8bit=True)
    tokens = np.random.default_rng(7).integers(0, 128, (3, 4, 17))
    jmodel = jlm.MoELanguageModel(jcfg, flip_schedule=sched)
    params = jmodel.init(jax.random.PRNGKey(3),
                         jnp.asarray(tokens[0, :, :-1]))["params"]
    joptim = jtrainer.make_optimizer(jtrainer.OptConfig(**opt))
    jstate = jtrainer.TrainState.create(params, joptim)
    jstep = jtrainer.make_train_step(jmodel, joptim, donate=False)
    tmodel = tlm.MoELanguageModel(tcfg, flip_schedule=tsch, device="cpu")
    tmodel.load_state_dict(from_jax_params(params))
    toptim = ttrainer.make_optimizer(ttrainer.OptConfig(**opt))
    tstate = ttrainer.TrainState.create(tmodel, toptim)
    assert isinstance(tstate.opt_state, tq.QuantAdamState)
    assert sum(isinstance(v, tq.QuantLeaf)
               for v in tstate.opt_state.mu.values()) >= 2
    tstep = ttrainer.make_train_step(tmodel, toptim)
    for s in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens[s], jnp.int32))
        tstate, tm = tstep(tstate, t(tokens[s]))
        for key in jm:
            close(jm[key], tm[key])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for key in want:
        g, w = got[key].numpy(), want[key].numpy()
        off = np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)
        assert off.mean() <= 5e-3, (key, off.mean())
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-3, err_msg=key)
