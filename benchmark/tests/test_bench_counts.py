"""Operations and bytes counted from shapes, against hand counts at small
shapes."""


import math
from types import SimpleNamespace

import pytest

from harness import spec
from harness.peaks import BF16_OPS_PER_S, HBM_BYTES_PER_S, bound_s
from harness.trace import Trace
from reference.weights import Geometry
from small_cell import SMALL_HF

G = Geometry.from_hf(SMALL_HF)       # d 256, ffn 512, 2 layers, 4 heads
K5 = spec.metric("k5_roofline")
MFU = spec.metric("mfu.serve")


def test_k5_launch_work():
    # M 8 rows over a 256 x 768 int4 matrix: packed weights 256*768/2,
    # scales 4*768, input 2*8*256, output 2*8*768; 2*8*256*768 operations
    assert K5.launch_work(8, 256, 768) == (
        98304 + 3072 + 4096 + 12288, 3145728)
    assert K5.projections(G) == [(256, 768), (256, 256), (256, 1024),
                                 (512, 256)]
    # a forward: every layer's four projections once, each at its bound
    want = 2 * sum(bound_s(*K5.launch_work(8, k, n))
                   for k, n in K5.projections(G))
    assert math.isclose(K5.forward_bound_s(G, 8), want)


def _k5_run(forwards, records):
    trace = Trace(window_s=1.0, busy_s=0.5,
                  kernels=[("qmm4_kernel<64>", 0.0, 10.0)] * records,
                  device_ops=[], idle_gaps=[])
    served = SimpleNamespace(trace=trace, decoder_rows=forwards)
    return SimpleNamespace(served=served, geometry=G)


def test_k5_share_counts_work_by_forward_not_by_launch():
    w = {"quant_small_m_matmul_int4": 8}
    fwd = [((8, 1), w)] * 3 + [((1, 400), {})]       # the prefill: no K5
    got = K5.read(_k5_run(fwd, 24))
    assert math.isclose(got, 100.0 * 3 * K5.forward_bound_s(G, 8)
                        / (24 * 10e-6))
    # the same forwards spending twice the launches: the same work, twice
    # the kernel time, half the share
    w2 = {"quant_small_m_matmul_int4": 16}
    half = K5.read(_k5_run([((8, 1), w2)] * 3, 48))
    assert abs(half - got / 2) < 1e-9 * got


def test_k5_records_must_match_the_counted_launches():
    w = {"quant_small_m_matmul_int4": 8}
    fwd = [((8, 1), w)] * 5
    assert K5.read(_k5_run(fwd, 24)) > 0         # an edge forward missed
    with pytest.raises(RuntimeError):
        K5.read(_k5_run(fwd, 16))                # three missed
    with pytest.raises(RuntimeError):
        K5.read(_k5_run(fwd, 0))                 # the names match nothing
    assert K5.read(_k5_run([((1, 400), {})], 0)) is None


def test_bound_is_the_larger_of_the_two():
    assert bound_s(HBM_BYTES_PER_S, 0) == 1.0
    assert bound_s(0, BF16_OPS_PER_S) == 1.0
    assert bound_s(HBM_BYTES_PER_S, 2 * BF16_OPS_PER_S) == 2.0


def test_model_counts():
    # projections: 2 x 2 layers x (256*768 + 256*256 + 256*1024 + 512*256)
    assert MFU.projection_ops(G) == 4 * (196608 + 65536 + 262144 + 131072)
    assert MFU.attention_ops(G, 10) == 4 * 2 * 256 * 10
    assert MFU.head_ops(G) == 2 * 256 * 512
    # int4 weights with float32 scales, an int8 head with float32 scales
    assert MFU.decoder_weight_bytes(G) == (
        2 * (98304 + 3072 + 32768 + 1024 + 131072 + 4096 + 65536 + 1024)
        + 512 * 256 + 4 * 512)
    # per position: 2 layers x (K, V) x (256 int8 values + 4 bf16 scales)
    assert MFU.kv_bytes_per_position(G) == 2 * 2 * (256 + 8)
    # one image: 4 patches of 3*14*14 through a 128-wide conv, 2 of the 3
    # blocks (the third is the one LLaVA does not read), the projector
    P, d, h = 4, 128, 256
    block = 8 * P * d * d + 4 * P * P * d + 2 * P * d * 4 + 2 * 4 * P * d * h
    proj = P * (2 * d * 4 + 2 * 2 * (d * 256 + 256 * 256))
    assert MFU.image_ops(G) == 2 * P * 588 * d + 2 * block + proj


def test_window_work_counts_tokens_in_the_window():
    from harness.stats import Record
    r = Record(index=0, client=0, sent=0.0, prompt=6, max_new=3,
               greedy=True)
    r.times, r.tokens = [1.0, 2.0, 3.0], [5, 6, 7]
    kvb = MFU.kv_bytes_per_position(G)
    nbytes, ops = MFU.window_work(G, [r], 0, 0, 1.5, 2.5)
    # only the second token: one position fed, attending over 7 keys
    assert ops == (MFU.projection_ops(G) + MFU.head_ops(G)
                   + MFU.attention_ops(G, 7))
    assert nbytes == 8 * kvb
    nbytes, ops = MFU.window_work(G, [r], 2, 0, 0.5, 1.5)
    assert ops == (6 * MFU.projection_ops(G) + MFU.head_ops(G)
                   + MFU.attention_ops(G, 1) * 21)
    assert nbytes == 2 * MFU.decoder_weight_bytes(G) + 12 * kvb
