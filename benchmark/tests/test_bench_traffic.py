"""The closed-loop generator: the same seed gives the same requests; any
seed sends the same sizes, in another order."""

import collections

import numpy as np

from harness import spec

MIX = spec.traffic("chat-closed32")
SEED = 2 ** 31 + 11


def _plan(seed, mix=MIX):
    return spec.traffic_kind(mix["kind"]).Plan(mix, seed, 32064)


def _first(plan, n):
    return [plan.request(c, j) for j in range(n) for c in range(plan.clients)]


def test_same_seed_same_requests():
    a, b = _first(_plan(SEED), 3), _first(_plan(SEED), 3)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.temperature == y.temperature
        assert np.array_equal(x.ids, y.ids)
        assert (x.pixels is None) == (y.pixels is None)
        if x.pixels is not None:
            assert np.array_equal(x.pixels, y.pixels)


def test_seeds_send_the_same_sizes_in_another_order():
    n = len(_plan(SEED).shapes) // MIX["clients"]       # one cycle
    a, b = _first(_plan(SEED), n), _first(_plan(SEED + 1), n)
    assert [r.shape for r in a] != [r.shape for r in b]
    assert (collections.Counter(r.shape for r in a)
            == collections.Counter(r.shape for r in b))
    assert not np.array_equal(a[0].ids, b[0].ids)


def test_pool_follows_the_mix():
    shapes = _plan(SEED).shapes
    prompts = [s.prompt for s in shapes]
    assert min(prompts) >= 32 and max(prompts) <= 1024
    assert abs(np.median(prompts) - 200) <= 10
    assert sum(s.image for s in shapes) == len(shapes) // 4
    assert sum(s.sampled for s in shapes) == len(shapes) // 8
    docs = spec.traffic("docs-closed32")
    d = _plan(SEED, docs).shapes
    assert all(1280 <= s.prompt <= 1664 and 8 <= s.output <= 24 for s in d)
    assert not any(s.sampled for s in d)


def test_image_requests_carry_one_image_token():
    for r in _first(_plan(SEED), 8):
        assert (r.ids == -200).sum() == (1 if r.shape.image else 0)
        assert len(r.ids) == r.shape.prompt
        assert r.ids[r.ids != -200].min() >= 3


def test_every_block_holds_the_mix():
    plan = _plan(SEED)
    size = MIX.get("block", 16)
    prompts = sorted(s.prompt for s in plan.shapes)
    edges = [prompts[i * len(prompts) // size] for i in range(size)]
    order = [plan.shapes[i] for i in plan._order(0)]
    for b in range(0, len(order), size):
        block = order[b:b + size]
        assert sum(s.image for s in block) == size // 4
        assert sum(s.sampled for s in block) == size // 8
        got = sorted(s.prompt for s in block)
        assert all(g >= e for g, e in zip(got, edges))
