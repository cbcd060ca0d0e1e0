"""A whole serving run at a small size on the CPU (the chip look skipped):
honest, it comes out correct; with the timed path broken underneath, it
does not. The faults a serving cell can have: a decode step that leaves
its state unchanged, and a token altered where it is produced (a cell on
one chip has no exchange between chips, and serving takes no mean over a
batch)."""

import pytest
import torch

import calibrate
from harness import serve
from small_cell import CELL, CFG, MIX

SEED = 2 ** 31 + 3


def _run(seed=SEED):
    torch.set_num_threads(4)
    return serve.run({}, CELL, seed, 2.0, False, device="cpu", cfg=CFG,
                     params=MIX)


def test_honest_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["window"]["failed"] == 0 and r["window"]["attempted"] > 10
    assert r["checks"]["sampled_tokens"]["value"] >= MIX["check_tokens"]


def _state_unchanged(monkeypatch):
    from competesmoe_tpu_torch.models.llava import LlavaModel
    forward = LlavaModel.forward

    def stuck(self, input_ids, *a, **kw):
        if input_ids.shape[1] == 1 and kw.get("cache") is not None:
            kw["pos_in_place"] = False      # the step's positions stay put
        return forward(self, input_ids, *a, **kw)
    monkeypatch.setattr(LlavaModel, "forward", stuck)


def _token_altered(monkeypatch):
    from competesmoe_tpu_torch.serve import engine
    sample = engine.sample_rows

    def altered(logits, *a, **kw):
        return (sample(logits, *a, **kw) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_rows", altered)


@pytest.mark.parametrize("plant", [_state_unchanged, _token_altered],
                         ids=["state_unchanged", "token_altered"])
def test_a_broken_path_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["widest_gap"]["value"] > CFG["check"]["widest_gap"]


def test_a_fault_in_some_images_is_not_correct():
    undo = calibrate.PLANTS["image_rows"](every=2)
    try:
        r = _run()
    finally:
        undo()
    assert not r["correct"]
    assert r["checks"]["worst_image_median_err"]["value"] > \
        CFG["check"]["worst_image_median_err"]


def test_the_worst_image_is_held_not_the_pooled_median():
    errs = torch.full((8, 16), 0.25)
    errs[3] = 0.5                        # one image of eight wrong
    got = serve.numbers({"gaps": [torch.zeros(3)], "image_errors": errs})
    assert got["worst_image_median_err"] == 0.5
    assert float(errs.flatten().median()) == 0.25


def test_the_controls_read_above_the_program():
    """The controls (the reference with an int4 cache where int8 is
    configured; with float8 projection inputs where bf16 is) against the
    program's readings, at this size, in the check of an honest run; the
    cell's own size is `test_bench_gpu.py`."""
    torch.set_num_threads(4)
    r = serve.run({}, CELL, SEED, 2.0, False, device="cpu", cfg=CFG,
                  params=MIX, controls=["kv4", "fp8"])
    got = serve.numbers(r["check"])
    kv4 = serve.numbers(r["check"]["controls"]["kv4"])
    fp8 = serve.numbers(r["check"]["controls"]["fp8"])
    assert kv4["widest_gap"] > max(got["widest_gap"],
                                   CFG["check"]["widest_gap"])
    assert fp8["worst_image_median_err"] > max(
        got["worst_image_median_err"],
        CFG["check"]["worst_image_median_err"])
