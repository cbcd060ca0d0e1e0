"""On the card, at the cells' own size and through the timed path (a run
of `harness.serve.run` as `benchmark/run.py` makes it, with a 20 s
window): the program's output passes the configuration's limits, each
control (the reference with an int4 cache where int8 is configured, with
float8 projection inputs where bf16 is, put in the program's place)
fails its number, on three seeds of each serving cell; and a fault
planted in some of the images the tower encodes fails the image number.
About ten minutes a cell of chip time:

    python -m pytest benchmark/tests/test_bench_gpu.py -m gpu
"""

import pytest

import calibrate
from harness import spec

BM = spec.load_benchmark()
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
SERVING = [w["name"] for w in BM["workloads"]
           if spec.config(BM, w["config"])["runner"] == "serve"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SERVING)
def test_control_fails_and_program_passes(workload, card):
    cell = spec.cell(BM, workload)
    limit = spec.config(BM, cell["config"])["check"]
    for seed in SEEDS:
        row = calibrate.reading(BM, cell, seed, 20.0, ["kv4", "fp8"])
        assert row["correct"], row
        assert row["widest_gap"] <= limit["widest_gap"], row
        assert row["worst_image_median_err"] <= \
            limit["worst_image_median_err"], row
        assert row["controls"]["kv4"]["widest_gap"] > \
            limit["widest_gap"], row
        assert row["controls"]["fp8"]["worst_image_median_err"] > \
            limit["worst_image_median_err"], row


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SERVING)
def test_a_fault_in_some_images_fails(workload, card):
    cell = spec.cell(BM, workload)
    limit = spec.config(BM, cell["config"])["check"]
    row = calibrate.reading(BM, cell, SEEDS[0], 20.0, plant="image_rows")
    assert not row["correct"], row
    assert row["worst_image_median_err"] > \
        limit["worst_image_median_err"], row
