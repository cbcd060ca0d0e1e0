#!/usr/bin/env python3
"""The readings a serving cell's output limits are set from, many seeds
in one process:

    python benchmark/calibrate.py --workload <name> --seeds 101-112 \
        --seconds 20 --control-seeds 101-103 [--controls kv4,fp8,bf16] \
        [--plant image_rows] [--out FILE]

Each seed is one run of the cell as `benchmark/run.py` makes it
(`harness.serve.run`: the model and engine from that seed, warm-up, the
mix's ramp and a window of `--seconds` at the cell's load), and its output
check: the program's widest gap and worst image median row error (the
lower readings), with how the gaps and errors spread. For each control
seed the same check also reads each named control of `serve.CONTROLS`,
put in the program's place on the same prompts, served tokens and images:
`kv4` (the int8 cache as int4; the widest gap's upper reading), `fp8`
(float8 projection inputs; the row error's upper reading), `bf16` (a
witness of the configured arithmetic). `--plant` breaks the timed path
with one of `PLANTS` for every seed. One JSON line a seed on standard
output, and in `--out`.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import serve, spec  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def _image_rows(every: int = 4, by: float = 0.5):
    """A fault confined to some images: every `every`-th image the tower
    encodes (counted over the run, across batched calls) comes out with
    its projector rows off by `by` of themselves. Returns the undo."""
    from competesmoe_tpu_torch.models.llava import LlavaModel
    encode = LlavaModel.encode_images
    seen = [0]

    def planted(self, pixel_values, **kw):
        out = encode(self, pixel_values, **kw)
        rows = out[0].clone()
        for i in range(rows.shape[0]):
            seen[0] += 1
            if seen[0] % every == 0:
                rows[i] = rows[i] * (1 + by)
        return (rows,) + tuple(out[1:])
    LlavaModel.encode_images = planted

    def undo():
        LlavaModel.encode_images = encode
    return undo


# faults planted in the timed path, for the readings of what they do
PLANTS = {"image_rows": _image_rows}


def reading(bm, cell, seed: int, seconds: float, controls=(),
            plant=None, device="cuda") -> dict:
    """One run of the cell at `seed` and its output check's readings."""
    t0 = time.perf_counter()
    undo = PLANTS[plant]() if plant else None
    try:
        r = serve.run(bm, cell, seed, seconds, False, device=device,
                      controls=controls)
    finally:
        if undo:
            undo()
    check, sample = r["check"], r["sample"]
    gc.collect()
    return {"seed": seed, "workload": cell["name"], "plant": plant,
            "correct": r["correct"], **serve.numbers(check),
            "program": _summary(check, sample),
            "controls": {k: dict(serve.numbers(v), **_summary(v, sample))
                         for k, v in check["controls"].items()},
            "tokens": sum(len(x.tokens) for x in sample),
            "requests": len(sample), "failed": r["window"]["failed"],
            "engine_error": r["served"].engine_error,
            "serve_tok_s": r["window"]["serve_tok_s"],
            "setup_s": r["setup_s"],
            "seconds": time.perf_counter() - t0}


def _summary(check, sample) -> dict:
    """How the gaps and row errors spread: the share of positions whose
    token is not the reference's best, the gaps' mean and 99th
    percentile, each request's shape and widest gap, and the row errors'
    quartiles and largest."""
    import torch
    flat = torch.cat([g.float().cpu() for g in check["gaps"]])
    out = {"off_best_share": float((flat > 0).float().mean()),
           "mean_gap": float(flat.mean()),
           "p99_gap": float(torch.quantile(flat, 0.99)),
           "requests": [[r.image, r.prompt, len(r.tokens),
                         round(float(g.max()), 5), int((g > 0).sum())]
                        for r, g in zip(sample, check["gaps"])]}
    e = check["image_errors"]
    if e is not None:
        e = e.float().cpu()
        out["image_medians"] = [round(float(m), 5)
                                for m in e.median(dim=-1).values]
        e = e.flatten()
        out["row_err_q"] = [float(torch.quantile(e, q))
                            for q in (0.25, 0.5, 0.75, 0.9)] + [float(e.max())]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="kv4,fp8",
                    help="comma-separated names of serve.CONTROLS")
    ap.add_argument("--plant", default=None, choices=sorted(PLANTS))
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bm = spec.load_benchmark()
    cell = spec.cell(bm, args.workload)
    ctrl = set(seeds(args.control_seeds))
    for seed in seeds(args.seeds):
        row = reading(bm, cell, seed, args.seconds,
                      args.controls.split(",") if seed in ctrl else (),
                      args.plant)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
