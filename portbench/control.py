"""The control of the correctness check: the reference computed in the
precision below the configuration's (int4 for int8) and put in the
program's place, so that its answers go through the same comparison.  A
check that passes it cannot tell int8 from int4.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

draws each seed's inputs as a run of the cell does and prints one JSON line
per seed with the numbers the check compares and their limits.  The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_numbers(cfg: dict, traffic: dict, seed: int, dev,
                    bits: int = 4) -> dict:
    """The compared numbers of the ``bits`` reference's answers against the
    int8 reference's, on the pool a run of this seed serves."""
    import torch

    from portbench import cells, check, serving

    layers = cells.reference(cfg["reference"]).layers(
        cfg["img"], cfg["num_classes"], cfg["in_channels"])
    inputs = serving.make_inputs(layers, traffic["pool"], cfg["model_seed"],
                                 seed, dev)
    weights = inputs.weights()
    want, _ = check.reference_answers(layers, weights, inputs.calib,
                                      inputs.pool, inputs.f_img)
    low, _ = check.reference_answers(layers, weights, inputs.calib,
                                     inputs.pool, inputs.f_img, bits=bits)
    answers = [(list(range(low.shape[0])), low.to("cpu", torch.float32))]
    return check.compare(answers, want, 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import cells, check

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    bench = cells.benchmark(ROOT)
    cell = cells.cell(args.workload, bench)
    cfg = cells.config(cell["config"], bench, ROOT)
    traffic = cells.traffic(cell["traffic"])
    for seed in args.seeds:
        numbers = control_numbers(cfg, traffic, seed, "cuda:0")
        correct, checks = check.verdict(numbers, cfg["check"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
