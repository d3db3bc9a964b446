"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``src/repro_torch``).  The kernels are built into
``build/repro_torch/`` of the checkout, where later runs find them.  The
last line of standard output is one JSON object; the numbers compared with
the reference, each beside its limit, are the last lines of standard error.
Exits non-zero with no result where CUDA is absent or has fewer cards than
the cell asks for, and where JAX or the JAX package ``repro`` was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def environment() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds; no JAX behind a library."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    environment()

    import torch

    from portbench import cells, harness

    bench = cells.benchmark(ROOT)
    cell = cells.cell(args.workload, bench)
    if not torch.cuda.is_available():
        harness.log("CUDA is not available: no result")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{torch.cuda.device_count()} cards, the cell asks for "
                    f"{cell['chips']}: no result")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        harness.log("the port (src/repro_torch) is not in this checkout")
        return 2
    out = harness.run(cells.config(cell["config"], bench, ROOT),
                      cells.traffic(cell["traffic"]),
                      (cells.end_to_end(cell["name"], bench),
                       cells.per_layer(cell["name"], bench)), args.seed,
                      args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
