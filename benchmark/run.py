"""Run one cell of the benchmark of xgcm_tpu_torch once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device`` (and with ``--trace 1`` ``breakdown``),
and last ``checks``, each number compared beside its limit.  Those numbers
are also the last lines on standard error.  ``--control 1`` runs the
correctness control instead of the program (the reference in bfloat16 in
the program's place) and prints its numbers; the benchmark's own runs do
not use it.

With no CUDA card, or fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only the first run of a checkout builds.  The port builds its
    kernel library into ``build/kernels/`` of the checkout by itself."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} here",
              file=sys.stderr)
        return 2
    import xgcm_tpu_torch
    from xgcm_tpu_torch.ops.kernels import build

    where = pathlib.Path(xgcm_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"xgcm_tpu_torch imported from {where}, not from {ROOT}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    build.build_library()
    harness.log(f"kernel library ready in {time.perf_counter() - t0:.3f} s "
                f"({build.library_path().name})")
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START, control=bool(args.control))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
