"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload kitti_stereo.serve_b8 --seed 7 \\
        --seconds 30 --trace 0

Cells, metrics and bounds are in BENCHMARK.json at the repository root;
`portbench/core/spec.py` says where a cell's parts are found.  The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines on
standard error).  Without a CUDA device, or with fewer than the cell
asks for, it prints no result and exits with 2; if JAX or the JAX
package was loaded, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(REPO, "build", "portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
# one process with one compute thread: idle OpenMP workers spinning beside
# the launching thread make host-bound runs spread
os.environ["OMP_NUM_THREADS"] = "1"
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.core.cell import forbidden_modules, run_cell
    from portbench.core.spec import Bench

    bench = Bench(REPO)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, "cuda", bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
