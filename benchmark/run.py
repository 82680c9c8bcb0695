"""Run one cell of the benchmark of webgraph_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell's entry in ``BENCHMARK.json``
names its configuration and traffic mix (see ``harness.py``).  Set-up
makes the graph from the seed, stores it with the benchmark's frozen
encoder under ``TMPDIR``, loads it with the port and warms up the cell's
path; then the window calls the operation back to back for ``--seconds``
(``--trace 1``: at most ``harness.TRACE_SECONDS``, under
``torch.profiler``, with the port's host spans recorded in set-up and in
the window), and the check compares what the calls produced with the
plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``); the line before it
holds the program's counters and the set-up's steps.  The numbers
compared are also the last lines of standard error.

Exits with 2, printing no result, when there is no CUDA device or fewer
than the cell asks for, and with 3 when the process holds a module of JAX
or of the JAX package once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "webgraph_tpu")


def forbidden_modules() -> list:
    """Top-level names, compared whole, of the loaded modules of JAX and
    of the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness

    marks = {"imports": time.perf_counter() - T0}
    cell = harness.find_cell(a.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.init()
    marks["cuda_init"] = time.perf_counter() - T0 - marks["imports"]
    result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                              "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    info = result.pop("info")
    info["setup_steps_s"] = {**marks, **info["setup_steps_s"]}
    info["card"] = power_limit()
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"]}
    result["checks"] = result.pop("checks")  # the last key
    print(json.dumps({"cell": a.workload, "seed": a.seed, **info}))
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
