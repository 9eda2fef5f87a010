"""Runs one cell of ``BENCHMARK.json`` once on the CUDA cards of this
machine and prints its result as the last line of standard output.

    python3 perfbench/run.py --workload word.offline --seed 7 \
        --seconds 20 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. Set-up (weights from the seed,
the kernel build, every graph the cell's traffic uses) counts into
``setup_s``; nothing compiles inside the window. The numbers that decide
``correct`` are printed beside their limits, last on standard error and
under ``checks`` in the result. Without enough CUDA cards, without the
program, or with JAX loaded, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.core import result, spec  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    spec.set_cache_dirs()
    cell = spec.cell(args.workload)
    limits = spec.limits(cell.name)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    card = result.card()
    if card:
        print(f"card: {card}", flush=True)
    kind = importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), T0,
                   torch.device("cuda", 0), limits)
    out["ctx"]["card"] = card
    return result.emit(result.line(cell, out, bool(args.trace),
                                   torch.cuda.get_device_name(0)))


if __name__ == "__main__":
    sys.exit(main())
