"""The readings that a cell's limits are set from, in one process: the
program's sound runs on many seeds, and the control (the reference in
fp8 in the program's place) on the same prompts and tokens.

    python3 perfbench/readings.py --workload word.offline \
        --seeds 11,12,13 --seconds 4 --out chiprun_out/readings.jsonl

Each seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the check), then the control; one JSON line per seed with
every number compared and the control's reading. The benchmark's own
runs never run the control.
"""

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.core import result, spec  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None,
                   help="plant a fault of faults.py underneath each run")
    args = p.parse_args(argv)
    spec.set_cache_dirs()
    cell = spec.cell(args.workload)
    limits = spec.limits(cell.name)
    import torch
    from deephumor_tpu_torch.models import graphs

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    kind = importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    out_f = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = kind.run(cell, seed, args.seconds, False, t0, dev, limits,
                       control=True, fault=args.fault)
        row = {"workload": cell.name, "seed": seed, "fault": args.fault,
               "correct": out["correct"], "e2e": out["e2e"],
               "readings": out["readings"], "card": result.card(),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        if out_f:
            out_f.write(json.dumps(row) + "\n")
            out_f.flush()
        del out
        graphs.clear()
    if result.loaded_forbidden():
        print(f"loaded {result.loaded_forbidden()}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
