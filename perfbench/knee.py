"""The serving cell's sweep of offered rates, in one process: set-up
once, then one open-loop window a rate, each followed by the wait for
its answers. Prints one JSON line a rate: the requests, the backlog at
the window's close (requests not yet answered), p50 and p95 from
scheduled arrival to answer, the sender's largest lateness and the mean
dispatch size. The knee is the highest rate whose backlog stays near
one dispatch; a serving cell offers a rate under it, written as a number
in its traffic file.

    python3 perfbench/knee.py --workload word.serve \
        --rates 2000,3000,4000 --seconds 10
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from perfbench.core import result, spec, trace  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    spec.set_cache_dirs()
    cell = spec.cell(args.workload)
    import torch

    from perfbench.kinds import serve

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    server = serve.Server(cell, args.seed, torch.device("cuda", 0),
                          trace.Spans())
    print(json.dumps({"setup_s": time.perf_counter() - t0,
                      "card": result.card()}), flush=True)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            sent = server.window(rate, args.seconds, trace.Spans())
            texts = serve.collect(sent)
            lat = (sent["done"] - sent["due"]) * 1e3
            lat = np.where(np.isfinite(lat), lat, np.inf)
            b = sent["batches"]
            print(json.dumps({
                "rate": rate, "requests": len(texts),
                "failed": sum(t is None for t in texts),
                "backlog_at_close": sent["backlog"],
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "late_s": sent["late_s"],
                "batch_mean": sum(b) / max(len(b), 1),
                "dispatches": len(b)}), flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
