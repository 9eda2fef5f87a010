"""The result line of a run, the checks beside it, and the guard that no
JAX was loaded."""

import json
import subprocess
import sys

from perfbench.core import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "deephumor_tpu")


def loaded_forbidden(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def card():
    """``name, power limit`` of the first card as ``nvidia-smi`` reads
    them, or None where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def line(cell, out, traced, device_kind):
    """The JSON object of the last line: the cell's end-to-end metrics, or
    with ``traced`` its per-layer metrics (each that its reader finds),
    the device, the breakdown, and the numbers compared beside their
    limits under ``checks``, last. An end-to-end metric named
    ``<quantity>.<qualifier>`` (one configuration's quantity under a
    bound of its own) reports the kind's ``<quantity>``."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            name = m["name"]
            value = out["e2e"].get(name, out["e2e"].get(name.split(".")[0]))
            metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(out["correct"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    sums = out["summaries"]
    if traced and sums:
        device["busy_s"] = sum(s["busy_s"] for s in sums) / len(sums)
        device["window_s"] = sum(s["window_s"] for s in sums) / len(sums)
        result["breakdown"] = trace.breakdown(sums)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    return result


def emit(result):
    """Prints the checks as the last lines of standard error and the
    result as the last line of standard output; refuses (exit 4, no
    result) when JAX or the JAX package is loaded."""
    found = loaded_forbidden()
    if found:
        print(f"refused: loaded {found}", file=sys.stderr, flush=True)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
