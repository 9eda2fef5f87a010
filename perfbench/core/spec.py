"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each is a JSON file of
its own (``configs/<config>.json``, ``traffic/<traffic>.json``). A
configuration names its model, a file of its own (``models/<model>.py``:
the port's model, its weights, its prompts and the reference's side of
each check). A per-layer metric is a module of its own,
``metrics/<name>.py``, with a ``read(ctx)`` that returns the metric's
value or None when the run gives it nothing to read. A later cell,
model or metric adds files and entries; no file here changes for it.
"""

import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the build and kernel caches of a run live inside the checkout, at fixed
# paths, so that only a cell's first run in a checkout builds
CACHE_DIR = ROOT / "build" / "perfbench"

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    the metrics that it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    path = pathlib.Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def _reports(metric, cell):
    listed = metric.get("workloads")
    return cell in listed if listed is not None else None


def cell(name, root=ROOT):
    """The cell ``name`` of ``BENCHMARK.json``, its files read."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = load_json(pathlib.Path(root) / entry["file"])
    config["name"] = entry["name"]
    traffic = load_json(pathlib.Path(root) / "perfbench" / "traffic"
                        / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, name) is not False]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without a list is reported wherever its
    # end-to-end metric is
    per_layer = [m for m in bench["per_layer"]
                 if (_reports(m, name) if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def _load(folder, name, root=ROOT):
    path = pathlib.Path(root) / "perfbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no perfbench/{folder}/{name}.py")
    key = f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def metric_reader(name, root=ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def model(cfg, root=ROOT):
    """The module of ``models/<model>.py`` for the configuration ``cfg``;
    a model that no file handles is refused."""
    return _load("models", cfg["model"], root)


def derive_seed(seed, stream):
    """A 63-bit seed for one random stream of a run (``stream``: a small
    int or a string), splitmix64 of the pair: the weights, the inputs and
    each call's draws take unrelated streams of one ``--seed``."""
    if isinstance(stream, str):
        stream = int.from_bytes(hashlib.sha256(stream.encode()).digest()[:8],
                                "little")
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(stream) + 1)
         * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def set_cache_dirs():
    """Points every build and kernel cache at fixed directories inside the
    checkout (the port builds its kernels into ``build/deephumor_tpu_torch``
    itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)
    # a library that would load JAX by itself does not
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    CACHE_DIR.mkdir(parents=True, exist_ok=True)


def limits(cell_name, root=ROOT):
    """The limits of the numbers that decide a cell's ``correct``
    (``limits/<cell>.json``: each limit with the readings it was set
    from)."""
    data = load_json(pathlib.Path(root) / "perfbench" / "limits"
                     / f"{cell_name}.json")
    return {k: v["limit"] for k, v in data.items()}


def settle():
    """Ends set-up: collects what set-up left and freezes every object
    alive now out of the garbage collector's scans, so that the window's
    collections walk only what the window makes (a server that has
    loaded its model does the same)."""
    gc.collect()
    gc.freeze()
