"""The harness on the CPU: the cells' files found by name, seeded traffic,
the work counts of the metric files against shapes worked by hand, a dry
run of each cell at a small size, the planted faults, the trace
reduction, and the import check."""

import ast
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench.core import captioning, result, spec, trace, weights
from perfbench.core import traffic as mix
from perfbench.kinds import offline, serve, train
from perfbench.tests import tiny

ROOT = spec.ROOT
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


def metric(name):
    return spec.metric_reader(name)


# -- the files, found by name -------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = spec.cell(name)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert (ROOT / "perfbench" / "kinds"
            / f"{c.traffic['kind']}.py").is_file()
    lim = spec.limits(name)
    assert lim and all(v > 0 for v in lim.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        # a reader finds nothing to read in an empty run
        assert metric(m["name"])({}) is None


MODEL_API = ("build", "weight_spec", "prompts", "encode", "logits",
             "train_steps")


def test_models_found_by_name():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        model = spec.model(cfg)
        assert all(callable(getattr(model, f)) for f in MODEL_API)
    # a model that no file handles is refused
    with pytest.raises(FileNotFoundError):
        spec.model({"model": "NoSuchCaptioner"})


def test_eos_logit_is_a_constant():
    tree = spec.model(tiny.WORD).weight_spec(tiny.WORD, None)
    w = weights.make(tree, SEED, CPU, eos_index=3, eos_bias=1.5)
    cls = w["decoder"]["classifier"]
    assert torch.all(cls["weight"][3] == 0) and cls["bias"][3] == 1.5
    assert cls["weight"][4].abs().sum() > 0


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                          "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


# -- seeded traffic -----------------------------------------------------------

def test_offline_inputs_follow_the_seed():
    a = offline.inputs(tiny.WORD, tiny.OFFLINE, SEED, CPU)
    b = offline.inputs(tiny.WORD, tiny.OFFLINE, SEED, CPU)
    c = offline.inputs(tiny.WORD, tiny.OFFLINE, SEED + 1, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[1], c[1])


def test_serve_schedule_follows_the_seed():
    a = serve.schedule(tiny.SERVE, 100.0, 2.0, SEED)
    b = serve.schedule(tiny.SERVE, 100.0, 2.0, SEED)
    c = serve.schedule(tiny.SERVE, 100.0, 2.0, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    # every seed sends as many requests, in time order, inside the window
    assert len(a[0]) == len(c[0]) == 200
    assert np.all(np.diff(a[0]) >= 0) and 0 <= a[0][0] and a[0][-1] < 2.0
    # Zipf: the most asked template takes several times its even share
    counts = np.bincount(a[1], minlength=tiny.SERVE["templates"])
    assert counts.max() > 2 * len(a[1]) / tiny.SERVE["templates"]


@pytest.mark.parametrize("process", [
    {"process": "poisson"}, {"process": "on_off", "on_s": 0.2, "off_s": 0.3}])
def test_arrival_processes(process):
    def draw(seed):
        return mix.arrivals(process, 500.0, 2.0, np.random.default_rng(seed))

    a, b, c = draw(1), draw(1), draw(2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 1000
    assert np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 2.0
    if process["process"] == "on_off":
        # every arrival inside an on-period: 0.2 s of each 0.5 s cycle
        assert np.all(a % 0.5 < 0.2 + 1e-9)
        assert np.bincount((a // 0.5).astype(int)).tolist() == pytest.approx(
            [250] * 4, abs=60)


def test_popularity_laws():
    rng = np.random.default_rng(3)
    u = mix.picks({"law": "uniform"}, 7, 7000, rng)
    assert u.min() == 0 and u.max() == 6
    assert np.bincount(u).min() > 800
    with pytest.raises(ValueError):
        mix.picks({"law": "pareto"}, 7, 10, rng)


def test_train_batches_follow_the_seed():
    traffic = dict(tiny.TRAIN, batch=512, caption_tokens=33,
                   words_median=12)
    a = train.batches(tiny.TRAIN_CFG, traffic, SEED)
    b = train.batches(tiny.TRAIN_CFG, traffic, SEED)
    c = train.batches(tiny.TRAIN_CFG, traffic, SEED + 1)
    assert all(np.array_equal(x["captions"], y["captions"])
               for x, y in zip(a, b))
    assert not np.array_equal(a[0]["captions"], c[0]["captions"])
    caps = np.concatenate([x["captions"] for x in a])
    words = (caps >= 6).sum(1)
    assert words.max() <= 31 and 11 <= words.mean() <= 15
    assert np.all(caps[np.arange(len(caps)), words] == 3)
    assert len({r.tobytes() for r in caps}) == len(caps)


def test_derived_seeds_take_large_seeds():
    s = 2 ** 33 + 5
    assert spec.derive_seed(s, "weights") != spec.derive_seed(s, "features")
    assert spec.derive_seed(s, 1) == spec.derive_seed(s, 1) < 2 ** 63


# -- the work counts, by hand -------------------------------------------------

LIVE = np.array([8, 8, 6])


def test_self_attention_work_by_hand():
    nbytes, flops = metric("self_attn_roofline").__globals__["work"](
        tiny.WORD, LIVE)
    # s = 1: 8 items x 2 x 1 x 32 x 4 + 24 rows x 6 x 32 x 4; s = 2 ...
    assert nbytes == (2048 + 18432 + 3072 + 13824) * 2
    assert flops == (24 * 4 * 2 * 32 + 18 * 4 * 3 * 32) * 2


def test_cross_attention_work_by_hand():
    nbytes, flops = metric("cross_attn_roofline").__globals__["work"](
        tiny.WORD, LIVE)
    assert nbytes == (12288 + 16384 + 12288) * 2
    assert flops == (5120 + 15360 + 11520) * 2


def test_generation_flops_by_hand():
    flops = metric("mfu.gen").__globals__["flops"](tiny.WORD, LIVE)
    assert flops == 8 * (46592 + 40960) + 24 * 46848 + 18 * 47104


def test_train_step_flops_by_hand():
    flops = metric("mfu.train").__globals__["step_flops"](tiny.TRAIN_CFG,
                                                           tiny.TRAIN)
    assert flops == 3 * 16 * (9 * 58880 + 401408) + 2 * 16 * 6553600


def test_live_items_per_step():
    lasts = [torch.tensor([0, 2, 2, 1]), torch.tensor([2, 2, 1, 0])]
    assert captioning.live_per_step(lasts, 3).tolist() == [8, 6, 4]


def test_shares_from_a_run():
    cfg = dict(tiny.WORD)
    ctx = {"kind": "offline", "config": cfg, "live": LIVE, "calls": 2,
           "captures": 0,
           "trace": {"window_s": 2.0, "busy_s": 1.5, "kernel_s": {
               "ancestry_attention_update_mma_kernel": 1e-6,
               "grouped_cross_attention_mma_kernel": 1e-6, "gemm": 1.0}}}
    assert metric("idle_share.gen")(ctx) == pytest.approx(25.0)
    assert metric("device_ms_per_call.gen")(ctx) == pytest.approx(500.001)
    least = max(74752 / 3.35e12, 26112 / 989e12)
    assert metric("self_attn_roofline")(ctx) == pytest.approx(
        100 * least / 1e-6)
    serve_ctx = {"kind": "serve", "batches": [10, 16], "pads": [16, 16]}
    assert metric("batch_mean.serve")(serve_ctx) == 13
    assert metric("pad_share.serve")(serve_ctx) == pytest.approx(18.75)


# -- the trace reduction -----------------------------------------------------

def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "pb:window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "pb:generate",
           "ts": 0, "dur": 60},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20,
           "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20,
           "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 70, "dur": 40,
           "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "other", "ts": 0, "dur": 99,
           "args": {"device": 1}}]
    s = trace.reduce_events(ev, device=0)
    assert s["window_s"] == pytest.approx(100e-6)
    # [10, 40) and [70, 100) inside the window
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["kernel_s"]["k1"] == pytest.approx(50e-6)
    assert s["gaps"] == [("generate", pytest.approx(30e-6)),
                         ("generate", pytest.approx(10e-6))]
    b = trace.breakdown([s])
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2


# -- a dry run of each cell --------------------------------------------------

def dry(name, traced=False, fault=None, chips=2):
    c = tiny.cell(name, chips)
    kind = {"offline": offline, "serve": serve, "train": train}[
        c.traffic["kind"]]
    seconds = 1.0 if c.traffic["kind"] != "serve" else 1.5
    out = kind.run(c, SEED, seconds, traced, time.perf_counter(), CPU,
                   spec.limits(name), fault=fault)
    return c, out


@pytest.mark.parametrize("name", CELLS)
def test_dry_run_prints_a_well_formed_line(name, capsys):
    c, out = dry(name)
    # a sound run at a small size judges few tokens (the cells' limits are
    # set for some thousands), so its numbers are held here to their
    # scale: rounding, far below any planted fault's
    for k, (value, _) in out["checks"].items():
        assert value <= {"gap": 0.05, "outside_share": 5.0}.get(k, 0.01), (
            k, value)
    assert result.emit(result.line(c, out, False, "cpu")) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


def test_train_window_runs_at_the_configuration_dropout():
    _, out = dry("word.train.dp4")
    cfg = tiny.TRAIN_CFG
    assert out["ctx"]["dropout"] == [cfg["enc_dropout"], cfg["dec_dropout"]]
    assert cfg["enc_dropout"] > 0 and out["correct"]


@pytest.mark.parametrize("name", ["word.offline", "char.offline",
                                  "word.serve"])
def test_traced_dry_run_reports_per_layer_metrics(name, capsys):
    c, out = dry(name, traced=True)
    assert result.emit(result.line(c, out, True, "cpu")) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the CPU's trace holds no device operation: the device's shares
    # are left out, the counts are there
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    assert "breakdown" in line and "window_s" in line["device"]


FAULTS = [("word.offline", "token"), ("word.offline", "half"),
          ("char.offline", "token"), ("char.offline", "half"),
          ("word.serve", "token"), ("word.serve", "half"),
          ("word.train.dp4", "unchanged"), ("word.train.dp4", "half_rows"),
          ("word.train.dp4", "no_exchange")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    _, out = dry(name, fault=fault)
    assert not out["correct"], out["readings"]


# -- what the harness may import ---------------------------------------------

def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    bench = ROOT / "perfbench"
    for path in bench.rglob("*.py"):
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "deephumor_tpu"}, path
        if "reference" in path.relative_to(bench).parts:
            assert "deephumor_tpu_torch" not in tops, path


def test_forbidden_names_compare_whole():
    mods = {"deephumor_tpu_torch", "deephumor_tpu_torch.models", "numpy"}
    assert result.loaded_forbidden(mods) == []
    assert result.loaded_forbidden(mods | {"jax.numpy"}) == ["jax"]
    assert result.loaded_forbidden({"deephumor_tpu.models"}) == [
        "deephumor_tpu"]


def run_py(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "word.offline",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def last_json(stdout):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_py(ROOT)
    assert out.returncode != 0 and last_json(out.stdout) is None


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and last_json(out.stdout) is None


def test_limits_sit_between_their_readings():
    for path in (ROOT / "perfbench" / "limits").glob("*.json"):
        for k, v in json.loads(path.read_text()).items():
            assert v["lower"] < v["limit"] < v["upper"], (path.name, k)
            # more room above the lower reading than below the upper one
            assert v["limit"] / v["lower"] > v["upper"] / v["limit"], k
            assert math.isfinite(v["limit"])
