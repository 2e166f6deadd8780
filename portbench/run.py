"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is ``portbench/workloads/<cell>.json``;
it names a configuration (``portbench/configs/<config>.json``) and a traffic
mix (``portbench/traffic/<traffic>.json``), whose ``driver`` is the module
of ``portbench/drivers/`` that builds the program, warms it up, runs the
measured window and checks what the window produced against the reference.
``--trace 0`` prints the cell's end-to-end metrics of ``BENCHMARK.json``,
``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from the traced window.

The last lines of standard error are the numbers compared with their
limits; the last line of standard output is the result, whose last key,
``checks``, holds them again. A run exits with 1 and prints no result when
the card (or as many as the cell asks for) is missing, when the program is
missing, or when the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# the top-level module names no run may load, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "transformer_gan_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's workload file with its configuration and traffic."""
    cell = load_json(HERE, "workloads", name + ".json")
    cell["name"] = name
    cell["config_data"] = load_json(HERE, "configs", cell["config"] + ".json")
    cell["traffic_data"] = load_json(HERE, "traffic",
                                     cell["traffic"] + ".json")
    return cell


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def read_metric(name: str, ctx) -> float | None:
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def check_device(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} present")


def device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             calibrate: bool = False, t_start: float | None = None) -> dict:
    """One run of cell ``name``: set-up, the window, the check. Returns the
    result dict (the line's keys) and, with ``calibrate``, the readings of
    the control and the faults beside the run's own (``calibration``).
    ``overrides`` merges into the configuration, its ``traffic`` key into the
    traffic's keys (the CPU tests' sizes)."""
    import torch
    t_start = T_START if t_start is None else t_start
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = load_cell(name)
    overrides = dict(overrides or {})
    cell["traffic_data"].update(overrides.pop("traffic", {}))
    chips = int(cell["chips"])
    dev = torch.device(device)
    if dev.type == "cuda":
        check_device(chips)
        torch.cuda.reset_peak_memory_stats(dev)
    driver_mod = importlib.import_module(
        "portbench.drivers." + cell["traffic_data"]["driver"])
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        drv = driver_mod.Driver(cell, int(seed), dev, tmp, overrides)
        drv.setup()
        setup_s = time.time() - t_start

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        from . import trace as tr
        with tr.window(trace, sync) as box:
            drv.window(seconds)
        drv.window_s = box["seconds"]
        info = device_info(dev, chips)
        t = box.get("trace")
        ctx = drv.context(t)
        if t is not None:
            info["busy_s"] = t.busy_s
            info["window_s"] = t.window_s
        metrics = {}
        for m in cell_metrics(bench, name, trace):
            value = (setup_s if m["name"] == "setup_s"
                     else read_metric(m["name"], ctx))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        drv.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the reference in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t_check = time.time()
        checks = drv.check()
        out = {"correct": all(c["value"] <= c["limit"] for c in checks),
               "attempted": drv.attempted, "failed": drv.failed,
               "metrics": metrics, "device": info,
               "check_s": time.time() - t_check}
        if t is not None:
            out["breakdown"] = {"device_ops": t.top_ops(),
                                "idle_gaps": t.idle_gaps()}
        out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                         for c in checks}
        if calibrate:
            out["calibration"] = drv.calibrate()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except (RunError, ImportError, FileNotFoundError) as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print("portbench: no result: the process loaded " + ", ".join(bad),
              file=sys.stderr)
        return 1
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
