"""One run of one cell: find its files by name, set up, measure the window,
check the answers against the plain reference, read the metrics, and
build the result line.

A cell ``<name>`` of ``BENCHMARK.json`` names its configuration and its
traffic there; ``workloads/<name>.json`` names the entry its window drives
(``entries/<entry>.py``) and the limit of each number its check compares.
The configuration is ``configs/<config>.json`` with its plain reference
``configs/<config>.py``; the traffic is ``traffic/<traffic>.json``; each
metric is ``metrics/<metric>.py``. Adding a cell, a configuration, a
traffic mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from portbench import plain, spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "mri_super_resolution_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mri_super_resolution_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module (names may hold dots)."""
    name = "portbench_" + "_".join(path.relative_to(BENCH).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``mri_super_resolution_tpu_torch`` is not
    ``mri_super_resolution_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell's files, found by its name."""

    def __init__(self, name: str, bench: dict | None = None, overrides: dict | None = None):
        bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name, self.spec = name, found[0]
        self.wl = load_json(BENCH / "workloads" / f"{name}.json")
        overrides = overrides or {}
        self.cfg = {**load_json(BENCH / "configs" / f"{self.spec['config']}.json"),
                    **overrides.get("config", {})}
        self.traffic = {**load_json(BENCH / "traffic" / f"{self.spec['traffic']}.json"),
                        **overrides.get("traffic", {})}
        self.entry = load_module(BENCH / "entries" / f"{self.wl['entry']}.py")
        self.ref = load_module(BENCH / "configs" / f"{self.spec['config']}.py")
        self.limits = self.wl["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]

    def driver(self, seed: int, device, fault: str | None = None):
        return self.entry.Driver(self.cfg, self.traffic, seed, device, fault)

    def expected(self, inputs: dict, precision: str) -> dict:
        """The reference's readings, computed in ``precision``."""
        with plain.precision(precision):
            return self.entry.expected(self.ref, inputs, self.cfg, self.traffic)

    def readings(self, observed: dict, inputs: dict, reference: dict) -> dict:
        return self.entry.compare(observed, reference, inputs, self.traffic)


def _free(device) -> None:
    gc.collect()
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.empty_cache()


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            fault: str | None = None) -> dict:
    """Set up, run the window (traced or not), then check. Returns the run's
    record: ``setup_s``, ``window``, ``spans``, ``trace``, ``memory_peak_bytes``,
    ``readings``."""
    import torch

    from portbench import trace as tracing

    driver = cell.driver(seed, device, fault)
    t_driver = time.perf_counter()
    driver.setup()
    _check_program()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: setup_s {setup_s:.3f} ({t_driver - t_start:.3f} before the driver's "
          f"set-up: imports, CUDA; {setup_s - (t_driver - t_start):.3f} in it)",
          file=sys.stderr)
    recorder = spans.Recorder(active=trace)
    holder: dict = {}
    with tracing.profiled(holder) if trace else contextlib.nullcontext():
        window = driver.window(seconds, recorder)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    observed, inputs = driver.observations(), driver.inputs()
    driver.free()
    del driver
    _free(device)
    reference = cell.expected(inputs, "float32")
    return {"setup_s": setup_s, "window": window, "spans": recorder,
            "trace": holder.get("trace"), "memory_peak_bytes": peak,
            "readings": cell.readings(observed, inputs, reference)}


def _check_program() -> None:
    """The program measured is the checkout's."""
    module = sys.modules.get(PROGRAM)
    if module is None or ROOT not in Path(module.__file__).resolve().parents:
        raise RuntimeError(f"{PROGRAM} was not imported from the checkout at {ROOT}")


def checks(cell: Cell, readings: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` of the numbers the cell's
    file gives a limit: each read, finite and within its limit. (The other
    readings are ``calibrate.py``'s.)"""
    out, ok = {}, True
    for name, limit in cell.limits.items():
        value = float(readings.get(name, math.nan))
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out


def result_line(cell: Cell, run: dict, trace: bool, device_name: str) -> dict:
    ok, compared = checks(cell, run["readings"])
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    window = run["window"]
    device = {"platform": "gpu", "kind": device_name, "count": int(cell.spec["chips"]),
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    line = {"correct": ok, "attempted": int(window["attempted"]),
            "failed": int(window["failed"]), "metrics": metrics, "device": device}
    tr = run["trace"]
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s()
        line["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in compared.items()}
    return line


def _finite(value: float) -> float | None:
    """JSON has no infinity: a number that is not finite is written null."""
    return float(value) if math.isfinite(value) else None
