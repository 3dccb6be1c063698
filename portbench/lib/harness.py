"""Finding a cell's files by name, the measured window, and the result.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json`` (the traffic:
its entry, sizes, schedule and the limits of ``correct``), the
configuration ``configs/<config>.json``, the driver loop
``entries/<entry>.py`` and its per-layer metrics ``metrics/<name>.py``.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

from torch.profiler import record_function

from portbench.lib.trace import PREFIX, SPAN, load_file

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "im23d_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, object]:
    """(traffic, configuration, entry module) of cell ``name``."""
    traffic = load_json(ROOT / "workloads" / f"{name}.json")
    config = load_json(ROOT / "configs" / f"{traffic['config']}.json")
    entry = load_file(ROOT / "entries" / f"{traffic['entry']}.py",
                      f"portbench_entry_{traffic['entry']}")
    return traffic, config, entry


def metric_reader(name: str):
    return load_file(ROOT / "metrics" / f"{name}.py",
                     f"portbench_metric_{name.replace('.', '_')}").read


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host time of the loop's named spans, per call; in the traced run
    each is also a ``portbench.span.<name>`` range."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.current: dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        rf = record_function(PREFIX + SPAN + name) if self.traced \
            else nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.current[name] = self.current.get(name, 0.0) + (
            time.perf_counter() - t0)

    def take(self) -> dict:
        out, self.current = self.current, {}
        return out


def run_window(cell, seconds: float, spans: Spans, traced: bool) -> dict:
    """Call ``cell.step(spans)`` until ``seconds`` have passed, then wait
    for the device.  Returns the window's start and length (the host clock
    around all of it, the wait included) and each call's (start, end,
    spans)."""
    calls = []
    cell.sync()
    rf = record_function(PREFIX + "window") if traced else nullcontext()
    with rf:
        t_start = time.perf_counter()
        t_wall = time.time()
        while True:
            t0 = time.perf_counter()
            cell.step(spans)
            t1 = time.perf_counter()
            calls.append((t0, t1, spans.take()))
            if t1 - t_start >= seconds:
                break
        cell.sync()
        t_end = time.perf_counter()
    return dict(start=t_start, start_wall=t_wall, window_s=t_end - t_start,
                calls=calls)


class Run:
    """What a per-layer metric reads: the cell, the window's calls and
    spans, the traced profile and each wrapped kernel's bounds."""

    def __init__(self, cell, window: dict, trace: dict | None,
                 bounds: dict | None):
        self.cell = cell
        self.calls = window["calls"]
        self.window_s = window["window_s"]
        self.trace = trace
        self.bounds = bounds or {}
        self.flops = None

    def span_ms(self, name: str) -> float | None:
        vals = [c[2].get(name) for c in self.calls]
        vals = [v for v in vals if v is not None]
        if not vals:
            return None
        return 1e3 * sum(vals) / len(self.calls)
