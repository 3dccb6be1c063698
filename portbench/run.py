"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files (``workloads/<cell>.json``, its configuration and
its entry under ``entries/``), makes the inputs and weights from the seed,
builds the program (``im23d_tpu_torch``) and warms the cell's shapes, then
drives the program's entry for ``--seconds`` of host clock and waits for
the device.  After the window the program's state is freed and the plain
reference under ``reference/`` checks what the timed path produced.  The
last line of standard output is the result, one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.  ``--trace 1`` runs the same window under the
profiler and reports the cell's per-layer metrics instead of its
end-to-end ones.  Without a CUDA card it exits with 2 and prints no
result.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# the program's and PyTorch's build caches, at fixed paths in the checkout
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "portbench" /
                                     "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "portbench" /
                                         "torch_extensions")
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def cell_metrics(name: str) -> tuple[list, list, int]:
    """The cell's end-to-end metrics, its per-layer metrics and its chips,
    from ``BENCHMARK.json``."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)],
            cells[name]["chips"])


def end_to_end(kind: str, cell, window: dict, setup_s: float) -> dict:
    """The host-clock metrics of the window: whole-window rates and the
    95th percentile of every call."""
    n = len(window["calls"])
    rate = n * cell.samples_per_call / window["window_s"]
    out = dict(setup_s=(setup_s, "s"))
    if kind == "train":
        out["train_samples_per_s"] = (rate, "samples/s")
    else:
        from portbench.lib.common import p95

        out["infer_samples_per_s"] = (rate, "samples/s")
        out["infer_ms_p95"] = (1e3 * p95([t1 - t0 for t0, t1, _ in
                                          window["calls"]]), "ms")
    return out


def measure(name: str, seed: int, seconds: float, trace: bool, device,
            fault: str | None = None, controls: bool = False,
            per_layer: list | None = None, t_process: float = T_PROCESS,
            files: tuple | None = None):
    """One run of cell ``name`` on ``device``: (result, the compared rows,
    the control's numbers when ``controls``, the check's detail).
    ``per_layer`` lists the (name, unit) of the metrics a traced run
    reads; ``fault`` plants one of the faults the check must catch (the
    calibration script's); ``files`` stands in for the cell's (traffic,
    configuration, entry module)."""
    import torch

    from portbench.lib.common import judge
    from portbench.lib.harness import (
        Run,
        Spans,
        load_cell,
        metric_reader,
        run_window,
    )
    from portbench.lib.trace import KernelWraps, profiled, read_profile
    from portbench.reference.steps import fp32_only

    traffic, config, entry = files or load_cell(name)
    per_layer = per_layer or []
    kernels = sorted({n.split("_roofline")[0] for n, _ in per_layer
                      if "_roofline" in n})
    wraps = KernelWraps(kernels) if trace else None
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.time()
    cell = entry.Cell(config, traffic, seed, device, fault=fault)
    spans = Spans(trace)
    cell.setup(spans)
    spans.take()
    print(f"setup: {t_build - t_process:.3f} s to the cell's set-up, "
          f"{time.time() - t_build:.3f} s in it", file=sys.stderr)
    prof_out = None
    try:
        if trace:
            before = wraps.counters()
            wraps.active = True
            with profiled() as prof:
                window = run_window(cell, seconds, spans, True)
            wraps.active = False
            launches = {k: v - before[k] for k, v in wraps.counters().items()}
            prof_out = read_profile(prof, wraps, launches)
            del prof
        else:
            window = run_window(cell, seconds, spans, False)
    finally:
        if wraps is not None:
            wraps.remove()
    setup_s = window["start_wall"] - t_process
    mem = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
           else 0)
    run = Run(cell, window, prof_out, wraps.calls if wraps else None)
    if trace:
        run.flops = cell.flops_per_call()
    cell.release()
    with fp32_only():
        numbers = cell.check()
        ok, rows = judge(numbers, traffic["limits"])
        detail = getattr(cell, "detail", None)
        control = None
        if controls:
            control = cell.check(control=True)
            control["detail"] = getattr(cell, "detail", None)
    if trace:
        metrics = {}
        for n, unit in per_layer:
            v = metric_reader(n)(run)
            if v is not None:
                metrics[n] = dict(value=v, unit=unit)
    else:
        metrics = {k: dict(value=v, unit=u) for k, (v, u) in
                   end_to_end(entry.KIND, cell, window, setup_s).items()}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(mem))
    result = dict(correct=bool(ok), attempted=len(window["calls"]),
                  failed=sum(1 for _, v, lim in rows
                             if not (math.isfinite(v) and v <= lim)),
                  metrics=metrics, device=dev)
    if trace:
        dev["busy_s"] = prof_out["busy_s"]
        dev["window_s"] = prof_out["window_s"]
        result["breakdown"] = prof_out["breakdown"]
    result["compared"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    return result, rows, control, detail


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    e2e, per_layer, chips = cell_metrics(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: no CUDA card ({torch.cuda.device_count()} found, "
              f"the cell needs {chips}); the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    from portbench.lib.harness import forbidden_modules

    names = ([(m["name"], m["unit"]) for m in per_layer] if args.trace
             else None)
    result, rows, _, detail = measure(
        args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), per_layer=names)
    if not args.trace:
        want = {m["name"] for m in e2e}
        result["metrics"] = {k: v for k, v in result["metrics"].items()
                             if k in want}
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    if detail:
        print(f"check detail {json.dumps(detail)}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
