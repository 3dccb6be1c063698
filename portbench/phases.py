"""Per-phase device time, launches and copies of one cell's traced window.

    python3 portbench/phases.py --workload <cell> --seed <n> --seconds <s>

Runs ``run.py``'s traced window of the cell unchanged and reads it a
second time through ``lib/program.py``: for each of the program's spans
(``im23d.<layer>.<phase>``) the device ms, host ms, ranges and launches a
call, the share of ``im23d.train.step``'s device time in none of its
phases, the idle time by the span open when each gap began, and the
program's copy counters over the window.  Prints the run's result line
with these under ``program``.  Raises ``TraceIncomplete`` where the
count span (``im23d.train.step``, or ``im23d.infer.embed`` in an
inference cell) has not one range a call.  Exits with 2 without a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

COUNT_SPAN = {"train": "im23d.train.step", "infer": "im23d.infer.embed"}


def measure_phases(name: str, seed: int, seconds: float, device,
                   per_layer: list, files: tuple | None = None) -> dict:
    """``run.measure``'s traced result of cell ``name``, with the
    program's spans and copies of the same window under ``program``."""
    from portbench import run
    from portbench.lib import harness, program, trace

    entry = (files or harness.load_cell(name))[2]
    got = {}
    run_window, read_profile = harness.run_window, trace.read_profile

    def window(cell, seconds, spans, traced):
        before = program.counters()
        w = run_window(cell, seconds, spans, traced)
        got["copies"] = program.counter_delta(before, program.counters())
        got["calls"] = len(w["calls"])
        return w

    def reading(prof, *a, **k):
        out = read_profile(prof, *a, **k)
        got["read"] = program.read_spans(prof, got["calls"],
                                         COUNT_SPAN[entry.KIND])
        return out

    # run.measure imports both when it is called: the window and its
    # reading stay run.py's own, read once more here
    harness.run_window, trace.read_profile = window, reading
    try:
        result, _, _, _ = run.measure(name, seed, seconds, True, device,
                                      per_layer=per_layer, files=files)
    finally:
        harness.run_window, trace.read_profile = run_window, read_profile
    n, read = got["calls"], got["read"]
    result["program"] = dict(
        calls=n, busy_ms=1e3 * result["device"]["busy_s"] / n,
        spans={k: dict(device_ms=1e3 * v["device_s"] / n,
                       host_ms=1e3 * v["host_s"] / n,
                       count=v["count"] / n, launches=v["launches"] / n)
               for k, v in sorted(read["spans"].items())},
        unphased_share=read["unphased_share"],
        idle_by_span_ms=[[k, 1e3 * v / n] for k, v in read["idle_by_span"]],
        copies_per_call={k: v / n for k, v in got["copies"].items()})
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from portbench.run import cell_metrics

    import torch

    if not torch.cuda.is_available():
        print("phases: no CUDA card", file=sys.stderr)
        return 2
    per_layer = cell_metrics(args.workload)[1]
    result = measure_phases(args.workload, args.seed, args.seconds,
                            torch.device("cuda", 0),
                            [(m["name"], m["unit"]) for m in per_layer])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
