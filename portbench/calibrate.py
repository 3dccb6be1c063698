"""The readings the limits of ``correct`` are set from, for one cell on a
card: the program's numbers over many seeds, the control's (the
reference in float8) on the same seeds, and the numbers with each planted
fault, all in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 100 112 \
        --seconds 2 [--faults half_batch altered_row --fault_seeds 3]

``--seeds A B`` runs seeds A to B - 1.  Prints one JSON line a run and
appends them to ``<out>/<cell>.jsonl`` (``--out``, by default
``build/portbench/calibrate`` in the checkout).  The benchmark's
runs never call it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.run import CHECKOUT, measure  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs=2, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault_seeds", type=int, default=3)
    p.add_argument("--out", default=str(CHECKOUT / "build" / "portbench" /
                                        "calibrate"))
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                   help="configuration overrides, e.g. "
                        "model.compute_dtype='\"float32\"'")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    files = None
    if args.set:
        import copy

        from portbench.lib.harness import load_cell

        traffic, config, entry = load_cell(args.workload)
        config = copy.deepcopy(config)
        for item in args.set:
            key, val = item.split("=", 1)
            *path, last = key.split(".")
            d = config
            for k in path:
                d = d[k]
            d[last] = json.loads(val)
        files = (traffic, config, entry)
    runs = [(s, None) for s in range(*args.seeds)]
    runs += [(s, f) for f in args.faults
             for s in range(args.seeds[0], args.seeds[0] + args.fault_seeds)]
    with open(out / f"{args.workload}.jsonl", "a") as log:
        for seed, fault in runs:
            t0 = time.time()
            result, rows, control, detail = measure(
                args.workload, seed, args.seconds, False, dev, fault=fault,
                controls=fault is None, t_process=t0, files=files)
            line = dict(workload=args.workload, seed=seed, fault=fault,
                        overrides=args.set,
                        program={k: v for k, v, _ in rows}, control=control,
                        detail=detail, attempted=result["attempted"],
                        metrics=result["metrics"],
                        seconds=time.time() - t0)
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
            log.flush()
            del result, detail
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
