"""Start ``n`` ranks of a function in spawned processes, joined in a gloo
process group by a file rendezvous in a temporary directory (no TCP port:
several launches may run at once on one machine), one intra-op thread a
rank.  The rank's device is ``device`` itself, or ``cuda:<rank mod the
card count>`` for ``"cuda"``: several ranks share a card, gloo staging
CUDA tensors through host memory.  It never falls back to the CPU.

``launch(fn, n, device, *args)`` returns each rank's return value, saved
by ``torch.save`` (tensors on the CPU).  ``fn(rank, world, device,
*args)`` must be importable by name (a module's top level): the children
are spawned, not forked.  A script that launches needs an ``if __name__ ==
"__main__"`` guard, since each child imports the main module.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LAUNCH_TIMEOUT_S = 1200.0  # a rank stuck in a collective must not hang us


def rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for and there is "
                               "none")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _rank_main(rank: int, fn, world: int, device: str, tmp: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, dev, *args)
        torch.save(_to_cpu(out), os.path.join(tmp, f"rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, device: str, *args) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks;
    the ranks' return values in rank order.  A rank's exception is raised
    here with its traceback; ranks still running after
    ``LAUNCH_TIMEOUT_S`` are killed and ``TimeoutError`` raised."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(fn, world, device, tmp, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {LAUNCH_TIMEOUT_S} s")
        return [torch.load(os.path.join(tmp, f"rank_{r}.pt"),
                           weights_only=False) for r in range(world)]
