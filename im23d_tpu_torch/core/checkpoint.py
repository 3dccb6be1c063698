"""Checkpoint files of the port's trainers: ``checkpoint_<step>.pt``, or the
rolling ``checkpoint_latest.pt``, written by ``torch.save`` through a
temporary file and an atomic rename."""

from __future__ import annotations

import os
import re

import torch

LATEST = "latest"
_CKPT = re.compile(r"^checkpoint_(\d+)\.pt$")


def checkpoint_path(workdir: str, step) -> str:
    return os.path.join(workdir, f"checkpoint_{step}.pt")


def save_checkpoint(workdir: str, step, tree: dict) -> str:
    """Write ``tree`` as the checkpoint of ``step`` (an int or "latest")."""
    if not isinstance(step, int) and step != LATEST:
        raise ValueError(f"step must be an int or {LATEST!r}, got {step!r}")
    os.makedirs(workdir, exist_ok=True)
    path = checkpoint_path(workdir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def numbered_steps(workdir: str) -> list[int]:
    """The steps of the numbered checkpoints under ``workdir``, sorted."""
    names = os.listdir(workdir) if os.path.isdir(workdir) else []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, names) if m)


def resolve_checkpoint(workdir: str, step=None) -> str:
    """Path of the checkpoint of ``step`` (an int or "latest"); by default
    the newer, by file time, of the highest numbered one and the rolling
    "latest".  Raises FileNotFoundError when there is none."""
    names = os.listdir(workdir) if os.path.isdir(workdir) else []
    steps = numbered_steps(workdir)
    if step is None:
        candidates = [checkpoint_path(workdir, s) for s in steps[-1:]]
        if f"checkpoint_{LATEST}.pt" in names:
            candidates.append(checkpoint_path(workdir, LATEST))
        path = max(candidates, key=os.path.getmtime, default=None)
    elif step == LATEST or step in steps:
        path = checkpoint_path(workdir, step)
    else:
        path = None
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint {step} under {workdir}")
    return path
