"""Tracing of the port: ``StepProfiler`` (counterpart of ``StepProfiler``
in ``im23d_tpu/core/jax_setup.py``; ``--profile_dir`` of the CLIs), the
program's spans and its copy counters.

* ``span(name, step)``: a ``record_function`` range ``im23d.<name>``
  (``<layer>.<phase>``, e.g. ``train.forward``) around a phase of the
  trainers, the feeds and the FID path, with the iteration as its
  argument where there is one.  A span exists only while a torch profiler
  records (``StepProfiler``'s window, or any ``torch.profiler.profile``):
  otherwise ``span`` returns one shared null context, at the cost of one
  check.  The ranges are the profiler's own records, on the device
  trace's clock, nested on their thread; the profiler records them on the
  thread that started it and on the autograd threads.
* ``COUNTERS``: bytes copied from host memory to a CUDA device
  (``h2d_bytes``, by ``to_device``) and back (``d2h_bytes``, by
  ``to_host``) on the trainers', feeds' and FID's per-iteration paths;
  the recon training steps whose network replayed from CUDA graphs
  (``recon_graph_steps``) and ran eagerly (``recon_eager_steps``,
  ``train/recon_graph.py``); always on, plain integer adds.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "im23d."
COUNTERS = {"h2d_bytes": 0, "d2h_bytes": 0, "recon_graph_steps": 0,
            "recon_eager_steps": 0}
_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str, step: int | None = None):
    """The range ``im23d.<name>`` while a profiler records, else the
    shared null context."""
    if not _recording():
        return _NULL
    return record_function(PREFIX + name,
                           None if step is None else str(step))


def copy_bytes(t: torch.Tensor, device) -> int:
    """The bytes that ``t.to(device)`` moves from host memory to a CUDA
    device: ``t``'s when it is on the host and ``device`` is CUDA, else
    0."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.numel() * t.element_size()
    return 0


def to_device(t: torch.Tensor, device, non_blocking: bool = False
              ) -> torch.Tensor:
    """``t.to(device)``, its host-to-device bytes counted."""
    COUNTERS["h2d_bytes"] += copy_bytes(t, device)
    return t.to(device, non_blocking=non_blocking)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, its device-to-host bytes counted."""
    if t.device.type == "cuda":
        COUNTERS["d2h_bytes"] += t.numel() * t.element_size()
    return t.cpu()


class StepProfiler:
    """``tick()`` once per iteration: the trace starts at iteration
    ``start`` (past the warm-up steps) and stops after ``steps`` more, then
    is written to ``log_dir`` as a Chrome trace, the program's spans in
    it.  ``close()`` ends a window that is still open."""

    def __init__(self, log_dir: str, start: int = 12, steps: int = 5):
        self.log_dir = log_dir
        self.start = start
        self.stop = start + steps
        self._it = 0
        self._prof = None

    def tick(self) -> None:
        if self._it == self.start:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        elif self._it == self.stop:
            self.close()
        self._it += 1

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir,
                            f"trace_steps_{self.start}-{self._it}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"wrote profiler trace (steps {self.start}-{self._it}) to "
              f"{path}")
