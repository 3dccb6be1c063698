"""``StepProfiler``: trace a window of training steps with
``torch.profiler`` (counterpart of ``StepProfiler`` in
``im23d_tpu/core/jax_setup.py``; ``--profile_dir`` of the recon CLI)."""

from __future__ import annotations

import os

import torch
from torch.profiler import ProfilerActivity, profile


class StepProfiler:
    """``tick()`` once per iteration: the trace starts at iteration
    ``start`` (past the warm-up steps) and stops after ``steps`` more, then
    is written to ``log_dir`` as a Chrome trace.  ``close()`` ends a window
    that is still open."""

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
