"""Threaded batch prefetching for the host input pipelines (a copy of
``im23d_tpu/data/prefetch.py``): the decode work (PIL decode, crops)
releases the GIL, so a thread pool with a bounded lookahead overlaps it with
the consumer, which stays a plain iterator."""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


def prefetched_batches(index_batches: Sequence, build: Callable,
                       num_workers: int = 4, lookahead: int = 3) -> Iterator:
    """Yield ``build(idx)`` for each index batch, built ``lookahead`` batches
    ahead on ``num_workers`` threads.  ``num_workers <= 1`` degrades to the
    serial loop (no threads, deterministic debugging)."""
    index_batches = list(index_batches)
    if num_workers <= 1 or len(index_batches) <= 1:
        for idx in index_batches:
            yield build(idx)
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: deque = deque()
        it = iter(index_batches)
        for idx in it:
            pending.append(pool.submit(build, idx))
            if len(pending) > lookahead:
                yield _wait(pending)
        while pending:
            yield _wait(pending)


def _wait(pending: deque):
    """The oldest pending batch, the consumer's wait for it a span."""
    # imported here: the decode processes import this module, never torch
    from im23d_tpu_torch.core.profiler import span

    with span("feed.wait"):
        return pending.popleft().result()


def parallel_items(dataset, indices, pool: ThreadPoolExecutor | None):
    """Fetch ``dataset[i]`` for each index, on the pool when given."""
    if pool is None:
        return [dataset[int(i)] for i in indices]
    return list(pool.map(lambda i: dataset[int(i)], indices))
