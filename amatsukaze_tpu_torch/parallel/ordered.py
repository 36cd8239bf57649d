"""Ordered-parallel analysis: run K producers concurrently but deliver
their items strictly round-robin in order.

A copy of amatsukaze_tpu/parallel/ordered.py (it holds no JAX). Parity:
AMTOrderedParallel (Amatsukaze/FilteredSource.hpp:850-900) — the
AutoVfr flow runs several analysis clips in parallel but must consume their
frames in a fixed interleave. Here producers are iterators drained by a
thread each into bounded queues; `ordered_parallel` yields
(producer_index, item) in round-robin order, which keeps the producers'
pipelines busy while preserving deterministic output order.
"""

from __future__ import annotations

import queue
import threading

_SENTINEL = object()


def ordered_parallel(producers, queue_size: int = 8):
    """producers: list of iterables. Yields (index, item) round-robin:
    p0[0], p1[0], ..., pK[0], p0[1], ... until every producer is done
    (exhausted producers are skipped)."""
    qs = [queue.Queue(maxsize=queue_size) for _ in producers]
    errors: list[BaseException | None] = [None] * len(producers)

    def drain(i, it):
        try:
            for item in it:
                qs[i].put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            errors[i] = e
        finally:
            qs[i].put(_SENTINEL)

    threads = [
        threading.Thread(target=drain, args=(i, it), daemon=True)
        for i, it in enumerate(producers)
    ]
    for t in threads:
        t.start()
    live = [True] * len(producers)
    try:
        while any(live):
            for i, q in enumerate(qs):
                if not live[i]:
                    continue
                item = q.get()
                if item is _SENTINEL:
                    live[i] = False
                    if errors[i] is not None:
                        raise errors[i]
                    continue
                yield i, item
    finally:
        for i, t in enumerate(threads):
            # unblock producers stuck on a full queue, then join
            live[i] = False
            while True:
                try:
                    qs[i].get_nowait()
                except queue.Empty:
                    break
        for t in threads:
            t.join(timeout=1.0)
