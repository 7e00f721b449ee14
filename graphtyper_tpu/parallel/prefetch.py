"""Host/device pipeline: overlap read decoding (host CPU) with alignment and
genotyping (device) via double buffering.

The reference has no pipeline parallelism — its iterations are sequential
barriers (genotype.cpp:427-578) and BAM decode happens inline on the worker
thread that also scores reads. With a device the natural split is: the host decodes
and packs the next read batch while the device crunches the current one
(SURVEY §2.5 "Pipeline parallelism"). jax dispatch is asynchronous, so the
overlap only needs the host to enqueue the device step before starting the
next decode.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import jax


def prefetch_to_device(
    batch_iter: Iterable, size: int = 2, device=None
) -> Iterator:
    """Stage host batches onto the device `size` ahead of consumption.

    Each batch is a pytree of numpy arrays; a background thread runs
    jax.device_put so H2D transfer overlaps with the consumer's compute.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    err: list[BaseException] = []

    def producer():
        try:
            for batch in batch_iter:
                q.put(jax.device_put(batch, device))
        except BaseException as e:  # surfaced to the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item


def pipelined_map(
    decode_fn: Callable[[int], object],
    device_fn: Callable,
    n_batches: int,
    prefetch: int = 2,
) -> list:
    """Run device_fn over decode_fn(0..n_batches-1) with decode/compute
    overlap. jax already overlaps ONE in-flight decode with device compute
    (dispatch is asynchronous), so the extra win here is concurrency across
    decodes: an IO/zlib-bound decode_fn (BGZF inflate, BAM unpack — all
    GIL-releasing) runs on a `prefetch`-wide thread pool while results are
    consumed in order and dispatched to the device. Returns the list of
    device results (not blocked; call jax.block_until_ready to sync)."""
    from concurrent.futures import ThreadPoolExecutor

    results = []
    if n_batches <= 0:
        return results
    with ThreadPoolExecutor(max_workers=max(1, prefetch)) as pool:
        pending = {}
        next_submit = 0
        for _ in range(min(max(1, prefetch), n_batches)):
            pending[next_submit] = pool.submit(decode_fn, next_submit)
            next_submit += 1
        for i in range(n_batches):
            batch = pending.pop(i).result()  # re-raises decode errors
            if next_submit < n_batches:
                pending[next_submit] = pool.submit(decode_fn, next_submit)
                next_submit += 1
            if isinstance(batch, (tuple, list)):
                results.append(device_fn(*batch))
            else:
                results.append(device_fn(batch))
    return results
