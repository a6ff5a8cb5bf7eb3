"""Input pipeline of the port (its own copy of the numpy iterators of
cspn_monodepth_tpu/data/pipeline.py, and a PyTorch `device_prefetch`).

* Batches are channels-last numpy: rgb (B, H, W, 3), depth (B, H, W), in
  the compact wire format of `pack_batch` (uint8 rgb, uint16 depth in
  1/256 m), decoded on the device by the Trainer.
* A thread pool builds records concurrently and a bounded queue prefetches
  batches ahead of the step.
* Shuffling is a seeded per-epoch permutation, so an epoch's batches are a
  pure function of (seed, epoch, step), and a run resumed at step s of an
  epoch (`start_step`) reads what an uninterrupted run read from s on.
* On a mesh each share (process_index of process_count) is its own
  consecutive images of every global batch, from the same permutation.
  The Trainer hands out one share a rank on the images layout, and one a
  data group on the rows layout (process_index the data index, every
  spatial rank of the group reading the same images; parallel/mesh.py).
* `device_prefetch` copies each batch from pinned host memory with
  non-blocking copies, DEVICE_AHEAD batches ahead of use, so the copy
  overlaps the running step.
"""

from __future__ import annotations

import collections
import queue
import threading
from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

DEPTH_SCALE = 256.0  # uint16 depth wire format: 1/256 m resolution, 256 m max
PREFETCH = 4         # host batches built ahead of use
DEVICE_AHEAD = 2     # batches copied to the device ahead of use


def _stack(records: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


def pack_batch(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Compact wire format for the host-to-device copy: rgb as uint8, depth
    as uint16 (1/256 m, ~4 mm resolution), 3.2x fewer bytes than float32."""
    out = dict(batch)
    if batch["rgb"].dtype != np.uint8:
        out["rgb"] = np.clip(batch["rgb"] * 255.0 + 0.5, 0, 255).astype(
            np.uint8)
    if batch["depth"].dtype != np.uint16:
        out["depth"] = np.clip(batch["depth"] * DEPTH_SCALE + 0.5, 0,
                               65535).astype(np.uint16)
    return out


class _PrefetchIterator:
    """Iterates batches start..num_batches-1 with a bounded background
    prefetch queue. Batches before `start` are skipped by index, with no
    work: make_batch is a pure function of its index."""

    def __init__(self, make_batch, num_batches: int,
                 pool: ThreadPoolExecutor, start: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._n = max(num_batches - start, 0)
        self._stop = threading.Event()
        self._pool = pool

        def producer():
            for i in range(start, num_batches):
                if self._stop.is_set():
                    return
                try:
                    item = make_batch(i)
                except Exception as e:  # surface errors to the consumer
                    item = e
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for _ in range(self._n):
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        """Stop the producer and the worker pool."""
        self._stop.set()
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=True)


def _local_batch(global_batch: int, process_count: int) -> int:
    if global_batch % process_count:
        raise ValueError(f"batch {global_batch} does not split over "
                         f"{process_count} ranks")
    return global_batch // process_count


def make_train_iterator(dataset, *, global_batch: int, epoch: int,
                        seed: int = 0, num_workers: int = 8, steps: int = 0,
                        start_step: int = 0, process_index: int = 0,
                        process_count: int = 1):
    """Yield one epoch of packed batches from `start_step` on, this rank's
    share of each global batch; drops the final partial batch. `steps`
    overrides the epoch length if nonzero."""
    n = len(dataset)
    local = _local_batch(global_batch, process_count)
    num_batches = steps or max(n // global_batch, 1)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    perm = rng.permutation(max(n, global_batch)) % max(n, 1)
    pool = ThreadPoolExecutor(max_workers=num_workers)

    def make_batch(step: int) -> dict[str, np.ndarray]:
        # Reduce the step's offset modulo n first, then add the rank's
        # offset modulo len(perm): with fewer records than the global batch
        # each rank still takes its own slice of the permutation.
        base = (step * global_batch) % max(n, 1)
        idx = [perm[(base + process_index * local + i) % len(perm)]
               for i in range(local)]
        records = list(pool.map(lambda j: dataset.get(int(j), epoch), idx))
        return pack_batch(_stack(records))

    return _PrefetchIterator(make_batch, num_batches, pool, start=start_step)


def make_eval_iterator(dataset, *, global_batch: int, num_workers: int = 8,
                       process_index: int = 0, process_count: int = 1):
    """Deterministic eval batches, this rank's share of each; the final
    batch is padded, with a `valid_image` weight (and an all-invalid
    target) for the padding."""
    n = len(dataset)
    local = _local_batch(global_batch, process_count)
    num_batches = -(-n // global_batch)
    pool = ThreadPoolExecutor(max_workers=num_workers)

    def make_batch(step: int) -> dict[str, np.ndarray]:
        records, valid = [], []
        for i in range(local):
            j = step * global_batch + process_index * local + i
            records.append(dataset.get(min(j, n - 1), epoch=0))
            valid.append(j < n)
        batch = _stack(records)
        v = np.asarray(valid, np.float32)
        batch["depth"] = batch["depth"] * v[:, None, None]
        batch = pack_batch(batch)
        batch["valid_image"] = v
        return batch

    return _PrefetchIterator(make_batch, num_batches, pool)


def device_prefetch(iterator, device: str | torch.device):
    """Yield the iterator's numpy batches as tensors on `device`, copied
    DEVICE_AHEAD batches ahead of use. On a CUDA device each array goes through
    pinned host memory with a non-blocking copy on the current stream,
    which the step then uses in order."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > DEVICE_AHEAD:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
