"""Host-side batching data loader with background prefetch (port of
diffulab_tpu/data/loader.py).

Replaces torch.utils.data.DataLoader (reference configs/dataloader/default.yaml):
collates dataset items (numpy pytrees) into stacked batches, shuffles with a
per-epoch seed, drops the trailing partial batch (the reference's jit wants
static shapes; the port keeps the batch count), and prefetches batches on a
background thread so host collation overlaps device compute. An error in
the prefetch thread is raised in the consumer, not taken for the epoch's end.

A ``sampler`` (the multi-aspect-ratio bucket sampler,
:class:`~diffulab_tpu_torch.data.imagenet.MultiARBatchSampler`) yields the
index batches in its own order instead, and ``collate_fn`` replaces the
default stacking (the text batches' :func:`~diffulab_tpu_torch.data.imagenet.collate_fn`);
``drop_last=False`` keeps the trailing partial batch.

Several processes (loader.py:43-61): ``batch_size`` is GLOBAL; every
process draws the same shuffled order and loads its own contiguous slice of
every global batch. The slice index is the process's coordinate on the
mesh's ``(data, fsdp)`` axes, the axes the batch shards over, not its global
rank (``process_index`` / ``process_count``, 0 and 1 unless given; the
trainers, which own the mesh, set them through :meth:`DataLoader.set_process_slice`
from :func:`~diffulab_tpu_torch.parallel.mesh.batch_shard`). A trailing partial batch is trimmed to the largest
length the processes divide, and one smaller than their count is dropped.
The batch order is the reference's for the same seed and epoch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np


def default_collate(items: Sequence[Any]) -> Any:
    """Stack a list of numpy pytrees into one batched pytree."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)) and not isinstance(first, str):
        return type(first)(default_collate([it[i] for it in items]) for i in range(len(first)))
    if isinstance(first, str):
        return list(items)
    return np.stack([np.asarray(it) for it in items], axis=0)


class DataLoader:
    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 collate_fn: Callable[[Sequence[Any]], Any] | None = None, sampler: Any | None = None,
                 prefetch: int = 2, process_index: int | None = None, process_count: int | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.sampler = sampler
        self.prefetch = prefetch
        self._epoch = 0
        self.process_index = 0 if process_index is None else process_index
        self.process_count = 1 if process_count is None else process_count

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (torch DistributedSampler convention): a
        resumed run calls this with the 0-based trainer epoch so epoch N
        replays epoch N's order instead of restarting the counter at 0.
        ``__iter__`` pre-increments, so the next iteration shuffles with
        ``seed + epoch + 1`` — exactly what an uninterrupted run used.
        Forwarded to a sampler, which owns the order then."""
        self._epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def set_process_slice(self, index: int, count: int) -> None:
        """Load the ``index``-th of ``count`` contiguous slices of every global batch."""
        self.process_index, self.process_count = index, count

    def __len__(self) -> int:
        # mirrors _batch_indices: with several processes, a batch smaller than their count is dropped
        pc = self.process_count
        if self.sampler is not None:
            if pc == 1:
                return len(self.sampler)
            # counting iterates the sampler, which advances its shuffle epoch: put it back
            saved_epoch = getattr(self.sampler, "_epoch", None)
            try:
                return sum(1 for batch in self.sampler if len(batch) // pc > 0)
            finally:
                if saved_epoch is not None:
                    self.sampler._epoch = saved_epoch
        full, rem = divmod(len(self.dataset), self.batch_size)
        if self.drop_last or rem == 0:
            return full
        return full + (1 if rem >= pc else 0)

    def _local_slice(self, batch: Sequence[int]) -> Sequence[int] | None:
        """This process's rows of a global batch (loader.py:118-132): a
        trailing partial batch is trimmed to the largest length the
        processes divide (every process must see the same number of batches
        of one shape), one smaller than their count dropped (None)."""
        pc = self.process_count
        if pc == 1:
            return batch
        local = len(batch) // pc
        if local == 0:
            return None
        pi = self.process_index
        return batch[pi * local: (pi + 1) * local]

    def _batch_indices(self) -> Iterator[Sequence[int]]:
        if self.sampler is not None:
            for batch in self.sampler:
                local = self._local_slice(batch)
                if local is not None:
                    yield local
            return
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        end = n - n % self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            local = self._local_slice(order[start: start + self.batch_size])
            if local is not None:
                yield local

    def _make_batch(self, idx: Sequence[int]) -> Any:
        # datasets exposing get_batch (native fused gather+normalize) skip the
        # per-item collate loop entirely
        if self.collate_fn is default_collate and hasattr(self.dataset, "get_batch"):
            return self.dataset.get_batch(idx)
        return self.collate_fn([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Any]:
        self._epoch += 1
        if self.prefetch <= 0:
            for idx in self._batch_indices():
                yield self._make_batch(idx)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []

        def producer():
            try:
                for idx in self._batch_indices():
                    q.put(self._make_batch(idx))
            except BaseException as e:  # raised in the consumer after the batches before it
                error.append(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
        if error:
            raise error[0]
