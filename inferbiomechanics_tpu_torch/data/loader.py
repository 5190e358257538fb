"""Prefetching host loader.

PyTorch counterpart of ``inferbiomechanics_tpu/data/loader.py``: a
background thread assembles packed host batches (``WindowDataset.batches``)
and copies them to the device ahead of compute. On a CUDA device the batch
goes through pinned host memory and an asynchronous copy on a stream of
its own, and the consumer's stream waits for that copy only. With
``input_dtype=torch.bfloat16`` (``--host-upload-dtype bf16``) the inputs are
rounded to bf16 on the host, before the copy: half the bytes. Under data
parallelism each rank iterates its shard (``shard_index`` of
``num_shards``: ``WindowDataset.batches``' equal shards of the epoch's
order, the JAX package's replacement for DistributedSampler).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch

from inferbiomechanics_tpu_torch.data.dataset import Batch, WindowDataset


class PrefetchLoader:
    """Iterate batches whose ``inputs`` and ``labels`` are tensors on
    ``device``, with background host assembly."""

    def __init__(self, dataset: WindowDataset, batch_size: int, *, device='cpu',
                 shuffle: bool = True, drop_last: bool = True, prefetch: int = 2,
                 n_threads: Optional[int] = None,
                 input_dtype: torch.dtype = torch.float32,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.shard_index, self.num_shards = shard_index, num_shards
        self.input_dtype = input_dtype
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.n_threads = n_threads

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _to_device(self, host_batch: Batch, stream) -> Batch:
        def put(a, dtype=torch.float32):
            t = torch.from_numpy(a).to(dtype)
            if stream is None:
                return t
            return t.pin_memory().to(self.device, non_blocking=True)

        if stream is None:
            inputs, labels = put(host_batch.inputs, self.input_dtype), put(host_batch.labels)
            event = None
        else:
            with torch.cuda.stream(stream):
                inputs = put(host_batch.inputs, self.input_dtype)
                labels = put(host_batch.labels)
                event = torch.cuda.Event()
                event.record(stream)
        return Batch(inputs=inputs, labels=labels,
                     subject_indices=host_batch.subject_indices,
                     trial_indices=host_batch.trial_indices), event

    def epoch(self, seed: int = 0) -> Iterator[Batch]:
        """Yield one epoch of batches on the device."""
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == 'cuda' else None)

        def producer():
            try:
                for host_batch in self.dataset.batches(
                        self.batch_size, shuffle=self.shuffle,
                        drop_last=self.drop_last, seed=seed,
                        shard_index=self.shard_index, num_shards=self.num_shards,
                        n_threads=self.n_threads):
                    if stop.is_set():
                        return
                    q.put(self._to_device(host_batch, stream))
                q.put(None)
            except BaseException as e:      # surfaces in the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    torch.cuda.current_stream(self.device).wait_event(event)
                    for t in (batch.inputs, batch.labels):
                        t.record_stream(torch.cuda.current_stream(self.device))
                yield batch
        finally:
            stop.set()
            while thread.is_alive():        # unblock a producer stuck on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
