"""``paddle.io`` of the port (counterpart of ``paddle_tpu/io/__init__.py``):
datasets, samplers and the ``DataLoader``.

Batches are ``torch.Tensor``s on the host (``default_collate_fn`` stacks
numpy samples into them); the consumer moves them to its device, as
``hapi.Model`` and ``jit.TrainStep`` do. The random samplers and
``random_split`` draw from numpy's global generator, as the reference's
do, so after ``paddle_tpu_torch.seed(s)`` the two packages see the same
batches in the same order.

``num_workers > 0`` runs that many worker processes (``spawn``): the
parent draws every batch's indices from the batch sampler, worker ``w``
loads and collates batches ``w, w + n, ...`` and the parent takes them
in turn, so the batches and their order are those of ``num_workers=0``.
(The reference's workers each iterate their own copy of the sampler,
which with ``shuffle=True`` draws in each worker from an unseeded
generator: ROADMAP Queue 3.) An ``IterableDataset`` is iterated in every
worker, which shards it through :func:`get_worker_info`.
``use_shared_memory=False``, or a loader that cannot be sent to a
worker, runs one prefetching thread instead, as the reference's does.
"""
from __future__ import annotations

import multiprocessing
import pickle
import queue
import threading
import time
import traceback
import warnings

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "BatchSampler", "Sampler", "SequenceSampler", "RandomSampler",
    "SubsetRandomSampler", "WeightedRandomSampler",
    "DistributedBatchSampler", "DataLoader",
    "get_worker_info", "default_collate_fn",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Sample ``i`` is ``tuple(t[i] for t in tensors)``."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Sample ``i`` joins sample ``i`` of every dataset into one tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else self.cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of ``lengths`` (or fractions, the remainder dealt one by
    one from the first) over one numpy permutation."""
    lengths = list(lengths)
    if all(isinstance(n, float) for n in lengths):
        total = len(dataset)
        counts = [int(np.floor(total * f)) for f in lengths]
        for i in range(total - sum(counts)):
            counts[i % len(counts)] += 1
        lengths = counts
    idx = np.random.permutation(sum(lengths)).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, idx[offset:offset + n]))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A numpy permutation (or ``randint`` draws with ``replacement``),
    drawn when iteration starts."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n,
                                          size=self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(np.asarray(self.indices)).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement,
                                     p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank ``rank``'s share of the samples, the index list padded (or,
    with ``drop_last``, cut) to a multiple of ``num_replicas``; shuffled
    by ``RandomState(epoch)`` (:meth:`set_epoch`). The port runs one rank
    until ``torch.distributed`` comes (ROADMAP Queue 1 item 11): the
    defaults are rank 0 of 1."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.nranks = num_replicas if num_replicas is not None else 1
        self.local_rank = rank if rank is not None else 0
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = (len(dataset) // self.nranks if drop_last
                            else int(np.ceil(len(dataset) / self.nranks)))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = (np.random.RandomState(self.epoch).permutation(n).tolist()
                   if self.shuffle else list(range(n)))
        if not self.drop_last:
            indices += indices[:self.total_size - len(indices)]
        else:
            indices = indices[:self.total_size]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if len(batch) == self.batch_size or not self.drop_last:
                yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id=0, num_workers=1, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Inside a worker (process or prefetch thread): its ``id``,
    ``num_workers`` and ``dataset``; ``None`` in the main process."""
    return _worker_info


def default_collate_fn(batch):
    """Stack samples into batch tensors: arrays and tensors along a new
    first axis, ints as int64, floats as float32, tuples / lists / dicts
    field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (bool, np.bool_)):
        return batch
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(s))
                            for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch])
                for k in sample}
    return batch


def _to_arrays(obj):
    """A batch's tensors as tagged numpy arrays: pickled by value through
    the worker's queue (a pickled tensor would be a handle into the
    worker's shared memory, gone once the worker exits)."""
    if isinstance(obj, torch.Tensor):
        return ("__tensor__", obj.numpy())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_arrays(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_arrays(v) for k, v in obj.items()}
    return obj


def _from_arrays(obj):
    if isinstance(obj, tuple) and len(obj) == 2 and \
            isinstance(obj[0], str) and obj[0] == "__tensor__":
        return torch.from_numpy(obj[1])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_arrays(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_arrays(v) for k, v in obj.items()}
    return obj


def _worker_loop(w, n, loader, index_queue, out_queue):
    """A worker process: batch ``b`` of a map-style dataset for each
    index list it is sent (until ``None``), or its share of an iterable
    dataset's stream; then ``("eof", None)``, or ``("error", traceback)``
    on a fault."""
    global _worker_info
    _worker_info = _WorkerInfo(w, n, loader.dataset)
    try:
        if loader.worker_init_fn is not None:
            loader.worker_init_fn(w)
        if loader._iterable_ds:
            items = loader._raw_iter()
        else:
            items = (loader._fetch(idxs)
                     for idxs in iter(index_queue.get, None))
        for item in items:
            out_queue.put(("ok", _to_arrays(item)))
        out_queue.put(("eof", None))
    except BaseException:
        out_queue.put(("error", traceback.format_exc()))


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_ds = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", None)
        elif self._iterable_ds:
            self.batch_sampler = None
            self.batch_size = batch_size
        else:
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last) if batch_size is not None else None

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("DataLoader over IterableDataset has no len()")

    def _raw_iter(self):
        if self._iterable_ds:
            if self.batch_size is None:
                yield from self.dataset
                return
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        for indices in self._index_lists():
            yield self._fetch(indices)

    def _index_lists(self):
        if self.batch_sampler is None:
            return ([i] for i in range(len(self.dataset)))
        return iter(self.batch_sampler)

    def _fetch(self, indices):
        """One batch (one sample without a batch sampler)."""
        if self.batch_sampler is None:
            return self.dataset[indices[0]]
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self.num_workers == 0:
            return self._raw_iter()
        if self.use_shared_memory:
            return self._mp_iter()
        return self._threaded_iter()

    def _mp_iter(self):
        n = self.num_workers
        ctx = multiprocessing.get_context("spawn")
        index_qs = [ctx.Queue() for _ in range(n)]
        out_qs = [ctx.Queue(maxsize=self.prefetch_factor) for _ in range(n)]
        procs = []
        try:
            for w in range(n):
                p = ctx.Process(target=_worker_loop,
                                args=(w, n, self, index_qs[w], out_qs[w]),
                                daemon=True)
                p.start()          # pickles the loader here
                procs.append(p)
        except (TypeError, AttributeError, pickle.PicklingError) as exc:
            warnings.warn(
                f"DataLoader: could not start workers ({exc!r}); "
                "prefetching in a thread instead. Make the dataset, "
                "sampler and collate_fn picklable for worker processes.")
            self._stop(procs, index_qs, out_qs)
            yield from self._threaded_iter()
            return
        try:
            if not self._iterable_ds:
                for b, idxs in enumerate(self._index_lists()):
                    index_qs[b % n].put(list(idxs))
            for q in index_qs:
                q.put(None)
            done, w = [False] * n, 0
            while not all(done):
                if not done[w]:
                    kind, payload = self._get(out_qs[w], procs[w], w)
                    if kind == "error":
                        raise RuntimeError(
                            f"DataLoader worker {w} failed:\n{payload}")
                    if kind == "eof":
                        done[w] = True
                    else:
                        yield _from_arrays(payload)
                w = (w + 1) % n
        finally:
            self._stop(procs, index_qs, out_qs)

    def _get(self, q, proc, w):
        """The next message of worker ``w``, polled a second at a time so
        a worker that died without a message is noticed."""
        deadline = time.monotonic() + self.timeout if self.timeout else None
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if not proc.is_alive():
                    try:
                        return q.get(timeout=0.05)
                    except queue.Empty:
                        raise RuntimeError(
                            f"DataLoader worker {w} (pid {proc.pid}, "
                            f"exitcode {proc.exitcode}) exited "
                            "unexpectedly") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"DataLoader worker {w} produced no "
                                       f"batch within {self.timeout}s")

    @staticmethod
    def _stop(procs, index_qs, out_qs):
        for p in procs:
            p.join(timeout=0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in index_qs + out_qs:
            q.cancel_join_thread()
            q.close()

    def _threaded_iter(self):
        """One thread runs :meth:`_raw_iter` ahead of the consumer (it is
        the whole worker pool: ``get_worker_info()`` says 1 worker)."""
        q = queue.Queue(maxsize=self.prefetch_factor
                        * max(1, self.num_workers))
        sentinel = object()
        err = []

        def producer():
            global _worker_info
            _worker_info = _WorkerInfo(0, 1, self.dataset)
            try:
                for item in self._raw_iter():
                    q.put(item)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while (item := q.get()) is not sentinel:
            yield item
        if err:
            raise err[0]
