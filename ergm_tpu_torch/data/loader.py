"""Batch loader (counterpart of ``ergm_tpu/data/grain_loader.py``).

``--num_workers=k`` (k > 0) collates batches in k worker processes of a
``torch.utils.data.DataLoader``: the workers run the numpy ``collate``
of ``data/dataset.py`` and touch no CUDA; with k = 0 the loader collates
in the calling process. The batches are the ones ``dataset.batches``
yields for the same ``(seed, shuffle, drop_remainder, length_grouped,
pad_multiple)``, in the same order, because both take their index lists
from ``dataset.batch_order``. So ``--num_workers=k`` trains on what
``--num_workers=0`` trains on, only collated in parallel. JAX's Grain
pipeline shuffles with its own permutation, so there the two paths
differ; here they do not, and ``length_grouped`` holds on both.

One loader serves every epoch of a split: its workers start once and
stay up, and setting ``loader.sampler.seed`` before an epoch picks that
epoch's shuffle. They start by the ``forkserver`` method: a process
with threads (the trainer's) must not fork, and under ``spawn`` every
worker would import torch and the main module anew (seconds each); the
fork server imports them once per process and forks the workers from
itself. ``close`` stops a loader's workers when its user is done with it
(the Trainer at the end of ``train``), not when it is collected.

Several hosts (``host_count > 1``) take JAX's plain path's rule: each
epoch's index space is shuffled globally, then host ``host_index`` keeps
its strided, equal-length shard (``dataset.host_shard_order``) and
batches it in order. Within a host a data-parallel rank collates only
its ``rows`` of each batch, padded as the whole batch, so the ranks'
rows put together are the single-process batches.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import torch

from ergm_tpu_torch.data.dataset import (Batch, DialogueDataset, Subset, batch_order, collate,
                                         host_shard_order)


class BatchOrder(torch.utils.data.Sampler):
    """One epoch's index lists, ``dataset.batch_order``'s for the current
    ``seed`` (over this host's shard when ``host_count > 1``); it is read
    in the loader's own process."""

    def __init__(self, dataset: DialogueDataset, batch_size: int, seed: int,
                 host_index: int = 0, host_count: int = 1, **kw):
        self.dataset, self.batch_size, self.seed, self.kw = dataset, batch_size, seed, kw
        self.host_index, self.host_count = host_index, host_count

    def _order(self) -> list:
        if self.host_count <= 1:
            return batch_order(self.dataset, self.batch_size, seed=self.seed, **self.kw)
        idx = host_shard_order(len(self.dataset), self.host_index, self.host_count,
                               shuffle=self.kw.get("shuffle", False), seed=self.seed)
        kw = {**self.kw, "shuffle": False}
        return [idx[b] for b in batch_order(Subset(self.dataset, idx), self.batch_size,
                                            seed=self.seed, **kw)]

    def __iter__(self):
        return iter(self._order())

    def __len__(self) -> int:
        return len(self._order())


class _Collated(torch.utils.data.Dataset):
    """The batch of an index list: ``collate`` over its examples."""

    def __init__(self, dataset: DialogueDataset, eos_id: int, batch_size: int,
                 pad_multiple: int, max_len: int, rows=None):
        self.dataset = dataset
        self.args = (eos_id, batch_size, pad_multiple, max_len)
        self.rows = rows

    def __getitem__(self, idx: np.ndarray) -> Batch:
        return collate([self.dataset[j] for j in idx], *self.args, rows=self.rows)


def _fork_server():
    """The ``forkserver`` context, its server loading this module (and so
    torch) and the main module before it forks the first worker."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", __name__])
    return ctx


def make_loader(
    dataset: DialogueDataset,
    *,
    batch_size: int,
    eos_id: int,
    shuffle: bool = False,
    seed: int = 0,
    pad_multiple: int = 128,
    max_len: int = 1024,
    drop_remainder: bool = False,
    length_grouped: int = 0,
    num_workers: int = 0,
    pin_memory: bool = False,
    host_index: int = 0,
    host_count: int = 1,
    rows=None,
) -> torch.utils.data.DataLoader:
    """An iterable of ``dataset.Batch``, one epoch each time it is iterated
    (``loader.sampler.seed`` sets the next one's shuffle). ``pin_memory``
    (for a CUDA trainer) hands the batches over as page-locked tensors
    (``Batch.pin_memory``). ``host_index`` / ``host_count``: this host's
    shard of the dataset; ``rows=(lo, hi)``: the rows of each batch this
    process collates (``core.mesh.batch_rows``)."""
    order = BatchOrder(dataset, batch_size, seed, host_index=host_index, host_count=host_count,
                       shuffle=shuffle, drop_remainder=drop_remainder,
                       length_grouped=length_grouped)
    return torch.utils.data.DataLoader(
        _Collated(dataset, eos_id, batch_size, pad_multiple, max_len, rows), batch_size=None,
        sampler=order, num_workers=num_workers, pin_memory=pin_memory,
        persistent_workers=num_workers > 0,
        multiprocessing_context=_fork_server() if num_workers else None)


def close(loader: torch.utils.data.DataLoader) -> None:
    """Stops ``loader``'s worker processes now; its next epoch starts them
    again. A loader without workers has nothing to stop."""
    if loader._iterator is not None:
        loader._iterator._shutdown_workers()
        loader._iterator = None
