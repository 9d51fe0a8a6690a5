"""Minimal threaded batch loader: dataset -> (EventBatch, targets, images).

A copy of ``dagr_tpu.data.loader``: in place of the reference's
torch-geometric DataLoader (reference: scripts/train_dsec.py:130-134), a
host-side prefetching iterator that feeds the fixed-shape ``collate``
(CPU tensors; the caller moves them to the model's device).  IO (h5 and
png decoding) releases the GIL, so a small thread pool overlaps loading
with the card's work.  With ``shuffle`` the order comes from ``seed``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from dagr_tpu_torch.data.sample import collate


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        n_nodes: int,
        shuffle: bool = False,
        drop_last: bool = True,
        max_gt: int = 100,
        with_images: bool = False,
        with_bbox0: bool = False,
        seed: int = 0,
        num_workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_nodes = n_nodes
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_gt = max_gt
        self.with_images = with_images
        self.with_bbox0 = with_bbox0
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = []
            for b in range(nb):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                futures.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in idxs])
            for batch_futs in futures:
                samples = [f.result() for f in batch_futs]
                yield collate(
                    samples, self.n_nodes, self.max_gt,
                    with_images=self.with_images,
                    with_bbox0=self.with_bbox0,
                )
