"""Length-bucketed batch samplers (copy of `torch_tts_tpu/data/sampler.py`).

- `DistributedBucketSampler`: per-rank, epoch-seeded, length-bucketed
  batches padded to a multiple of num_replicas * batch_size by resampling;
  each bucket carries its padded frame count (its upper boundary). The
  schedule is a pure function of the epoch (`np.random.default_rng(epoch)`),
  which resume relies on.
- `LengthBucketRandomSampler`: sort by length, shuffle within chunks, then
  shuffle the batches (the Tacotron recipe).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

import numpy as np


class DistributedBucketSampler:
    """Yields (pad_frames, dataset indices); the items of a batch share a
    length bucket.

    boundaries: ascending spec-frame-length edges, e.g. [32, 300, ..., 1000];
    items outside (boundaries[0], boundaries[-1]] are dropped. Each bucket's
    padded frame count is its upper boundary.
    """

    def __init__(self, lengths: Sequence[int], batch_size: int, boundaries: Sequence[int],
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0

        self.buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(self.lengths):
            b = self._bisect(length)
            if b != -1:
                self.buckets[b].append(i)
        # drop empty buckets (and their upper boundary)
        for i in range(len(self.buckets) - 1, -1, -1):
            if not self.buckets[i]:
                self.buckets.pop(i)
                self.boundaries.pop(i + 1)

        self.num_samples_per_bucket = []
        total = self.num_replicas * self.batch_size
        for bucket in self.buckets:
            rem = (total - (len(bucket) % total)) % total
            self.num_samples_per_bucket.append(len(bucket) + rem)

    def _bisect(self, x: int) -> int:
        i = bisect.bisect_left(self.boundaries, x)
        if 0 < i < len(self.boundaries):
            return i - 1
        return -1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def pad_frames_for_bucket(self, bucket_idx: int) -> int:
        return self.boundaries[bucket_idx + 1]

    def __iter__(self):
        g = np.random.default_rng(self.epoch)
        batches = []
        for bi, bucket in enumerate(self.buckets):
            ids = list(g.permutation(len(bucket))) if self.shuffle else list(range(len(bucket)))
            rem = self.num_samples_per_bucket[bi] - len(bucket)
            ids = ids + ids * (rem // len(bucket)) + ids[: rem % len(bucket)]
            ids = ids[self.rank :: self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                batch = [bucket[idx] for idx in ids[j * self.batch_size : (j + 1) * self.batch_size]]
                batches.append((bi, batch))
        if self.shuffle:
            order = g.permutation(len(batches))
            batches = [batches[i] for i in order]
        for bi, batch in batches:
            yield self.pad_frames_for_bucket(bi), batch

    def __len__(self):
        return sum(n // self.num_replicas for n in self.num_samples_per_bucket) // self.batch_size


class LengthBucketRandomSampler:
    """Sort by length, shuffle within buckets of `bucket_size_mult *
    batch_size`, chunk into batches, shuffle the batches."""

    def __init__(self, lengths: Sequence[int], batch_size: int, bucket_size_mult: int = 8,
                 seed: Optional[int] = None):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.bucket = bucket_size_mult * batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        order = np.argsort(self.lengths)
        buckets = [order[i : i + self.bucket] for i in range(0, len(order), self.bucket)]
        for b in buckets:
            self.rng.shuffle(b)
        flat = np.concatenate(buckets) if buckets else np.array([], dtype=int)
        batches = [list(flat[i : i + self.batch_size])
                   for i in range(0, len(flat), self.batch_size)]
        self.rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        return (len(self.lengths) + self.batch_size - 1) // self.batch_size
