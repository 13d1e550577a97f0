"""Shard-aware batch sampling (counterpart of h36x/data/sampler.py, pure
Python, the same `random.Random` draws in the same order, so a (seed,
epoch) gives the same batches in both packages).

MixedShardBatchSampler trades shuffle quality against shard-cache locality:
it buckets items by shard, then draws each batch round-robin from K randomly
chosen active shards, reshuffled per epoch by set_epoch.
"""

from __future__ import annotations

import random
from typing import Iterator, List


class MixedShardBatchSampler:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shards_per_batch: int = 4,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
    ):
        if batch_size % shards_per_batch != 0:
            raise ValueError("batch_size must be divisible by shards_per_batch")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.base_seed = seed
        self.seed = seed

        buckets: dict = {}
        for idx in range(len(dataset)):
            buckets.setdefault(dataset.shard_id_of(idx), []).append(idx)
        self.buckets = buckets

        # The round-robin draw needs K distinct active shards; a store with
        # fewer shards than requested would silently yield ZERO batches
        # (latent in the reference, samplers.py:48). Clamp K to the largest
        # divisor of batch_size that the store can actually sustain.
        k = min(shards_per_batch, max(1, len(buckets)))
        while batch_size % k != 0:
            k -= 1
        if k != shards_per_batch:
            print(
                f"MixedShardBatchSampler: only {len(buckets)} shard(s); "
                f"using shards_per_batch={k} (requested {shards_per_batch})"
            )
        self.k = k
        self.per_shard = batch_size // k

    def set_epoch(self, epoch: int) -> None:
        # offset from the CONFIGURED seed: the reference's bare
        # `seed = epoch` (samplers.py) makes every seed-sweep run iterate
        # byte-identical data orders, silently ignoring the seed flag
        self.seed = self.base_seed + epoch

    def _epoch_plan(self, rng: random.Random):
        """Per-epoch immutable item orders + a cursor per shard.

        Returns ordered shard ids, a {shard: tuple_of_indices} table and a
        {shard: int} cursor dict; drawing advances cursors only, so the
        underlying buckets are never mutated across epochs.
        """
        order = list(self.buckets)
        if self.shuffle:
            rng.shuffle(order)
        table = {}
        for sid in order:
            items = list(self.buckets[sid])
            if self.shuffle:
                rng.shuffle(items)
            table[sid] = tuple(items)
        return order, table, dict.fromkeys(order, 0)

    def __iter__(self) -> Iterator[List[int]]:
        rng = random.Random(self.seed)
        order, table, cursor = self._epoch_plan(rng)

        def remaining():
            return [s for s in order if cursor[s] < len(table[s])]

        def take(sid: int, n: int, batch: List[int]) -> None:
            lo = cursor[sid]
            hi = min(lo + n, len(table[sid]))
            batch.extend(table[sid][lo:hi])
            cursor[sid] = hi

        while True:
            live = remaining()
            total_left = sum(len(table[s]) - cursor[s] for s in live)
            if not live or (self.drop_last and total_left < self.batch_size):
                # true drop_last semantics: only a final sub-batch_size
                # remainder is ever dropped (see the top-up note below)
                return
            k_now = min(self.k, len(live))
            picks = rng.sample(live, k_now) if self.shuffle else live[:k_now]
            batch: List[int] = []
            for sid in picks:
                take(sid, self.per_shard, batch)
            # Unbalanced picks can come up short although items remain
            # live — top up from the other live shards, in BOTH drop_last
            # modes, so a sub-batch_size batch only ever appears as the
            # single final tail (drop_last=False) and __len__'s count is
            # exact: ceil(n/B) without, n//B with. (The reference instead
            # stops as soon as fewer than k shards stay non-empty —
            # samplers.py:48 — silently dropping every item left in the
            # surviving shards; deliberate fix.)
            while len(batch) < self.batch_size:
                live = remaining()
                if not live:
                    break
                sid = rng.choice(live) if self.shuffle else live[0]
                take(sid, self.batch_size - len(batch), batch)
            if len(batch) == self.batch_size or not self.drop_last:
                yield batch

    def __len__(self) -> int:
        total = len(self.dataset)
        if self.drop_last:
            return total // self.batch_size
        return (total + self.batch_size - 1) // self.batch_size


class SequentialBatchSampler:
    """Plain fixed-order batching for eval/test loops."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = False):
        self.n = len(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:  # interface parity
        del epoch

    def __iter__(self):
        for start in range(0, self.n, self.batch_size):
            batch = list(range(start, min(start + self.batch_size, self.n)))
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size
