"""Feature-clip dataset over the shard store (counterpart of
h36x/data/features.py): subject filtering, clip x variant items when
augmenting, an LRU shard cache, and joints3d converted mm -> m.
:meth:`FeatureClipDataset.get_batch` gathers a batch of rows into stacked
numpy arrays shard by shard, which is what the device feed consumes.

The features keep their stored dtype here (float32, float16, or bfloat16
held as its uint16 bits, :mod:`h36x_torch.data.shards`); the cast to the
feed dtype (`--data.feed-dtype`) happens in the feed, on whichever side of
the host-to-device copy holds the narrower dtype
(:func:`h36x_torch.parallel.feed.to_device`). A reference-format `.pt`
store (index.pt) reads its shards through
:func:`h36x_torch.data.shards.load_torch_shard`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from h36x_torch.data import shards as shard_store


class FeatureClipDataset:
    def __init__(
        self,
        root,
        subjects: Optional[List[int]] = None,
        max_clips: Optional[int] = None,
        test_set: bool = False,
        augment: bool = False,
        shard_cache_size: int = 2,
        log_loads_every: int = 0,
    ):
        self.root = Path(root)
        self.test_set = test_set
        self.augment = augment

        index = shard_store.load_index(self.root)
        self.torch_format = bool(index.get("torch_format"))
        # rows are addressed as clip["row"] + variant: the grouped layout,
        # the only one h36x writes; refuse any other rather than misread it
        if not index.get("variants_grouped", True):
            raise RuntimeError(
                f"{self.root}: index declares variants_grouped=false — this "
                "reader only supports the grouped row layout "
                "(row = clip row + variant offset)")
        self.n_vars = int(index["n_variants"])
        self.aug_names = index.get("aug_names", ["orig"])
        self.seq_len = index.get("seq_len")
        self.frame_skip = index.get("frame_skip")

        clips = index["clips"]
        if subjects is not None:
            subj = set(int(s) for s in subjects)
            clips = [c for c in clips if int(c["subject"]) in subj]
        if max_clips is not None:
            clips = clips[:max_clips]
        if not clips:
            raise RuntimeError(f"no clips under {root} for subjects={subjects}")
        self.clips = clips

        if augment:
            self._items = [(c, v) for c in clips for v in range(self.n_vars)]
        else:
            self._items = [(c, 0) for c in clips]

        self._reader = shard_store.ShardReader(
            self.root, cache_size=shard_cache_size, log_loads_every=log_loads_every,
            loader=shard_store.load_torch_shard if self.torch_format else None)

    def __len__(self) -> int:
        return len(self._items)

    @property
    def items(self):
        return self._items

    @property
    def feature_dim(self) -> int:
        """The width of the stored features (the extraction backbone's),
        read from the first clip's shard."""
        return int(self._reader.get(int(self.clips[0]["shard_id"]))["feats"].shape[-1])

    def shard_id_of(self, idx: int) -> int:
        return int(self._items[idx][0]["shard_id"])

    def cache_stats(self) -> dict:
        return self._reader.stats()

    def get_batch(self, indices: Sequence[int]):
        """Gather rows into stacked arrays: (feats, joints3d, joints2d, K[, meta]),
        joints3d in metres, feats in the store's dtype (bfloat16 as its
        bits: :func:`h36x_torch.data.shards.as_tensor` reads them)."""
        n = len(indices)
        if n == 0:
            raise ValueError("get_batch() called with no indices")
        by_shard: dict = {}
        for pos, idx in enumerate(indices):
            clip, var = self._items[idx]
            by_shard.setdefault(int(clip["shard_id"]), []).append(
                (pos, int(clip["row"]) + var))

        first_sid = next(iter(by_shard))
        first_shard = self._reader.get(first_sid)
        feats = np.empty((n,) + first_shard["feats"].shape[1:],
                         dtype=first_shard["feats"].dtype)
        joints3d = np.empty((n,) + first_shard["joints3d"].shape[1:], dtype=np.float32)
        joints2d = np.empty((n,) + first_shard["joints2d"].shape[1:], dtype=np.float32)
        K = np.empty((n, 3, 3), dtype=np.float32)
        meta: list = [None] * n
        for sid, rows in by_shard.items():
            shard = first_shard if sid == first_sid else self._reader.get(sid)
            pos_arr = np.array([p for p, _ in rows])
            row_arr = np.array([r for _, r in rows])
            feats[pos_arr] = shard["feats"][row_arr]
            joints3d[pos_arr] = (
                np.asarray(shard["joints3d"][row_arr], dtype=np.float32) / 1000.0)
            joints2d[pos_arr] = np.asarray(shard["joints2d"][row_arr], dtype=np.float32)
            K[pos_arr] = np.asarray(shard["K"][row_arr], dtype=np.float32)
            if self.test_set:
                for p, r in rows:
                    meta[p] = shard["meta"][r]

        if self.test_set:
            return feats, joints3d, joints2d, K, meta
        return feats, joints3d, joints2d, K
