"""The store side of an extraction run, one for both schedulers: the
shuffle pool and its shards, the resume record and its checks, a clip's
row group, and the close that commits index.json.

The store is h36x's format, byte for byte: clips shuffle across shards in
a seeded pool with a clip's variant rows contiguous. After every shard
flush a progress file records which clips landed in which shard rows; a
run restarted with resume=True skips those clips, re-processes the ones
still buffered in the shuffle pool, and appends new shards.
"""

from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import List

import numpy as np

from h36x_torch.config import DEFAULT_BACKBONE
from h36x_torch.data.augment import AUG_NAMES, hflip_joints, reverse_joints
from h36x_torch.data.shards import ShardWriter, write_index
from h36x_torch.extract.writer import AsyncWriter
from h36x_torch.geometry.camera import adjust_camera_after_crop_and_resize
from h36x_torch.geometry.crop import adjust_joints2d_after_crop_and_resize


class ShufflePool:
    """Clip-level shuffle pool flushing fixed-size shards.

    Accumulates groups (one clip = n_vars variant rows), shuffles at the
    clip level once the pool is full, writes full shards, carries the
    remainder into the next flush (the final partial shard included).
    """

    def __init__(self, writer: ShardWriter, n_vars: int, shard_size: int,
                 pool_size: int, seed: int, on_flush=None,
                 max_bytes: int = 0):
        self.writer = writer
        self.n_vars = n_vars
        self.shard_size = shard_size
        self.pool_size = pool_size
        self.rng = random.Random(seed)
        self.pool: List[List[dict]] = []
        self.carry: List[List[dict]] = []
        self.clip_index: List[dict] = []
        self.on_flush = on_flush
        # Host-RAM bound on the buffered groups (pool + carry): the default
        # 8192-clip pool holds ~10.7 GB at 4 variants x T=40 x the
        # backbone's width in f32 (2048 for ResNet-50 and HRNet-W48; 1280 for
        # ViT-H).
        # 0 = unbounded. Flushing early moves rows BETWEEN shards but never
        # changes row bytes.
        self.max_bytes = int(max_bytes)
        self._buf_bytes = 0
        self._byte_trim_logged = False

    @staticmethod
    def group_nbytes(group: List[dict]) -> int:
        """Exact buffered payload of one clip group (meta dicts excluded —
        ~200 B vs ~1.3 MB of arrays)."""
        return sum(int(e[k].nbytes) for e in group
                   for k in ("feat", "joints3d", "joints2d", "K"))

    def add(self, group: List[dict]) -> None:
        if len(group) != self.n_vars:
            raise ValueError(f"group has {len(group)} variants, expected {self.n_vars}")
        self.pool.append(group)
        over = False
        if self.max_bytes:
            self._buf_bytes += self.group_nbytes(group)
            # a flush can only free RAM once a full shard can be written;
            # below that, flushing would just reshuffle the carry every add
            over = (self._buf_bytes >= self.max_bytes
                    and len(self.pool) + len(self.carry) >= self.shard_size)
        if over and len(self.pool) + len(self.carry) < self.pool_size \
                and not self._byte_trim_logged:
            self._byte_trim_logged = True
            print(
                f"[extract] shuffle pool reached its byte budget "
                f"({self._buf_bytes / 2**30:.2f} GiB) at "
                f"{len(self.pool) + len(self.carry)} clips "
                f"(< shuffle_pool={self.pool_size}); flushing early — raise "
                f"--shuffle-pool-gb for stronger shuffling", flush=True)
        if len(self.pool) >= self.pool_size or over:
            self._flush(final=False)

    def _write_groups(self, groups: List[List[dict]]) -> None:
        arrays = {k: [] for k in ("feats", "joints3d", "joints2d", "K")}
        meta: List[dict] = []
        sid = self.writer.shard_id
        for i, g in enumerate(groups):
            m0 = g[0]["meta"]
            self.clip_index.append(
                {
                    "shard_id": sid,
                    "row": i * self.n_vars,
                    "subject": m0["subject"],
                    "action": m0["action"],
                    "cam": m0["cam"],
                    "start": m0["start"],
                    "end": m0["end"],
                }
            )
            for e in g:
                arrays["feats"].append(e["feat"])
                arrays["joints3d"].append(e["joints3d"])
                arrays["joints2d"].append(e["joints2d"])
                arrays["K"].append(e["K"])
                meta.append(e["meta"])
        stacked = {k: np.stack(v) for k, v in arrays.items()}
        self.writer.write(stacked, meta)

    def _flush(self, final: bool) -> None:
        combined = self.carry + self.pool
        self.pool = []
        self.rng.shuffle(combined)
        n_full = len(combined) // self.shard_size
        for s in range(n_full):
            self._write_groups(combined[s * self.shard_size : (s + 1) * self.shard_size])
        leftover = combined[n_full * self.shard_size :]
        if final and leftover:
            self._write_groups(leftover)
            self.carry = []
        else:
            self.carry = leftover
        if self.max_bytes:
            self._buf_bytes = sum(self.group_nbytes(g) for g in self.carry)
        if n_full and self.on_flush is not None:
            self.on_flush(self)

    def finish(self) -> None:
        self._flush(final=True)


def store_provenance() -> dict:
    """Which host backend wrote the pixels: the native library and the
    cv2 / numpy fallbacks differ by +-1 u8 on some pixels, so a resume where
    it changed is refused."""
    from h36x_torch import native

    return {"crop_backend": "native" if native.available() else "cv2",
            "jitter_backend": "native" if native.jitter_available() else "numpy"}


def backbone_provenance(cfg) -> dict:
    """The backbone a store's rows came from, for the resume check: nothing
    for the default backbone (ResNet-50), so that its progress files stay
    as they were."""
    backbone = getattr(cfg, "backbone", DEFAULT_BACKBONE)
    return {} if backbone == DEFAULT_BACKBONE else {"backbone": backbone}


def run_config(cfg, part_n: int) -> dict:
    """The store-shaping settings of a run with resolved modes, recorded
    per flush and checked on resume: resuming with any of them changed
    would mix incompatible rows into one store. h36x's schedulers record
    the same keys, so a store resumes under either scheduler of either
    package."""
    n_vars = len(AUG_NAMES) if cfg.augment else 1
    config = {
        "n_vars": n_vars, "seq_len": cfg.seq_len, "resize": cfg.resize,
        "frame_skip": cfg.frame_skip, "save_fp16": bool(cfg.save_fp16),
        "shuffle_seed": cfg.shuffle_seed, "partition": cfg.partition,
    }
    if part_n > 1:
        # partition semantics change the owned clip set; resuming a part
        # store under the other scheme would append the wrong clips
        config["partition_by"] = cfg.partition_by
    if cfg.crop_scope != "clip" or cfg.jitter_key != "clip":
        # deviation modes change feature bytes: a resume mixing them with
        # default-mode rows would corrupt the store silently
        config["crop_scope"] = cfg.crop_scope
        config["jitter_key"] = cfg.jitter_key
    provenance = store_provenance()
    config["crop_backend"] = provenance["crop_backend"]
    if n_vars > 1:
        config["jitter_backend"] = provenance["jitter_backend"]
    config.update(backbone_provenance(cfg))
    return config


def _clip_key(entry) -> tuple:
    """Resume identity of a clip; accepts progress-index dicts and
    ClipIndex objects so the done-set and the todo-filter can never drift."""
    if isinstance(entry, dict):
        return (int(entry["subject"]), str(entry["action"]),
                str(entry["cam"]), int(entry["start"]))
    return (int(entry.subject), str(entry.action), str(entry.cam),
            int(entry.start))


def clip_group(cfg, ci, box, j3d, j2d_raw, cam, feats) -> List[dict]:
    """A clip's rows for the shuffle pool, in AUG_NAMES order: `feats` holds
    its (T, width) features of orig, or with augment of orig, cjitter and
    hflip; trev's are orig's reversed in time."""
    j2d = adjust_joints2d_after_crop_and_resize(j2d_raw, box, cfg.resize)
    K = adjust_camera_after_crop_and_resize(cam["f"], cam["c"], box, cfg.resize)
    rows = [(feats[0], j3d, j2d, K)]
    if cfg.augment:
        f_orig, f_cj, f_hf = feats
        j3d_hf, j2d_hf, K_hf = hflip_joints(j3d, j2d, K, width=cfg.resize)
        j3d_tr, j2d_tr = reverse_joints(j3d, j2d)
        rows += [(f_cj, j3d, j2d, K), (f_hf, j3d_hf, j2d_hf, K_hf),
                 (f_orig[::-1].copy(), j3d_tr, j2d_tr, K)]
    meta = {"subject": int(ci.subject), "action": ci.action, "cam": ci.cam,
            "start": int(ci.start), "end": int(ci.end),
            "frame_skip": int(cfg.frame_skip), "box": [int(v) for v in box]}
    return [{"feat": feat,
             "joints3d": np.asarray(jj3, np.float32),
             "joints2d": np.asarray(jj2, np.float32),
             "K": np.asarray(kk, np.float32),
             "meta": dict(meta, aug=aug)}
            for aug, (feat, jj3, jj2, kk) in zip(AUG_NAMES, rows)]


class ThroughputPrinter:
    """clips/s + ETA every 200 clips, final-shard/pool state included."""

    def __init__(self, n_todo, pool, shard_writer):
        self.n_todo = n_todo
        self.pool = pool
        self.writer = shard_writer
        self.done = 0
        self.last_print = 0
        self.t_last = time.perf_counter()

    def clip_done(self):
        self.done += 1
        if self.done % 200 == 0 or self.done == self.n_todo:
            dt = time.perf_counter() - self.t_last
            inc = self.done - self.last_print  # clips in THIS interval
            cps = inc / dt if dt > 0 else 0.0
            self.t_last = time.perf_counter()
            self.last_print = self.done
            eta = (self.n_todo - self.done) / cps if cps > 0 else 0.0
            print(
                f"[{100*self.done/max(self.n_todo,1):5.1f}%] "
                f"{self.done:6d}/{self.n_todo} clips | "
                f"{cps:6.1f} clips/s | ETA {eta:6.1f}s | "
                f"shard {self.writer.shard_id} (pool {len(self.pool.pool)}, "
                f"carry {len(self.pool.carry)})",
                flush=True,
            )


class Store:
    """One run's store under `cfg.out`, used as a context manager around
    the run: the shard writer behind an :class:`AsyncWriter` thread, the
    shuffle pool, the progress file, resume and the close.

    When the run raises, leaving the block waits for the writes already
    submitted and stops the writer thread, so the shards and the
    progress.json that the flushes claimed are on disk and no thread is
    left behind; the run's exception is the one raised, with a failure of
    the writer noted on it.
    """

    def __init__(self, cfg, part_n: int):
        self.cfg = cfg
        self.root = Path(cfg.out)
        self.root.mkdir(parents=True, exist_ok=True)
        self.config = run_config(cfg, part_n)
        self.n_vars = self.config["n_vars"]
        self.feat_dtype = np.float16 if cfg.save_fp16 else np.float32
        self.progress_path = self.root / "progress.json"
        self.printer = None
        self.async_writer = AsyncWriter()
        self.writer = ShardWriter(self.root, self.n_vars, async_writer=self.async_writer)
        self.pool = ShufflePool(
            self.writer, self.n_vars, cfg.shard_size, cfg.shuffle_pool, cfg.shuffle_seed,
            on_flush=self._write_progress, max_bytes=int(cfg.shuffle_pool_gb * 2**30))

    def __enter__(self):
        return self

    def __exit__(self, kind, exc, tb):
        if exc is not None:
            try:
                self.async_writer.stop()
            except BaseException as err:
                if err.__cause__ is not exc.__cause__:  # not the run's own error
                    exc.add_note(f"the store's writer failed too: {err!r}, "
                                 f"from {err.__cause__!r}")
        return False

    def _write_progress(self, pool) -> None:
        """Atomic tmp+rename (a crash mid-write must never corrupt the file
        resume depends on), submitted through the same FIFO as the shard
        writes so progress never claims unwritten shards."""
        payload = json.dumps({"clips": pool.clip_index, "n_shards": pool.writer.shard_id,
                              "config": self.config})

        def write(text):
            tmp = Path(str(self.progress_path) + ".tmp")
            tmp.write_text(text)
            tmp.replace(self.progress_path)

        self.async_writer.submit(write, payload)

    def _restore(self) -> set:
        """Restore an interrupted run's pool/shard state; returns done clip
        keys. The provenance-backfill and mismatch rules decide whether
        resuming would mix incompatible rows into one store."""
        if not (getattr(self.cfg, "resume", False) and self.progress_path.exists()):
            return set()
        prog = json.loads(self.progress_path.read_text())
        prev = prog.get("config")
        if prev is not None:
            # pre-upgrade progress files predate some provenance keys; a
            # missing key means "unknown", not "different" — refusing would
            # strand a near-done extraction behind an unfixable mismatch
            for k in ("crop_backend", "jitter_backend", "partition_by"):
                if k in self.config and k not in prev:
                    print(f"WARNING: the interrupted run predates the {k!r} "
                          f"provenance record — cannot verify it matched "
                          f"{self.config[k]!r}; resuming anyway")
                    prev[k] = self.config[k]
        if prev is not None and prev != self.config:
            diffs = {k: (prev.get(k), v) for k, v in self.config.items()
                     if prev.get(k) != v}
            # keys only the interrupted run recorded (e.g. a dedup-scheduler
            # deviation flag) must show up too, not print an empty dict
            diffs.update({k: (prev[k], None) for k in prev if k not in self.config})
            raise ValueError(
                f"resume config mismatch vs the interrupted run: {diffs} — "
                "resuming would mix incompatible rows into one store; rerun "
                "with the original flags or start a fresh --out")
        self.pool.clip_index = prog["clips"]
        self.writer.shard_id = int(prog["n_shards"])
        done = {_clip_key(c) for c in prog["clips"]}
        print(f"Resuming: {len(done)} clips already in {self.writer.shard_id} shards")
        return done

    def todo(self, dataset, owned: List[int]) -> List[int]:
        """The `owned` clip indices that an interrupted run (resume=True)
        has not stored yet, in order."""
        done = self._restore()
        if done and not hasattr(dataset, "clips"):
            raise RuntimeError("resume needs a dataset exposing .clips metadata")
        todo = [i for i in owned if not done or _clip_key(dataset.clips[i]) not in done]
        if len(todo) < len(owned):
            print(f"{len(owned) - len(todo)} clips already done; {len(todo)} to go")
        self.printer = ThroughputPrinter(len(todo), self.pool, self.writer)
        return todo

    def add_clip(self, ci, box, j3d, j2d_raw, cam, feats) -> None:
        """A clip's rows (:func:`clip_group`) into the shuffle pool."""
        self.pool.add(clip_group(self.cfg, ci, box, j3d, j2d_raw, cam, feats))
        self.printer.clip_done()

    def close(self) -> None:
        """Flush the pool, wait for the writes, commit index.json, then drop
        the progress file. The ordering is load-bearing: unlinking progress
        first would leave a crash window with all shards on disk but
        neither resume state nor an index (the whole extraction would redo
        from scratch)."""
        cfg = self.cfg
        self.pool.finish()
        self.async_writer.wait()  # superseded by the final index.json
        self.async_writer.stop()
        write_index(
            self.root,
            self.pool.clip_index,
            n_shards=self.writer.shard_id,
            n_clips=len(self.pool.clip_index),
            n_variants=self.n_vars,
            aug_names=list(AUG_NAMES[:self.n_vars]),
            seq_len=cfg.seq_len,
            frame_skip=cfg.frame_skip,
            feat_dtype="float16" if cfg.save_fp16 else "float32",
            shuffle_seed=cfg.shuffle_seed,
            shuffle_pool=cfg.shuffle_pool,
        )
        if self.progress_path.exists():
            self.progress_path.unlink()
