"""Feature-extraction pipeline (counterpart of h36x/extract/pipeline.py):
decode -> host crop/resize and pixel variants -> the backbone on the device
(ResNet-50, or ViT-H with `--backbone vit_h`) -> shuffled feature shards.

- crop + bilinear resize + the photometric variants run on the decode
  workers (the port's native library); the u8 crops cross to the device
  from pinned memory, and normalize, cast and the backbone run there
  (:func:`make_feature_fn`);
- the temporal-reverse variant's features are the orig features reversed in
  time (per-frame backbone), so a clip costs 3 backbone passes, not 4;
- decode runs in a thread pool overlapped with the device; the features of
  a dispatch stay on the device until the host finalizes it, one dispatch
  later, and then cross on a side stream (:class:`DeviceFeatures`), so the
  next dispatch, already queued, is not waited for;
- shards go through :class:`h36x_torch.data.shards.ShardWriter` behind an
  :class:`h36x_torch.extract.writer.AsyncWriter` thread.

The store is h36x's format, byte for byte: clips shuffle across shards in
a seeded pool with a clip's variant rows contiguous. With `--dedup` (the
default) and a video-structured dataset, :func:`run_extract` hands over to
the unique-frame scheduler (h36x_torch/extract/dedup.py).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import numpy as np
import torch

from h36x_torch.config import BACKBONE_FEATURE_DIM, ExtractConfig
from h36x_torch.data.augment import (
    AUG_NAMES,
    hflip_joints,
    make_clip_variants_u8,
    reverse_joints,
)
from h36x_torch.data.shards import ShardWriter, write_index
from h36x_torch.extract.writer import AsyncWriter
from h36x_torch.geometry.camera import adjust_camera_after_crop_and_resize
from h36x_torch.geometry.crop import (
    adjust_joints2d_after_crop_and_resize,
    compute_square_crop_from_2d,
)
from h36x_torch.models.resnet import ResNet50, load_torchvision_file
from h36x_torch.ops.preprocess import imagenet_normalize
from h36x_torch.utils.profiling import count, measured, span
from h36x_torch.utils.runtime import local_devices, resolve_device

ENGINES = ("flax", "opt")


def make_feature_fn(model, mesh=None, engine: str = "flax"):
    """Device step: frames_u8 (N, out, out, 3) uint8 tensor on the model's
    device -> (N, feature width) float32 features on that device: 2048 for
    a ResNet50, the model's `dim` (1280) for a
    :class:`h36x_torch.models.vit.ViT`, which normalizes and reads the
    crops' middle columns itself and has the one engine, 'flax'.

    For ResNet-50, engine='flax' is the plain module (normalize in
    float32, cast to the module dtype; cuDNN on the card). engine='opt' is
    the folded engine of :mod:`h36x_torch.ops.resnet_opt` (BN and normalize
    folded into the conv weights, space-to-depth stem), whose 13 stride-1
    blocks each launch the fused bottleneck kernel B5 on the card; the fold
    runs once per weight set, at the first call. Same function, a
    bf16-level numeric difference.

    With a `mesh` (h36x's data-parallel backbone): the step takes frames
    as a host array or a tensor, pads them with zero frames to a multiple
    of the data axis (this process's local devices), sends each block to
    its device, runs the backbone there (the module, or for `opt` the
    folded weights, placed on each device once by
    :class:`h36x_torch.parallel.local.Replicas`: a device the model lives
    on uses the model itself) and returns the features in order, `[:N]`,
    on the frames' device (host frames: the first device's).
    """
    from h36x_torch.models.vit import ViT

    if isinstance(model, ViT):
        if engine != "flax":
            raise ValueError(f"the ViT backbone has no --engine {engine!r}")

        def fn(frames_u8):
            with torch.inference_mode():
                return model(frames_u8)
    elif engine == "opt":
        from h36x_torch.ops.resnet_opt import (
            fold_resnet50_opt,
            prepare_opt,
            resnet50_opt_forward,
        )

        box = {}

        def fn(frames_u8):
            if "folded" not in box:  # fold once per weight set
                folded, stem2 = fold_resnet50_opt(model.float32_state(),
                                                  hw=int(frames_u8.shape[1]))
                box["folded"], box["stem2"] = prepare_opt(
                    folded, stem2, model.dtype, frames_u8.device)
            with torch.inference_mode():
                return resnet50_opt_forward(frames_u8, box["folded"], box["stem2"],
                                            dtype=model.dtype)
    elif engine == "flax":

        def fn(frames_u8):
            with torch.inference_mode():
                video = imagenet_normalize(frames_u8.float() * (1.0 / 255.0))
                return model(video.to(model.dtype))
    else:
        raise ValueError(f"--engine must be {'|'.join(ENGINES)}, got {engine!r}")
    if mesh is None:
        return fn
    from h36x_torch.parallel.local import Replicas, on_replicas

    replicas = Replicas(model, mesh.local_groups(), grads=False)
    steps = {id(m): fn if m is model else make_feature_fn(m, engine=engine)
             for m in replicas.models}
    return lambda frames_u8: on_replicas(replicas, lambda m, x: steps[id(m)](x), frames_u8)


def feature_mesh(devices):
    """h36x's extraction mesh: a data axis over `devices` when there is
    more than one (None otherwise), said on stdout."""
    if len(devices) <= 1:
        return None
    from h36x_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=-1, model=1, devices=devices)
    print(f"Extraction over {mesh.shape['data']} devices (data-parallel backbone)")
    return mesh


def frames_to_device(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """u8 frames to the device: through pinned memory and an asynchronous
    copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(frames))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def rows_to_device(rows, n_rows: int, device: torch.device) -> torch.Tensor:
    """u8 rows of one shape, zero rows after them up to `n_rows`, as one
    tensor on the device: each row copied once into a pinned buffer, which
    the host allocator hands out again once the card has read it, then one
    asynchronous copy. (Stacking, padding and pinning a stacked array
    would move every byte three times, twice into freshly mapped pages.)"""
    shape = np.shape(rows[0])
    buf = torch.empty((n_rows,) + shape, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    for i, row in enumerate(rows):
        host[i] = row
    host[len(rows):] = 0
    return buf.to(device, non_blocking=True)


_copy_streams: dict = {}


class DeviceFeatures:
    """One dispatch's features, left on the device until :meth:`numpy`.

    On the card an event marks the end of the dispatch's work on the
    compute stream; :meth:`numpy` copies on a side stream that waits only
    for that event, so a dispatch queued after this one is not waited for."""

    def __init__(self, feats: torch.Tensor):
        self.feats = feats
        self.event = None
        if feats.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self, np_dtype) -> np.ndarray:
        if self.event is None:
            return np.asarray(self.feats.numpy(), dtype=np_dtype)
        dev = self.feats.device
        stream = _copy_streams.get(dev)
        if stream is None:
            stream = _copy_streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            stream.wait_event(self.event)
            host = self.feats.to("cpu")  # synchronizes this stream only
        return np.asarray(host.numpy(), dtype=np_dtype)


class ShufflePool:
    """Clip-level shuffle pool flushing fixed-size shards.

    Accumulates groups (one clip = n_vars variant rows), shuffles at the
    clip level once the pool is full, writes full shards, carries the
    remainder into the next flush (the final partial shard included).
    """

    def __init__(self, writer: ShardWriter, n_vars: int, shard_size: int,
                 pool_size: int, seed: int, on_flush=None,
                 max_bytes: int = 0):
        import random

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
        # backbone's width in f32 (2048 for ResNet-50; 1280 for ViT-H).
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




def crop_resize_frames(frames: np.ndarray, box, out_size: int) -> np.ndarray:
    """Crop (T, H, W, 3) u8 frames to `box` and bilinear-resize to out_size.

    The port's native library when it is built, else cv2; both sample with
    half-pixel centres (torchvision's resize(antialias=False)). Per-frame
    independent: cropping a subset of frames gives the same rows as
    cropping the whole clip (the dedup scheduler's crop cache relies on it).
    """
    from h36x_torch import native

    t_len = frames.shape[0]
    top, left, hh, _ww = (int(v) for v in np.asarray(box).reshape(4))
    if native.available():
        return native.crop_resize_clip(frames, top, left, hh, out_size)

    import cv2

    crop = frames[:, top : top + hh, left : left + hh]
    out = np.empty((t_len, out_size, out_size, 3), np.uint8)
    for t in range(t_len):
        out[t] = cv2.resize(crop[t], (out_size, out_size), interpolation=cv2.INTER_LINEAR)
    return out


def crop_resize_host(frames: np.ndarray, joints2d: np.ndarray, out_size: int,
                     crop_scale: float = 1.6):
    """Square person crop + bilinear resize on the host (decode worker):
    frames (T, H, W, 3) u8 -> ((T, out, out, 3) u8, box)."""
    _t_len, img_h, img_w, _ = frames.shape
    box = compute_square_crop_from_2d(joints2d, img_h, img_w, scale=crop_scale)
    return crop_resize_frames(frames, box, out_size), box


def _load_backbone(cfg: ExtractConfig, device: torch.device):
    """The bfloat16 backbone of `--backbone` on `device`: `--weights` or
    random weights from seed 0. ResNet-50 from a torchvision state_dict;
    ViT-H (:mod:`h36x_torch.models.vit`, its published widths) built on
    `meta` and materialized by a ViTPose-layout state_dict's load."""
    if cfg.backbone == "vit_h":
        from h36x_torch.models import vit

        if cfg.resize != vit.VIT_H["img_size"][0]:
            raise ValueError(f"--backbone vit_h reads {vit.VIT_H['img_size'][0]}-pixel "
                             f"crops; --resize is {cfg.resize}")
        if not cfg.weights:
            print("WARNING: no --weights given; using randomly initialized ViT-H "
                  "(features will not match a pretrained backbone).")
            return vit.random_vit(device, **vit.VIT_H)
        model = vit.load_vitpose_file(vit.ViT(**vit.VIT_H), cfg.weights, device)
        print(f"Loaded ViT-H weights from {cfg.weights}")
        return model
    model = ResNet50(dtype=torch.bfloat16, device=device)
    if cfg.weights:
        load_torchvision_file(model, cfg.weights)
        print(f"Loaded ResNet-50 weights from {cfg.weights}")
    else:
        print("WARNING: no --weights given; using randomly initialized ResNet-50 "
              "(features will not match a pretrained backbone).")
    return model


def store_provenance() -> dict:
    """Which host backend wrote the pixels: the native library and the
    cv2 / numpy fallbacks differ by +-1 u8 on some pixels, so a resume where
    it changed is refused."""
    from h36x_torch import native

    return {"crop_backend": "native" if native.available() else "cv2",
            "jitter_backend": "native" if native.jitter_available() else "numpy"}


def backbone_provenance(cfg) -> dict:
    """The backbone a store's rows came from, for the resume check: nothing
    for ResNet-50, so that its progress files stay as they were."""
    backbone = getattr(cfg, "backbone", "resnet50")
    return {} if backbone == "resnet50" else {"backbone": backbone}


def _clip_key(entry) -> tuple:
    """Resume identity of a clip; accepts progress-index dicts and
    ClipIndex objects so the done-set and the todo-filter can never drift."""
    if isinstance(entry, dict):
        return (int(entry["subject"]), str(entry["action"]),
                str(entry["cam"]), int(entry["start"]))
    return (int(entry.subject), str(entry.action), str(entry.cam),
            int(entry.start))


def _parse_partition(spec: str):
    """'i/N' -> (i, N); '' -> (0, 1). Round-robin clip assignment keeps
    subjects/actions evenly spread across partition jobs."""
    if not spec:
        return 0, 1
    try:
        i_s, n_s = spec.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"--partition must look like 'i/N', got {spec!r}")
    if not (0 <= i < n):
        raise ValueError(f"partition index {i} out of range for /{n}")
    return i, n


def validate_extract_config(cfg) -> None:
    """Config-only validation, callable BEFORE the dataset tree scan.

    The mode-flag values decide which scheduler is legal and which store
    bytes get written; a typo must fail in milliseconds, not after the
    multi-minute pose-pickle scan of a real H36M tree. run_extract and
    run_extract_dedup both call this first.
    """
    _parse_partition(getattr(cfg, "partition", ""))
    for flag, allowed in (("engine", ENGINES), ("backbone", tuple(BACKBONE_FEATURE_DIM)),
                          ("partition_by", ("clip", "video")),
                          ("crop_scope", ("auto", "clip", "video")),
                          ("jitter_key", ("auto", "clip", "video", "frame"))):
        val = getattr(cfg, flag, allowed[0])
        if val not in allowed:
            raise ValueError(
                f"--{flag.replace('_', '-')} must be {'|'.join(allowed)}, "
                f"got {val!r}")
    if getattr(cfg, "backbone", "resnet50") != "resnet50" and \
            getattr(cfg, "engine", "flax") != "flax":
        raise ValueError(f"--engine {cfg.engine} is ResNet-50's; --backbone "
                         f"{cfg.backbone} runs the plain module (--engine flax)")
    if not getattr(cfg, "dedup", True):
        # the per-clip scheduler only implements the reference semantics —
        # an EXPLICIT flag asking for a dedup-path mode must not silently
        # degrade ('auto' resolves to 'clip' on this scheduler)
        for flag, default in (("partition_by", "clip"),
                              ("crop_scope", "clip"), ("jitter_key", "clip")):
            val = getattr(cfg, flag, default)
            if val not in (default, "auto"):
                raise ValueError(
                    f"--{flag.replace('_', '-')}={val!r} "
                    "needs the unique-frame scheduler (a video-structured "
                    "dataset with --dedup); the per-clip scheduler only "
                    f"implements {flag}={default!r}")


def resolve_extract_modes(cfg, production: bool):
    """Resolve the 'auto' mode sentinels against the chosen scheduler.

    'auto' means the PRODUCTION profile (crop_scope='video',
    jitter_key='video': full dedup) on the unique-frame scheduler, and the
    strict reference semantics ('clip'/'clip') on the per-clip scheduler,
    which implements nothing else. Returns a new config; explicit values
    pass through untouched, so `--crop-scope clip --jitter-key clip` is
    byte-level reference store semantics on either scheduler.
    """
    import dataclasses

    repl = {}
    target = "video" if production else "clip"
    if getattr(cfg, "crop_scope", "clip") == "auto":
        repl["crop_scope"] = target
    if getattr(cfg, "jitter_key", "clip") == "auto":
        repl["jitter_key"] = target
    return dataclasses.replace(cfg, **repl) if repl else cfg


def make_progress_writer(progress_path, run_config, async_writer):
    """Progress-file writer shared by BOTH schedulers (cross-scheduler
    resume depends on the two writing identical state).

    Atomic tmp+rename (a crash mid-write must never corrupt the file resume
    depends on), submitted through the same FIFO as the shard writes so
    progress never claims unwritten shards.
    """
    import json as _json

    def _atomic_write(text):
        tmp = Path(str(progress_path) + ".tmp")
        tmp.write_text(text)
        tmp.replace(progress_path)

    def write_progress(pool):
        payload = _json.dumps(
            {"clips": pool.clip_index, "n_shards": pool.writer.shard_id,
             "config": run_config}
        )
        async_writer.submit(_atomic_write, payload)

    return write_progress


def restore_resume_state(cfg, progress_path, run_config, pool,
                         shard_writer) -> set:
    """Restore an interrupted run's pool/shard state; returns done clip keys.

    One implementation for both schedulers: the provenance-backfill and
    mismatch rules decide whether resuming would mix incompatible rows into
    one store, and a rule applied to only one copy would silently break
    resuming a pipeline-written store under the dedup scheduler (or vice
    versa) — exactly the corruption class these guards exist to prevent.
    """
    import json as _json

    done_keys: set = set()
    if not (getattr(cfg, "resume", False) and progress_path.exists()):
        return done_keys
    prog = _json.loads(progress_path.read_text())
    prev = prog.get("config")
    if prev is not None:
        # pre-upgrade progress files predate some provenance keys; a
        # missing key means "unknown", not "different" — refusing would
        # strand a near-done extraction behind an unfixable mismatch
        for k in ("crop_backend", "jitter_backend", "partition_by"):
            if k in run_config and k not in prev:
                print(f"WARNING: the interrupted run predates the {k!r} "
                      f"provenance record — cannot verify it matched "
                      f"{run_config[k]!r}; resuming anyway")
                prev[k] = run_config[k]
    if prev is not None and prev != run_config:
        diffs = {k: (prev.get(k), run_config[k]) for k in run_config
                 if prev.get(k) != run_config[k]}
        # keys only the interrupted run recorded (e.g. a dedup-scheduler
        # deviation flag) must show up too, not print an empty dict
        diffs.update({k: (prev[k], None) for k in prev
                      if k not in run_config})
        raise ValueError(
            f"resume config mismatch vs the interrupted run: {diffs} — "
            "resuming would mix incompatible rows into one store; rerun "
            "with the original flags or start a fresh --out")
    pool.clip_index = prog["clips"]
    shard_writer.shard_id = int(prog["n_shards"])
    done_keys = {_clip_key(c) for c in prog["clips"]}
    print(f"Resuming: {len(done_keys)} clips already in "
          f"{shard_writer.shard_id} shards")
    return done_keys


class ThroughputPrinter:
    """clips/s + ETA every 200 clips, final-shard/pool state included;
    shared by both schedulers so the progress line cannot drift."""

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


def finalize_store(out_root, cfg, pool, shard_writer, n_vars, aug_names,
                   progress_path) -> None:
    """Commit index.json, then drop the progress file (both schedulers).

    The ordering is load-bearing: unlinking progress first would leave a
    crash window with all shards on disk but neither resume state nor an
    index (the whole extraction would redo from scratch).
    """
    write_index(
        out_root,
        pool.clip_index,
        n_shards=shard_writer.shard_id,
        n_clips=len(pool.clip_index),
        n_variants=n_vars,
        aug_names=aug_names,
        seq_len=cfg.seq_len,
        frame_skip=cfg.frame_skip,
        feat_dtype="float16" if cfg.save_fp16 else "float32",
        shuffle_seed=cfg.shuffle_seed,
        shuffle_pool=cfg.shuffle_pool,
    )
    if progress_path.exists():
        progress_path.unlink()


def run_extract(cfg: ExtractConfig, dataset=None, device=None) -> dict:
    """Run the extraction stage on `device` (default cuda); returns a
    summary dict. The backbone runs data-parallel over
    :func:`h36x_torch.utils.runtime.local_devices` of `device` (every
    visible card) when there is more than one (:func:`make_feature_fn`).

    Resumable: after every shard flush a progress file records which clips
    landed in which shard rows; a run restarted with resume=True skips
    those clips, re-processes the ones still buffered in the shuffle pool,
    and appends new shards.

    With cfg.dedup (default) and a video-structured dataset, work routes to
    the unique-frame scheduler (h36x_torch/extract/dedup.py): the same
    store, sequential per-video decode, overlapping windows computed once.
    This per-clip scheduler remains for --no-dedup and for clip sources
    without sequential/annotation access.

    The summary's `host_s` ({span: (seconds, calls)}) and `counts` are what
    the call added to `utils.profiling`'s table: the host time of its
    stages, worker threads' included.
    """
    validate_extract_config(cfg)  # fail on flag typos BEFORE the tree scan
    device = resolve_device(device)
    if dataset is None:
        from h36x_torch.data.clips import ClipDataset

        dataset = ClipDataset(
            cfg.root, cfg.subjects, seq_len=cfg.seq_len, stride=cfg.stride,
            frame_skip=cfg.frame_skip,
        )
    if cfg.dedup and all(
        hasattr(dataset, a) for a in ("video_groups", "clip_annotations", "clips")
    ):
        from h36x_torch.extract.dedup import run_extract_dedup

        return run_extract_dedup(resolve_extract_modes(cfg, production=True),
                                 dataset, device)
    return measured("h36x.extract.call", _run_per_clip, cfg, dataset, device)


def _run_per_clip(cfg: ExtractConfig, dataset, device) -> dict:
    cfg = resolve_extract_modes(cfg, production=False)  # auto -> 'clip'
    # this scheduler only implements the default semantics: a flag asking
    # for a dedup-path mode must not silently degrade to them
    for flag, default in (("partition_by", "clip"), ("crop_scope", "clip"),
                          ("jitter_key", "clip")):
        if getattr(cfg, flag) != default:
            raise ValueError(
                f"--{flag.replace('_', '-')}={getattr(cfg, flag)!r} needs the "
                "unique-frame scheduler (a video-structured dataset with "
                "--dedup); the per-clip scheduler only implements "
                f"{flag}={default!r}")

    out_root = Path(cfg.out)
    out_root.mkdir(parents=True, exist_ok=True)
    n_vars = len(AUG_NAMES) if cfg.augment else 1
    aug_names = list(AUG_NAMES) if cfg.augment else ["orig"]
    feat_np_dtype = np.float16 if cfg.save_fp16 else np.float32
    progress_path = out_root / "progress.json"

    n_clips = len(dataset)
    part_i, part_n = _parse_partition(cfg.partition)
    part_note = f" [partition {part_i}/{part_n}]" if part_n > 1 else ""
    print(
        f"Extracting {n_clips} clips x {n_vars} variant(s) "
        f"(shards of {cfg.shard_size} clips) -> {out_root}{part_note}"
    )

    with span("h36x.extract.load_backbone"):
        model = _load_backbone(cfg, device)
        mesh = feature_mesh(local_devices(device))
        feature_fn = make_feature_fn(model, mesh=mesh, engine=cfg.engine)

    async_writer = AsyncWriter()
    shard_writer = ShardWriter(out_root, n_vars, async_writer=async_writer)

    # the store-shaping knobs: resuming with any of them changed would mix
    # incompatible rows into one store, so they are recorded per flush and
    # checked on resume
    provenance = store_provenance()
    run_config = {
        "n_vars": n_vars, "seq_len": cfg.seq_len, "resize": cfg.resize,
        "frame_skip": cfg.frame_skip, "save_fp16": bool(cfg.save_fp16),
        "shuffle_seed": cfg.shuffle_seed,
        "partition": cfg.partition,
        "crop_backend": provenance["crop_backend"],
    }
    if part_n > 1:
        # recorded so a partitioned store can resume under the dedup
        # scheduler's partition_by='clip' (the same owned set)
        run_config["partition_by"] = "clip"
    if n_vars > 1:
        run_config["jitter_backend"] = provenance["jitter_backend"]
    run_config.update(backbone_provenance(cfg))

    write_progress = make_progress_writer(progress_path, run_config,
                                          async_writer)
    pool = ShufflePool(
        shard_writer, n_vars, cfg.shard_size, cfg.shuffle_pool, cfg.shuffle_seed,
        on_flush=write_progress,
        max_bytes=int(cfg.shuffle_pool_gb * 2**30),
    )
    done_keys = restore_resume_state(cfg, progress_path, run_config, pool,
                                     shard_writer)

    t_all = time.perf_counter()

    def dispatch_batch(items):
        """Launch the device step for a batch; the features stay on the
        device until :func:`finalize_batch`, one batch later, so the device
        works on batch N+1 while the host post-processes batch N."""
        # items carry (variants_u8 (V,T,o,o,3), j3d, j2d, cam, ci, box);
        # V = 3 pixel variants when augmenting (orig, cjitter, hflip), else 1
        with span("h36x.extract.stage"):
            frames = np.stack([it[0] for it in items])  # (B,V,T,o,o,3) u8
            shape = frames.shape[:3]
            flat = frames.reshape((-1,) + frames.shape[3:])
            # over a mesh each device's block goes to it from the host
            if not mesh:
                flat = frames_to_device(flat, device)
        with span("h36x.extract.feature_fn"):
            feats = DeviceFeatures(feature_fn(flat))
        return feats, items, shape

    def finalize_batch(inflight):
        with span("h36x.extract.drain"):
            feats_dev, items, (B, V, T) = inflight
            feats = feats_dev.numpy(feat_np_dtype).reshape(B, V, T, -1)
            if cfg.augment:
                f_orig, f_cj, f_hf = feats[:, 0], feats[:, 1], feats[:, 2]
                f_trev = f_orig[:, ::-1].copy()
            else:
                f_orig = feats[:, 0]

            for b, (fr, j3d, j2d_raw, cam, ci, box) in enumerate(items):
                j2d = adjust_joints2d_after_crop_and_resize(j2d_raw, box, cfg.resize)
                K = adjust_camera_after_crop_and_resize(cam["f"], cam["c"], box, cfg.resize)
                base_meta = {
                    "subject": int(ci.subject),
                    "action": ci.action,
                    "cam": ci.cam,
                    "start": int(ci.start),
                    "end": int(ci.end),
                    "frame_skip": int(cfg.frame_skip),
                    "box": [int(v) for v in box],
                }
                if cfg.augment:
                    j3d_hf, j2d_hf, K_hf = hflip_joints(j3d, j2d, K, width=cfg.resize)
                    j3d_tr, j2d_tr = reverse_joints(j3d, j2d)
                    rows = (
                        (f_orig[b], j3d, j2d, K),
                        (f_cj[b], j3d, j2d, K),
                        (f_hf[b], j3d_hf, j2d_hf, K_hf),
                        (f_trev[b], j3d_tr, j2d_tr, K),
                    )
                else:
                    rows = ((f_orig[b], j3d, j2d, K),)
                group = [
                    {
                        "feat": feat,
                        "joints3d": np.asarray(jj3, np.float32),
                        "joints2d": np.asarray(jj2, np.float32),
                        "K": np.asarray(kk, np.float32),
                        "meta": dict(base_meta, aug=aug_names[v]),
                    }
                    for v, (feat, jj3, jj2, kk) in enumerate(rows)
                ]
                pool.add(group)
                printer.clip_done()

    def load_item(i):
        """Decode worker: decode + crop + resize + pixel variants (host)."""
        with span("h36x.extract.job"):
            frames, j3d, j2d, cam, ci = dataset[i]
            with span("h36x.extract.crop"):
                small, box = crop_resize_host(frames, j2d, cfg.resize)
            count("h36x.extract.frames_cropped", len(small))
            if cfg.augment:
                rng = np.random.default_rng(cfg.shuffle_seed * 1_000_003 + i)
                with span("h36x.extract.jitter"):  # the flip and stack too
                    variants = make_clip_variants_u8(small, rng)  # (3,T,o,o,3)
                count("h36x.extract.frames_jittered", len(small))
            else:
                variants = small[None]  # (1,T,o,o,3)
        return variants, j3d, j2d, cam, ci, box

    if done_keys and not hasattr(dataset, "clips"):
        raise RuntimeError("resume needs a dataset exposing .clips metadata")
    # round-robin partition over the GLOBAL clip indices: every job sees the
    # same ordering, so per-clip determinism (the jitter rng keyed on the
    # global index) matches a single-job run
    owned = list(range(n_clips))[part_i::part_n]
    todo = [
        i for i in owned
        if not done_keys or _clip_key(dataset.clips[i]) not in done_keys
    ]
    if len(todo) < len(owned):
        print(f"{len(owned) - len(todo)} clips already done; {len(todo)} to go")
    n_todo = len(todo)
    printer = ThroughputPrinter(n_todo, pool, shard_writer)

    # decode in a thread pool; crops have static shapes, so batches are
    # fixed-size windows overlapped with device compute
    with ThreadPoolExecutor(max_workers=max(1, cfg.num_workers)) as ex:
        pending: List = []
        inflight = None  # one device batch in flight
        window = cfg.num_workers * 2 + cfg.batch_size
        futures = [ex.submit(load_item, i) for i in todo[:window]]
        next_submit = len(futures)
        for pos in range(len(todo)):
            with span("h36x.extract.wait_jobs"):
                item = futures[pos].result()
            futures[pos] = None  # free memory
            if next_submit < len(todo):
                futures.append(ex.submit(load_item, todo[next_submit]))
                next_submit += 1
            pending.append(item)
            if len(pending) == cfg.batch_size:
                new = dispatch_batch(pending)
                pending = []
                if inflight is not None:
                    finalize_batch(inflight)
                inflight = new
        if pending:
            new = dispatch_batch(pending)
            if inflight is not None:
                finalize_batch(inflight)
            inflight = new
        if inflight is not None:
            finalize_batch(inflight)

    with span("h36x.extract.store"):
        pool.finish()
        async_writer.wait()  # superseded by the final index.json
        async_writer.stop()
        finalize_store(out_root, cfg, pool, shard_writer, n_vars, aug_names,
                       progress_path)

    total = time.perf_counter() - t_all
    summary = {
        "n_clips": len(pool.clip_index),  # clips in the store (all runs)
        "n_processed": n_todo,  # clips this run actually extracted
        "n_vars": n_vars,
        "n_shards": shard_writer.shard_id,
        "seconds": total,
        "clips_per_sec": n_todo / total if total > 0 else 0.0,
        "frames_per_sec": n_todo * cfg.seq_len / total if total > 0 else 0.0,
        "device": str(device),
    }
    print(
        f"Done: {n_todo} clips x {n_vars} variants -> {shard_writer.shard_id} shards "
        f"in {total:.1f}s ({summary['clips_per_sec']:.1f} clips/s, "
        f"{1000*total/max(n_todo,1):.1f} ms/clip)"
    )
    return summary
