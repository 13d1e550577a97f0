"""Feature-extraction pipeline (counterpart of h36x/extract/pipeline.py):
decode -> host crop/resize and pixel variants -> the backbone on the device
(ResNet-50, ViT-H or HRNet-W48: `config.BACKBONES`) -> shuffled feature
shards.

- crop + bilinear resize + the photometric variants run on the decode
  workers (the port's native library); the u8 crops cross to the device
  from pinned memory, and normalize, cast and the backbone run there
  (:func:`make_feature_fn`);
- the temporal-reverse variant's features are the orig features reversed in
  time (per-frame backbone), so a clip costs 3 backbone passes, not 4;
- decode runs in a thread pool overlapped with the device; the features of
  a dispatch stay on the device until the host finalizes it, one dispatch
  later, and then cross on a side stream
  (:class:`h36x_torch.extract.staging.DeviceFeatures`), so the next
  dispatch, already queued, is not waited for;
- the store side, resume included, is :class:`h36x_torch.extract.store.Store`.

:func:`run_extract` is the one run of both schedulers: with `--dedup` (the
default) and a video-structured dataset its loop is the unique-frame
scheduler (h36x_torch/extract/dedup.py), else the per-clip loop here.
"""

from __future__ import annotations

import importlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from h36x_torch.config import BACKBONES, DEFAULT_BACKBONE, ExtractConfig
from h36x_torch.data.augment import make_clip_variants_u8
from h36x_torch.extract import dedup
from h36x_torch.extract.staging import (  # noqa: F401  (the names callers read here)
    DeviceFeatures,
    crop_resize_frames,
    crop_resize_host,
    rows_to_device,
)
from h36x_torch.extract.store import Store
from h36x_torch.models.crops import CropReader
from h36x_torch.ops.preprocess import imagenet_normalize
from h36x_torch.utils.profiling import count, measured, span
from h36x_torch.utils.runtime import local_devices, resolve_device

ENGINES = tuple(dict.fromkeys(e for b in BACKBONES.values() for e in b.engines))


def make_feature_fn(model, mesh=None, engine: str = "flax"):
    """Device step: frames_u8 (N, out, out, 3) uint8 tensor on the model's
    device -> (N, feature width) float32 features on that device, the
    width `config.BACKBONES` gives the model's backbone (its class's
    `backbone_name`; ResNet-50 where it has none). A
    :class:`h36x_torch.models.crops.CropReader` (ViT-H, HRNet-W48)
    normalizes and reads the crops' middle columns itself; the engines a
    backbone runs are the table's.

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
    if engine not in ENGINES:
        raise ValueError(f"--engine must be {'|'.join(ENGINES)}, got {engine!r}")
    if engine not in BACKBONES[getattr(model, "backbone_name", DEFAULT_BACKBONE)].engines:
        raise ValueError(f"the {type(model).__name__} backbone has no --engine {engine!r}")
    if isinstance(model, CropReader):

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
    else:

        def fn(frames_u8):
            with torch.inference_mode():
                video = imagenet_normalize(frames_u8.float() * (1.0 / 255.0))
                return model(video.to(model.dtype))
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


def _load_backbone(cfg: ExtractConfig, device: torch.device):
    """The bfloat16 backbone of `--backbone` on `device`, built by its model
    module (`config.BACKBONES`): from `--weights` in the module's layout,
    or from seeded weights. A backbone that reads its own crops refuses
    any other --resize."""
    spec = BACKBONES[cfg.backbone]
    module = importlib.import_module(f"h36x_torch.models.{spec.module}")
    if spec.sizes:
        crop = getattr(module, spec.sizes)["img_size"][0]
        if cfg.resize != crop:
            raise ValueError(f"--backbone {cfg.backbone} reads {crop}-pixel crops; "
                             f"--resize is {cfg.resize}")
    if not cfg.weights:
        print(f"WARNING: no --weights given; using randomly initialized {spec.label} "
              "(features will not match a pretrained backbone).")
    model = module.backbone(cfg.weights, device)
    if cfg.weights:
        print(f"Loaded {spec.label} weights from {cfg.weights}")
    return model


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
    multi-minute pose-pickle scan of a real H36M tree; run_extract calls
    it first.
    """
    _parse_partition(getattr(cfg, "partition", ""))
    for flag, allowed in (("engine", ENGINES), ("backbone", tuple(BACKBONES)),
                          ("partition_by", ("clip", "video")),
                          ("crop_scope", ("auto", "clip", "video")),
                          ("jitter_key", ("auto", "clip", "video", "frame"))):
        val = getattr(cfg, flag, allowed[0])
        if val not in allowed:
            raise ValueError(
                f"--{flag.replace('_', '-')} must be {'|'.join(allowed)}, "
                f"got {val!r}")
    backbone = getattr(cfg, "backbone", DEFAULT_BACKBONE)
    engine = getattr(cfg, "engine", ENGINES[0])
    if engine not in BACKBONES[backbone].engines:
        owners = " and ".join(b.label for b in BACKBONES.values() if engine in b.engines)
        raise ValueError(f"--engine {engine} is {owners}'s; --backbone {backbone} runs "
                         f"the plain module (--engine {BACKBONES[backbone].engines[0]})")
    if not getattr(cfg, "dedup", True):
        _refuse_unique_frame_modes(cfg)


def _refuse_unique_frame_modes(cfg) -> None:
    """The per-clip scheduler only implements the reference semantics:
    an EXPLICIT flag asking for a dedup-path mode must not silently
    degrade ('auto' resolves to 'clip' on this scheduler)."""
    for flag in ("partition_by", "crop_scope", "jitter_key"):
        val = getattr(cfg, flag, "clip")
        if val not in ("clip", "auto"):
            raise ValueError(
                f"--{flag.replace('_', '-')}={val!r} "
                "needs the unique-frame scheduler (a video-structured "
                "dataset with --dedup); the per-clip scheduler only "
                f"implements {flag}='clip'")


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


def run_extract(cfg: ExtractConfig, dataset=None, device=None) -> dict:
    """Run the extraction stage on `device` (default cuda); returns a
    summary dict. The backbone runs data-parallel over
    :func:`h36x_torch.utils.runtime.local_devices` of `device` (every
    visible card) when there is more than one (:func:`make_feature_fn`).

    Resumable (:class:`h36x_torch.extract.store.Store`): a run restarted
    with resume=True skips the clips an interrupted run stored.

    With cfg.dedup (default) and a video-structured dataset, the clips go
    through the unique-frame scheduler (h36x_torch/extract/dedup.py): the
    same store, sequential per-video decode, overlapping windows computed
    once. The per-clip scheduler remains for --no-dedup and for clip
    sources without sequential/annotation access.

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
    unique = cfg.dedup and all(
        hasattr(dataset, a) for a in ("video_groups", "clip_annotations", "clips"))
    return measured("h36x.extract.call", _run, cfg, dataset, device, unique)


def _run(cfg: ExtractConfig, dataset, device, unique: bool) -> dict:
    # 'auto': the production profile (video/video) on the unique-frame
    # scheduler, the reference semantics (clip/clip) on the per-clip one
    cfg = resolve_extract_modes(cfg, production=unique)
    n_clips = len(dataset)
    part_i, part_n = _parse_partition(cfg.partition)
    if unique:
        groups = dataset.video_groups()
        if cfg.partition_by == "video":
            groups = groups[part_i::part_n]
            owned = [i for g in groups for i in g]
        else:  # clip round-robin: the per-clip scheduler's owned set
            mine = set(range(n_clips)[part_i::part_n])
            owned = [i for g in groups for i in g if i in mine]
        modes = (cfg.crop_scope, cfg.jitter_key)
        profile = ("production" if modes == ("video", "video") else
                   "reference-keyed" if modes == ("clip", "clip") else "mixed")
        how = (f", unique-frame scheduling, {profile} profile: "
               f"crop_scope={cfg.crop_scope} jitter_key={cfg.jitter_key}")
        by = f" by {cfg.partition_by}"
    else:
        _refuse_unique_frame_modes(cfg)
        # round-robin over the GLOBAL clip indices: every job sees the same
        # ordering, so per-clip determinism (the jitter rng keyed on the
        # global index) matches a single-job run
        owned = list(range(n_clips))[part_i::part_n]
        how = by = ""
    part_note = f" [partition {part_i}/{part_n}{by}]" if part_n > 1 else ""

    with Store(cfg, part_n) as store:
        print(f"Extracting {n_clips} clips x {store.n_vars} variant(s) "
              f"(shards of {cfg.shard_size} clips{how}) -> {store.root}{part_note}")
        with span("h36x.extract.load_backbone"):
            model = _load_backbone(cfg, device)
            mesh = feature_mesh(local_devices(device))
            feature_fn = make_feature_fn(model, mesh=mesh, engine=cfg.engine)
        todo = store.todo(dataset, owned)
        t_all = time.perf_counter()
        if unique:
            rows = dedup.run_unique_frames(cfg, dataset, groups, todo, store,
                                           feature_fn, mesh, device)
        else:
            _run_per_clip(cfg, dataset, todo, store, feature_fn, mesh, device)
        with span("h36x.extract.store"):
            store.close()

    total = time.perf_counter() - t_all
    n_todo = len(todo)
    summary = {
        "n_clips": len(store.pool.clip_index),  # clips in the store (all runs)
        "n_processed": n_todo,  # clips this run actually extracted
        "n_vars": store.n_vars,
        "n_shards": store.writer.shard_id,
        "seconds": total,
        "clips_per_sec": n_todo / total if total > 0 else 0.0,
        "frames_per_sec": n_todo * cfg.seq_len / total if total > 0 else 0.0,
    }
    done = (f"Done: {n_todo} clips x {store.n_vars} variants -> {store.writer.shard_id} "
            f"shards in {total:.1f}s ({summary['clips_per_sec']:.1f} clips/s")
    if unique:
        per_clip_rows = n_todo * cfg.seq_len * (3 if cfg.augment else 1)
        summary["backbone_frames"] = rows
        summary["dedup_ratio"] = per_clip_rows / rows if rows else 1.0
        # RESOLVED modes (the 'auto' sentinel never reaches this point):
        # what the store was actually built with
        summary["crop_scope"] = cfg.crop_scope
        summary["jitter_key"] = cfg.jitter_key
        print(f"{done}); backbone frames {rows} vs {per_clip_rows} per-clip "
              f"({summary['dedup_ratio']:.2f}x dedup)")
    else:
        print(f"{done}, {1000 * total / max(n_todo, 1):.1f} ms/clip)")
    summary["device"] = str(device)
    return summary


def _run_per_clip(cfg: ExtractConfig, dataset, todo: List[int], store, feature_fn,
                  mesh, device) -> None:
    """The per-clip loop of one run: every clip in `todo` decoded, cropped
    and varied on the decode workers, `batch_size` clips a dispatch through
    `feature_fn` (over `mesh` when there is one), into `store`."""

    def dispatch_batch(items):
        """Launch the device step for a batch; the features stay on the
        device until :func:`finalize_batch`, one batch later, so the device
        works on batch N+1 while the host post-processes batch N."""
        # items carry (variants_u8 (V,T,o,o,3), j3d, j2d, cam, ci, box);
        # V = 3 pixel variants when augmenting (orig, cjitter, hflip), else 1
        with span("h36x.extract.stage"):
            shape = (len(items),) + items[0][0].shape[:2]  # (B, V, T)
            if not mesh:
                rows = [row for it in items for v in it[0] for row in v]
                frames = rows_to_device(rows, len(rows), device)
            else:
                # over a mesh each device's block goes to it from the host
                frames = np.stack([it[0] for it in items])
                frames = frames.reshape((-1,) + frames.shape[3:])
        with span("h36x.extract.feature_fn"):
            feats = DeviceFeatures(feature_fn(frames))
        return feats, items, shape

    def finalize_batch(inflight):
        with span("h36x.extract.drain"):
            feats_dev, items, shape = inflight
            feats = feats_dev.numpy(store.feat_dtype).reshape(shape + (-1,))
            for b, (_, j3d, j2d_raw, cam, ci, box) in enumerate(items):
                store.add_clip(ci, box, j3d, j2d_raw, cam, feats[b])

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
