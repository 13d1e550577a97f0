"""Configuration (counterpart of h36x/config.py).

The clip geometry constants, `ModelConfig`, and the training configs
(`DataConfig`, `OptimConfig`, `MeshConfig`, `DistConfig`, `TrainConfig`)
and the extraction config (`ExtractConfig`) with h36x's field names and
defaults, so the trainer and the extractor take the same
`--optim.batch-size`-style flags (:func:`parse_into`), and the ingest
config (`IngestConfig`). Only the training fields that the trainer reads
are carried over; values that the port does not run yet are refused
(:func:`h36x_torch.train.loop.check_supported`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

FRAME_SKIP = 2  # temporal subsampling applied when decoding video
SEQ_LEN = 40  # frames per clip (after subsampling)
INPUT_LEN = 15  # warm-up frames for future prediction
PRED_LEN = 25  # autoregressive prediction horizon
JOINTS_NUM = 17  # H36M 17-joint skeleton
FEATURE_DIM = 2048  # ResNet-50's pooled feature width (PHD's default input)
LATENT_DIM = 1024  # model latent ("movie strip") width
BATCH_SIZE = 32
LR = 1e-4
EPOCHS = 50
CURRICULUM_STEPS = 25

TRAIN_SUBJECTS = (1, 6, 7, 8)
VAL_SUBJECTS = (5,)
TEST_SUBJECTS = (9,)
ALL_SUBJECTS = (1, 5, 6, 7, 8, 9, 11)


@dataclass(frozen=True)
class Backbone:
    """An extraction backbone (--backbone). Its model module,
    h36x_torch.models.<module>, is imported when a job builds it; the
    module's `backbone(weights, device)` returns the bfloat16 model, from a
    state_dict file in the module's layout or, where `weights` is "",
    seeded. Where `sizes` names the module's dict of published sizes, the
    model reads uint8 square crops of that dict's img_size[0] pixels itself
    (normalization and columns), and --resize has to be that size; without
    it the model takes normalized frames of any size."""

    label: str  # the backbone's name in messages
    feature_dim: int  # the width of the rows it writes
    module: str
    sizes: str = ""
    engines: Tuple[str, ...] = ("flax",)


# extraction's backbones by their --backbone name
BACKBONES = {
    "resnet50": Backbone("ResNet-50", FEATURE_DIM, "resnet", engines=("flax", "opt")),
    "vit_h": Backbone("ViT-H", 1280, "vit", sizes="VIT_H"),
    "hrnet_w48": Backbone("HRNet-W48", 2048, "hrnet", sizes="HRNET_W48"),
}
# the backbone a store records nothing of (stores from before --backbone)
DEFAULT_BACKBONE = "resnet50"
BACKBONE_FEATURE_DIM = {name: b.feature_dim for name, b in BACKBONES.items()}


@dataclass
class DataConfig:
    """Feature-store read configuration for training."""

    seq_len: int = SEQ_LEN
    shard_cache_size: int = -1  # -1: auto (64 for the training set)
    log_shard_loads: int = 0  # >0: print shard-cache counts every N loads
    max_clips: Optional[int] = None  # truncate the train set (smoke runs)
    augment: bool = True  # train on all stored variants
    # dtype the FEATURE arrays cross the host->device link in (float32 |
    # bfloat16 | float16); the model computes in float32 either way
    feed_dtype: str = "float32"


@dataclass
class ModelConfig:
    """PHD model hyper-parameters (same names and defaults as
    h36x.config.ModelConfig)."""

    latent_dim: int = LATENT_DIM
    feature_dim: int = FEATURE_DIM
    joints_num: int = JOINTS_NUM
    num_blocks: int = 2  # f_movie depth
    ar_num_blocks: int = 3  # f_AR depth
    regressor_iters: int = 3
    regressor_hidden: int = 1024
    dropout: float = 0.5
    groups: int = 32
    kernel_size: int = 3
    # compute dtype: 'float32', 'bfloat16' or 'bf16' (mixed precision: bf16
    # matmuls and activations, f32 params/optimizer/GroupNorm statistics)
    dtype: str = "float32"


@dataclass
class OptimConfig:
    lr: float = LR
    weight_decay: float = 1e-2
    epochs: int = EPOCHS
    batch_size: int = BATCH_SIZE
    freeze_ar: bool = True  # phase-1: f_AR frozen
    phase: int = 1  # 1: train f_movie+f_3D; 2: train f_AR (curriculum); 0: all
    # phase 2: the AR window is frames [input_len, input_len + horizon), the
    # horizon growing from 1 to pred_len over curriculum_steps epochs;
    # loss = l_ar + lambda_future * l3d over that window
    input_len: int = INPUT_LEN
    pred_len: int = PRED_LEN
    curriculum_steps: int = CURRICULUM_STEPS
    lambda_future: float = 1.0
    early_stop_patience: int = 10
    early_stop_min_delta: float = 0.0
    # run at most this many epochs this invocation (0 = no bound); the LR
    # and curriculum schedules still target `epochs`, so --resume continues
    # the uninterrupted trajectory
    stop_after_epochs: int = 0
    lambda_2d: float = 0.0  # 2D reprojection loss weight (0 = 3D MSE only)
    seed: int = 0
    log_every: int = 500
    # train the phase-1 step through the hand-written kernels, forward and
    # backward (B1/B2 for every residual block, B3/B4 for the regressor at
    # dropout 0)
    fused: bool = False
    # >1: that many optimizer updates per stacked batch group; on the card
    # each full group is one replay of a CUDA graph of the group's steps
    steps_per_dispatch: int = 1
    # >1: one optimizer update over the mean gradient of that many
    # microbatches (exclusive with steps_per_dispatch)
    grad_accum: int = 1


@dataclass
class MeshConfig:
    """Device layout (h36x's names): `data` and `slices` split the batch,
    `model` is tensor parallelism over processes
    (:mod:`h36x_torch.parallel.tensor`: the plain step, orbax checkpoints).
    One process drives one device, so slices x data x model must equal the
    number of processes (data -1: the number of processes / (slices x
    model)); more devices than processes raise
    (:mod:`h36x_torch.parallel.mesh`)."""

    data: int = -1
    model: int = 1
    slices: int = 1


@dataclass
class DistConfig:
    """Multi-process launch and local devices (h36x's fields): every
    process runs the same CLI with its own process_id and drives its local
    devices (:mod:`h36x_torch.parallel.distributed`); the store lies on
    storage all of them read."""

    coordinator: str = ""  # host:port of process 0 (the rendezvous)
    num_processes: int = 1
    process_id: int = -1  # -1: from the RANK environment variable
    platform: str = ""  # '' | 'cpu' | 'cuda' ('gpu'): the device to run on
    local_devices: int = 0  # >0: virtual CPU devices per process (cpu only)
    collectives: str = ""  # '' (nccl on cuda, gloo on cpu) | 'gloo' | 'nccl'


@dataclass
class TrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    train_root: str = ""
    val_root: str = ""
    outdir: str = "./runs/phase1"
    resume: str = ""
    init_from: str = ""  # warm-start weights from a checkpoint .msgpack
    train_subjects: List[int] = field(default_factory=lambda: list(TRAIN_SUBJECTS))
    val_subjects: List[int] = field(default_factory=lambda: list(VAL_SUBJECTS))
    profile_dir: str = ""  # torch.profiler trace of the first (resumed) epoch
    ckpt_backend: str = "msgpack"


@dataclass
class ExtractConfig:
    """Feature-extraction stage: h36x's fields, names and defaults."""

    root: str = ""
    out: str = ""
    seq_len: int = SEQ_LEN
    frame_skip: int = FRAME_SKIP
    stride: int = 5
    resize: int = 224
    batch_size: int = 32
    num_workers: int = 8
    subjects: List[int] = field(default_factory=lambda: list(ALL_SUBJECTS))
    save_fp16: bool = False
    augment: bool = False
    shard_size: int = 512  # clips per shard file
    shuffle_pool: int = 8192  # clips buffered before a shuffled flush
    # host-RAM budget of that buffer in GiB: flush early once the buffered
    # arrays reach it (moves rows between shards, never changes row bytes);
    # 0 = unbounded
    shuffle_pool_gb: float = 8.0
    shuffle_seed: int = 123
    # 'resnet50' (torchvision's ResNet-50, 2048-D) | 'vit_h' (ViTPose-H /
    # HMR 2.0's ViT-H/16 at 256 x 192, 1280-D) | 'hrnet_w48' (HRNet-W48-C,
    # CLIFF's backbone, at 256 x 192, 2048-D); both read --resize 256 crops
    backbone: str = DEFAULT_BACKBONE
    # the backbone's state_dict (.pt): torchvision's layout for resnet50,
    # ViTPose's (an optional `backbone.` prefix) for vit_h, cls_hrnet.py's
    # (an optional prefix, its classifier left out) for hrnet_w48
    weights: str = ""
    resume: bool = False  # continue an interrupted extraction (progress.json)
    # read the finished store back and recompute every shard's CRC32s
    verify_after: bool = False
    # 'flax': the plain ResNet50 module (cuDNN on the card); 'opt': BN and
    # normalize folded, space-to-depth stem, every stride-1 block one
    # launch of the fused bottleneck kernel
    engine: str = "flax"
    partition: str = ""  # "i/N": extract only clips i::N of the index
    partition_by: str = "clip"  # 'clip' (round-robin clips) | 'video'
    dedup: bool = True  # unique-frame scheduling (h36x_torch/extract/dedup.py)
    # 'auto' = 'video' on the unique-frame scheduler (the production
    # profile) and 'clip' on the per-clip one; 'clip' = the reference's
    # per-clip box
    crop_scope: str = "auto"
    # color-jitter rng keying: 'auto' ('video' on the unique-frame
    # scheduler, 'clip' on the per-clip one) | 'clip' | 'video' | 'frame'
    jitter_key: str = "auto"
    # device batch rows of the unique-frame scheduler; 0 = the rows
    # batch_size clips add in steady state (batch_size * stride * 3 under
    # video/frame jitter, batch_size * (seq_len + 2 * stride) under clip
    # jitter, batch_size * stride without augment); the last goes at its size
    frames_per_dispatch: int = 0


@dataclass
class IngestConfig:
    """Raw-H36M ingest (h36x's fields and defaults)."""

    source_dir: str = ""
    out_dir: str = ""
    subjects: List[int] = field(default_factory=lambda: list(ALL_SUBJECTS))


# ---------------------------------------------------------------------------
# CLI plumbing: every dataclass field becomes a --dotted.path flag.
# ---------------------------------------------------------------------------


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def add_fields(parser: argparse.ArgumentParser, cfg, prefix: str = "") -> None:
    """Register a --dotted.path flag (default None) for every field of the
    dataclass `cfg`, nested dataclasses included."""
    for f in dataclasses.fields(cfg):
        name = f"{prefix}{f.name}"
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            add_fields(parser, value, prefix=f"{name}.")
            continue
        flag = "--" + name.replace("_", "-")
        if isinstance(value, bool):
            parser.add_argument(flag, type=_parse_bool, default=None)
        elif isinstance(value, list):
            hints = typing.get_type_hints(type(cfg))
            args = typing.get_args(hints.get(f.name, None))
            elem = args[0] if args and args[0] in (int, float, str) else int
            parser.add_argument(flag, type=elem, nargs="*", default=None)
        elif value is None:
            parser.add_argument(flag, type=int, default=None)
        else:
            parser.add_argument(flag, type=type(value), default=None)


def _apply(cfg, dotted: str, value) -> None:
    head, _, rest = dotted.partition(".")
    if rest:
        _apply(getattr(cfg, head), rest, value)
    else:
        setattr(cfg, head, value)


def _detach(dc) -> None:
    """Copy nested dataclasses and lists in place, so edits to a parsed
    config never reach the template it was copied from."""
    for f in dataclasses.fields(dc):
        v = getattr(dc, f.name)
        if dataclasses.is_dataclass(v):
            setattr(dc, f.name, dataclasses.replace(v))
            _detach(getattr(dc, f.name))
        elif isinstance(v, list):
            setattr(dc, f.name, list(v))


def apply_namespace(cfg, ns: argparse.Namespace, skip=()):
    """A copy of `cfg` with every flag of `ns` that was given (not None),
    the names in `skip` aside."""
    out = dataclasses.replace(cfg)
    _detach(out)
    for key, value in vars(ns).items():
        if value is None or key in skip:
            continue
        _apply(out, key.replace("-", "_"), value)
    return out


def parse_into(cfg, argv: Optional[Sequence[str]] = None, description: str = ""):
    """Parse CLI arguments into (a copy of) the given config dataclass."""
    parser = argparse.ArgumentParser(description=description)
    add_fields(parser, cfg)
    return apply_namespace(cfg, parser.parse_args(argv))


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)
