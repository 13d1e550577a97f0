"""Extraction cells: whole `extract.pipeline.run_extract` calls, the
unique-frame scheduler, over synthetic videos made from the seed.

Set-up makes a torchvision-layout ResNet-50 state_dict from the seed on
the card and writes it into the run's directory (the job's `--weights`),
draws the videos' frames on the card and holds them on the host
(portbench.synth.SyntheticVideos), and runs one call on the first video,
which warms the dispatch shape, the kernels and the crop library. The
window runs calls over all the videos back to back, each writing a store
of its own, until the window's seconds have passed; the last call runs to
its end. A call holds what a user's job pays: loading the backbone, the
scheduler, the host crops and jitter, the device and the shard writes.

Each call's store stays on disk until the window has closed, so that no
deletion runs inside it. After the window every clip of the last store is
read back (its index, rows and the rows' boxes) and held to the
reference: the frozen crop box, crop-resize, jitter and flip rules
(portbench/rules.py) and the float32 ResNet-50 (portbench/reference/
resnet50.py) on frames made again from the seed. Compared: the widest
relative gap of a stored feature row from the reference's (orig, jitter,
flip, time-reversed), boxes that differ from the reference's, and clips the
index lacks or holds twice.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time

import numpy as np
import torch

from portbench import rules, synth, trace
from portbench.harness import Outcome, Run
from portbench.reference import resnet50 as ref_resnet
from portbench.roofline import batch_sizes, over_batches, resnet50_units

MAGIC = b"H36XSHRD"
ROW_DTYPES = {"float16": np.float16, "float32": np.float32}


def extract_config(run: Run, weights: str):
    """cli.extract's defaults but for the cell's sizes; each call sets `out`."""
    from h36x_torch.config import ExtractConfig

    spec = run.cell.spec
    return ExtractConfig(
        seq_len=spec["seq_len"], frame_skip=spec["frame_skip"],
        stride=spec["stride"], resize=spec["resize"], batch_size=spec["batch_size"],
        num_workers=spec["num_workers"], augment=True, save_fp16=spec["save_fp16"],
        shuffle_seed=synth.sub_seed(run.seed, "shuffle") % 2**31, weights=weights,
        engine=spec["engine"], dedup=True)


def run(run: Run) -> Outcome:
    from h36x_torch.extract.pipeline import run_extract

    spec, dev = run.cell.spec, run.device
    cuda = dev.type == "cuda"
    weights = run.workdir / "resnet50.pt"
    w = ref_resnet.make_weights(synth.generator(run.seed, "resnet50", device=dev), dev)
    torch.save({k: v.cpu() for k, v in w.items()}, weights)
    del w
    phases = {"weights_written": time.perf_counter() - run.t_start}
    videos = synth.SyntheticVideos(run.seed, spec["videos"], spec["frames"], spec["raw"],
                                   spec["seq_len"], spec["stride"], dev)
    phases["videos_made"] = time.perf_counter() - run.t_start
    warm = videos.subset([0])
    cfg = extract_config(run, str(weights))
    run_extract(dataclasses.replace(cfg, out=str(run.workdir / "warm")), warm, dev)
    shutil.rmtree(run.workdir / "warm")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    calls, clips, frames, dedup, tr, traced_frames = 0, 0, 0, None, None, 0
    last = None
    while True:
        out = run.workdir / f"store{calls}"
        call_cfg = dataclasses.replace(cfg, out=str(out))
        if run.trace and tr is None:
            tr = trace.Trace(run.workdir / "trace.json", cuda)
            with tr:
                summary = run_extract(call_cfg, videos, dev)
            traced_frames = summary["backbone_frames"]
        else:
            summary = run_extract(call_cfg, videos, dev)
        calls += 1
        clips += summary["n_processed"]
        frames += summary["backbone_frames"]
        dedup = summary["dedup_ratio"]
        last = out
        if time.perf_counter() - t0 >= run.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    for i in range(calls - 1):
        shutil.rmtree(run.workdir / f"store{i}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if tr is not None:
        tr.finish()
    del videos, warm
    if cuda:
        torch.cuda.empty_cache()

    checks = compare(run, last)
    record = {"window_s": window_s, "dedup_ratio": dedup}
    if tr is not None:
        # the scheduler sends the backbone full dispatches and one short one
        # (its padding is no work); a dispatch reads the weights once
        flops, bound = over_batches(lambda n: resnet50_units(n, spec["resize"]),
                                    batch_sizes(traced_frames, frames_per_dispatch(cfg)))
        record.update(traced_window_s=tr.host_s, traced_flops=flops, traced_bound_s=bound)
    return Outcome(
        setup_s=setup_s, e2e={"extract_clips_per_s": clips / window_s}, record=record,
        attempted=clips, failed=0, checks=checks, memory_peak_bytes=peak,
        trace=tr.summary if tr is not None else None,
        proof={"calls": calls, "clips": clips, "backbone_frames": frames,
               "dedup_ratio": dedup, "B5_launches": _b5(), "setup_phases_s": phases})


def frames_per_dispatch(cfg) -> int:
    """The dedup scheduler's frames a backbone dispatch
    (extract/dedup.py: `--frames-per-dispatch`, else a batch of clips'
    frames in each pixel variant)."""
    return cfg.frames_per_dispatch or cfg.batch_size * cfg.seq_len * (3 if cfg.augment else 1)


def _b5() -> int:
    from h36x_torch.ops.bottleneck import fused_bottleneck

    return fused_bottleneck.launches


def read_shard(path):
    """A shard file's arrays and per-row metadata, by the store's published
    layout (magic, header length, JSON header, arrays at offsets)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != MAGIC:
        raise ValueError(f"{path}: not a shard")
    hlen = int(np.frombuffer(blob[8:12], "<u4")[0])
    header = json.loads(blob[12:12 + hlen])
    arrays = {}
    for name, a in header["arrays"].items():
        dt = np.dtype(ROW_DTYPES.get(a["dtype"], a["dtype"])).newbyteorder("<")
        arrays[name] = np.frombuffer(blob, dt, count=int(np.prod(a["shape"])),
                                     offset=a["offset"]).reshape(a["shape"])
    return arrays, header["meta"]


def reference_video(run: Run, v: int, w: dict) -> dict:
    """The reference's features of every frame of video `v`: orig, jitter
    and flip (each (frames, 2048) float64 on the host), and its box."""
    spec, dev = run.cell.spec, run.device
    frames = synth.video_frames(run.seed, v, spec["frames"], spec["raw"], dev)
    j2d, _ = synth.video_joints(run.seed, v, spec["frames"], spec["raw"])
    box = rules.square_crop(j2d, spec["raw"], spec["raw"])
    crops = rules.crop_resize(frames, box, spec["resize"])
    del frames
    shuffle_seed = synth.sub_seed(run.seed, "shuffle") % 2**31
    params = rules.jitter_params(rules.video_jitter_rng(shuffle_seed, v))
    out = {"box": box}
    for name, pix in (("o", crops), ("c", rules.jitter(crops, params)), ("h", crops.flip(2))):
        with torch.no_grad():
            out[name] = torch.cat([ref_resnet.forward(w, rules.normalize(pix[i:i + BLOCK]))
                                   for i in range(0, len(pix), BLOCK)]).double().cpu()
    return out


BLOCK = 125  # frames a reference call


def variant_rows(ref: dict, start: int, t: int) -> torch.Tensor:
    """A clip's four variant rows (orig, jitter, flip, time-reversed)."""
    o = ref["o"][start:start + t]
    return torch.stack([o, ref["c"][start:start + t], ref["h"][start:start + t], o.flip(0)])


def gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative gap of a feature row from the reference's."""
    return float(((got.double() - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def compare(run: Run, store) -> list:
    """Every clip of the store against the reference: its index entry, its
    four rows' features and boxes."""
    spec, dev = run.cell.spec, run.device
    limits = spec["limits"]
    with open(store / "index.json") as f:
        index = json.load(f)
    expected = {(v + 1, s) for v in range(spec["videos"])
                for s in range(0, spec["frames"] - spec["seq_len"] + 1, spec["stride"])}
    seen = [(int(c["subject"]), int(c["start"])) for c in index["clips"]]
    index_faults = len(expected ^ set(seen)) + len(seen) - len(set(seen))
    shards = {sid: read_shard(store / f"shard_{sid:05d}.h36x")
              for sid in {int(c["shard_id"]) for c in index["clips"]}}
    w = ref_resnet.make_weights(synth.generator(run.seed, "resnet50", device=dev), dev)
    worst, box_faults = 0.0, 0
    for v in range(spec["videos"]):
        ref = reference_video(run, v, w)
        for c in index["clips"]:
            if int(c["subject"]) != v + 1:
                continue
            arrays, meta = shards[int(c["shard_id"])]
            row = int(c["row"])
            got = torch.from_numpy(arrays["feats"][row:row + 4].astype(np.float32))
            box_faults += sum(tuple(meta[row + i]["box"]) != tuple(ref["box"]) for i in range(4))
            worst = max(worst, gap(got, variant_rows(ref, int(c["start"]), spec["seq_len"])))
    return [("feature_gap", worst, limits["feature_gap"]),
            ("box_faults", float(box_faults), 0.0),
            ("index_faults", float(index_faults), 0.0)]
