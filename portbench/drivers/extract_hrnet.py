"""Extraction cells whose backbone is HRNet-W48-C (`--backbone hrnet_w48`):
whole `extract.pipeline.run_extract` calls, the unique-frame scheduler,
over synthetic videos made from the seed, as drivers/extract_vit.py runs
ViT-H.

Set-up first asks the program whether it knows the backbone (its
`config.BACKBONE_FEATURE_DIM`): a program without it fails there, before
any weights are drawn. Then it draws HRNet-W48's weights from the seed on
the card (portbench/reference/hrnet_w48.py) and writes them, float32 in
`cls_hrnet.py`'s layout, into the run's directory (the job's `--weights`);
draws the videos' frames (portbench.synth.SyntheticVideos); and runs one
call over all the videos, as the window's calls run, which warms every
shape and host buffer they use. The window runs calls back to back until
its seconds have passed; each call loads the backbone from the file, as a
user's job does. The traced call's device time is also read by the
program's `h36x.hrnet.*` spans (portbench/span_trace.py), and its units
are counted over the dispatches the program sent
(`h36x.extract.dispatches`).

After the window every clip of the last store is held to the reference:
the frozen crop box, crop-resize, jitter and flip rules (portbench/rules.py)
and the float32 HRNet-W48 on frames made again from the seed, computed in
blocks. Compared: the widest relative gap of a stored feature row from the
reference's (orig, jitter, flip, time-reversed), boxes that differ from the
reference's, and clips the index lacks or holds twice.

The control of the limit:

    python3 portbench/drivers/extract_hrnet.py --seeds S1 S2 ... \
        [--control-seeds C1 ...] [--seconds 0] [--out FILE]

prints the checks of a short run for each seed (set-up and one call), and
for each control seed those of the cell's whole run with the reference
with fp8 e4m3 operands in the program's place, which has to come out not
correct.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, rules, span_trace, synth  # noqa: E402
from portbench.harness import Outcome, Run  # noqa: E402
from portbench.reference import hrnet_w48 as ref_hrnet  # noqa: E402
from portbench.reference.lower import fp8_cast  # noqa: E402
from portbench.roofline import over_batches  # noqa: E402
from portbench.roofline_hrnet import branch_units, fuse_units, hrnet_units  # noqa: E402

_extract = harness.load_module(harness.HERE / "drivers" / "extract.py",
                               "portbench_driver_extract_helpers")
_vit = harness.load_module(harness.HERE / "drivers" / "extract_vit.py",
                           "portbench_driver_extract_vit_helpers")
extract_config, read_shard = _extract.extract_config, _extract.read_shard
variant_rows, gap, BLOCK = _extract.variant_rows, _extract.gap, _extract.BLOCK
CALL_SPANS, _run_of = _vit.CALL_SPANS, _vit._run_of

SPANS = "h36x.hrnet."


def hrnet_config(run: Run, weights: str):
    """extract_config's, with the cell's backbone. A program that does not
    know the backbone fails here, before any set-up."""
    from h36x_torch import config

    backbone = run.cell.spec["backbone"]
    if backbone not in getattr(config, "BACKBONE_FEATURE_DIM", {}):
        raise RuntimeError(f"this program has no --backbone {backbone}: it cannot run "
                           f"{run.cell.name}")
    return dataclasses.replace(extract_config(run, weights), backbone=backbone)


def weights_of(run: Run) -> dict:
    return ref_hrnet.make_weights(ref_hrnet.sizes(run.cell.config),
                                  synth.generator(run.seed, "hrnet_w48", device=run.device),
                                  run.device)


def dispatch_sizes(frames: int, dispatches: int, per: int) -> dict:
    """{rows: dispatches} of a call that sent `frames` rows in `dispatches`
    dispatches: full ones of `per` rows, the last at its own size."""
    last = frames - per * (dispatches - 1)
    if dispatches < 1 or not 0 < last <= per:
        raise RuntimeError(f"{frames} rows cannot be {dispatches} dispatches of {per} "
                           "and a last one")
    sizes = {per: dispatches - 1} if dispatches > 1 else {}
    sizes[last] = sizes.get(last, 0) + 1
    return sizes


def run(run: Run) -> Outcome:
    spec, dev = run.cell.spec, run.device
    cuda = dev.type == "cuda"
    weights = run.workdir / "hrnet_w48.pt"
    cfg = hrnet_config(run, str(weights))
    from h36x_torch.extract.dedup import default_frames_per_dispatch
    from h36x_torch.extract.pipeline import resolve_extract_modes, run_extract
    from h36x_torch.models import hrnet

    sizes = ref_hrnet.sizes(run.cell.config)
    if sizes != hrnet.HRNET_W48:
        raise RuntimeError(f"the program's HRNet-W48 {hrnet.HRNET_W48} is not the "
                           f"configuration's {sizes}")
    w = weights_of(run)
    torch.save({k: v.cpu() for k, v in w.items()}, weights)
    del w
    phases = {"weights_written": time.perf_counter() - run.t_start}
    videos = synth.SyntheticVideos(run.seed, spec["videos"], spec["frames"], spec["raw"],
                                   spec["seq_len"], spec["stride"], dev)
    phases["videos_made"] = time.perf_counter() - run.t_start
    run_extract(dataclasses.replace(cfg, out=str(run.workdir / "warm")), videos, dev)
    shutil.rmtree(run.workdir / "warm")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    calls, clips, frames, dedup, tr, traced = 0, 0, 0, None, None, None
    counted = dict.fromkeys(("h36x.hrnet.frames", "h36x.hrnet.fuse_paths",
                             "h36x.extract.dispatches"), 0)
    last, call_s = None, []
    while True:
        t_call = time.perf_counter()
        out = run.workdir / f"store{calls}"
        call_cfg = dataclasses.replace(cfg, out=str(out))
        if run.trace and tr is None:
            tr = span_trace.SpanTrace(run.workdir / "trace.json", cuda, SPANS)
            with tr:
                summary = run_extract(call_cfg, videos, dev)
            traced = summary
        else:
            summary = run_extract(call_cfg, videos, dev)
        calls += 1
        clips += summary["n_processed"]
        frames += summary["backbone_frames"]
        for name in counted:
            counted[name] += summary["counts"].get(name, 0)
        dedup = summary["dedup_ratio"]
        last = out
        host = summary.get("host_s", {})
        call_s.append([round(time.perf_counter() - t_call, 3)]
                      + [round(host.get("h36x.extract." + n, (0.0, 0))[0], 3) for n in CALL_SPANS])
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
    del videos
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = compare(run, last)
    record = {"window_s": window_s, "dedup_ratio": dedup}
    if tr is not None:
        # the dispatches the program sent: full ones and the last at its
        # size, no padding on one device; a dispatch reads the weights once
        per = cfg.frames_per_dispatch or default_frames_per_dispatch(
            resolve_extract_modes(cfg, production=True))
        batches = dispatch_sizes(traced["backbone_frames"],
                                 traced["counts"]["h36x.extract.dispatches"], per)
        flops, bound = over_batches(lambda n: hrnet_units(n, sizes), batches)
        _, branch_bound = over_batches(lambda n: branch_units(n, sizes), batches)
        _, fuse_bound = over_batches(lambda n: fuse_units(n, sizes), batches)
        record.update(traced_window_s=tr.host_s, traced_flops=flops, traced_bound_s=bound,
                      branch_bound_s=branch_bound,
                      branch_device_s=tr.device_s.get(SPANS + "branches", 0.0),
                      fuse_bound_s=fuse_bound,
                      fuse_device_s=tr.device_s.get(SPANS + "fuse", 0.0),
                      span_device_s=tr.device_s)
    return Outcome(
        setup_s=setup_s, e2e={"extract_clips_per_s": clips / window_s}, record=record,
        attempted=clips, failed=0, checks=checks, memory_peak_bytes=peak,
        trace=tr.summary if tr is not None else None,
        proof={"calls": calls, "clips": clips, "backbone_frames": frames,
               "hrnet_frames": counted["h36x.hrnet.frames"],
               "fuse_paths": counted["h36x.hrnet.fuse_paths"],
               "dispatches": counted["h36x.extract.dispatches"],
               "fuse_paths_a_forward": ref_hrnet.fuse_paths(sizes),
               "dedup_ratio": dedup, "setup_phases_s": phases,
               "check_s": time.perf_counter() - t_check, "call_s": call_s,
               "span_device_s": tr.device_s if tr is not None else None})


def reference_video(run: Run, v: int, w: dict) -> dict:
    """The reference's features of every frame of video `v`: orig, jitter
    and flip (each (frames, feature) float64 on the host), and its box."""
    spec, dev = run.cell.spec, run.device
    sizes = ref_hrnet.sizes(run.cell.config)
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
            out[name] = torch.cat([ref_hrnet.forward(w, pix[i:i + BLOCK], sizes)
                                   for i in range(0, len(pix), BLOCK)]).double().cpu()
    return out


def compare(run: Run, store) -> list:
    """Every clip of the store against the reference: its index entry, its
    four rows' features and boxes."""
    spec = run.cell.spec
    with open(store / "index.json") as f:
        index = json.load(f)
    expected = {(v + 1, s) for v in range(spec["videos"])
                for s in range(0, spec["frames"] - spec["seq_len"] + 1, spec["stride"])}
    seen = [(int(c["subject"]), int(c["start"])) for c in index["clips"]]
    index_faults = len(expected ^ set(seen)) + len(seen) - len(set(seen))
    shards = {sid: read_shard(store / f"shard_{sid:05d}.h36x")
              for sid in {int(c["shard_id"]) for c in index["clips"]}}
    w = weights_of(run)
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
    return [("feature_gap", worst, spec["limits"]["feature_gap"]),
            ("box_faults", float(box_faults), 0.0),
            ("index_faults", float(index_faults), 0.0)]


@contextlib.contextmanager
def reference_in_place(run: Run, cast=fp8_cast):
    """The plain reference, its operands rounded by `cast` (None: as it
    is), in the program's place as the backbone's feature function."""
    from h36x_torch.extract import pipeline

    w = weights_of(run)
    sizes = ref_hrnet.sizes(run.cell.config)

    def reference_feature_fn(model, mesh=None, engine=None):
        def features(frames_u8):
            x = torch.as_tensor(frames_u8).to(run.device)
            with torch.no_grad():
                return torch.cat([ref_hrnet.forward(w, x[i:i + BLOCK], sizes, cast)
                                  for i in range(0, len(x), BLOCK)])
        return features

    real = pipeline.make_feature_fn
    pipeline.make_feature_fn = reference_feature_fn
    try:
        yield
    finally:
        pipeline.make_feature_fn = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="hrnet_w48.extract-256x192")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("extract_hrnet: the readings are the card's; CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell.from_file(args.workload)
    dev = torch.device("cuda", 0)
    rows = []

    def emit(kind, seed, out):
        row = {"workload": cell.name, "kind": kind, "seed": seed, "correct": out.correct,
               **{n: v for n, v, _ in out.checks}}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        with contextlib.redirect_stdout(sys.stderr):
            out = run(_run_of(cell, seed, args.seconds, dev))
        emit("program", seed, out)
    for seed in args.control_seeds:
        r = _run_of(cell, seed, args.seconds, dev)
        with reference_in_place(r), contextlib.redirect_stdout(sys.stderr):
            out = run(r)
        emit("control_fp8", seed, out)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
