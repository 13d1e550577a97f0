"""CLI: environment + artifact diagnostics (counterpart of
h36x/cli/doctor.py).

One command that answers "why doesn't my setup work": the CUDA device and
PyTorch build, the hand-written Hopper kernels (each built with nvcc or
loaded from the build directory), the native host library, optional host
dependencies (cv2 / spacepy / matplotlib), and, when pointed at
artifacts, shard store, checkpoint (msgpack, or orbax: every array read and
every CRC-32C checked) and export-artifact sanity, the dedup
estimate of an ingested tree and the preflight of a raw H36M drop.

    python -m h36x_torch.cli.doctor --root STORE --ckpt runs/best.msgpack

The CUDA and kernel checks are required: with no card visible the doctor
fails, unless `--device cpu` is given (then the kernels are "skipped
(cpu)"). Exit code is non-zero if any required check fails (store /
checkpoint / artifact checks are required once their flag is given;
optional dependencies only warn).
"""

import argparse
import glob as glob_mod
import importlib

# extraction clip-frames/s a card sustains, for the preflight's time
# forecast: the `opt` engine's backbone frames/s at the dispatch size
# (480 frames), read by chip_smoke.py's `backbone` record on an NVIDIA H100
# 80GB HBM3, 700.00 W
RATE_CFPS = 17377.7
RATE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _check(name, fn, problems, required=True):
    try:
        detail = fn()
        print(f"  [ok] {name}: {detail}")
    except Exception as e:  # noqa: BLE001 - diagnostics must not crash
        tag = "FAIL" if required else "warn"
        print(f"  [{tag}] {name}: {type(e).__name__}: {e}")
        if required:
            problems.append(name)


def _cuda_info(device):
    def probe():
        import torch

        base = (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                "device(s)")
        if device == "cpu":
            return f"{base}; running on the CPU (--device cpu)"
        if not torch.cuda.is_available():
            raise RuntimeError(f"{base}: no CUDA device visible (pass --device "
                               "cpu to check the CPU path)")
        return f"{base} [{torch.cuda.get_device_name(0)}]"

    return probe


def _nvcc_version() -> str:
    import subprocess

    from h36x_torch.ops import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip().splitlines()[-1]


def _kernels_info(device):
    """Build (nvcc, in parallel) or load each hand-written kernel's library."""

    def probe():
        from h36x_torch.ops import _build

        if device == "cpu":
            return "skipped (cpu)"
        names = list(_build.SIGNATURES)
        cached = {n: _build._lib_path(n).exists() for n in names}
        _build.load(*names)
        for n in names:
            how = ("loaded" if cached[n] else
                   f"built in {_build.build_seconds.get(n, float('nan')):.1f} s")
            print(f"       - {n}: {how} ({_build._lib_path(n).name})")
        return (f"{len(names)} extensions ready; {_nvcc_version()}; build dir "
                f"{_build.BUILD_DIR}")

    return probe


def _native_info():
    from h36x_torch import native

    lib = native.load()
    if lib is None:
        raise RuntimeError("libh36xio not built and build failed "
                           "(falling back to cv2 / numpy host ops)")
    return f"libh36xio loaded ({lib._name})"


def _optional(mod):
    def probe():
        m = importlib.import_module(mod)
        return getattr(m, "__version__", "present")

    return probe


def _store_info(root):
    def probe():
        from pathlib import Path

        from h36x_torch.data.shards import load_index, read_shard, shard_path

        idx = load_index(root)
        n = idx["n_shards"]
        if n is None:  # reference index.pt may omit it; recompute from clips
            n = 1 + max(c["shard_id"] for c in idx["clips"])
        torch_fmt = bool(idx.get("torch_format"))
        # torch stores ship shard_XXXXX.pt — check THOSE, not the .h36x
        # names (gating the checks off entirely would print [ok] for a
        # reference store with absent/corrupt shards, exactly the failure
        # the doctor exists to preempt)
        def _spath(s):
            return (Path(root) / f"shard_{s:05d}.pt") if torch_fmt \
                else shard_path(root, s)

        missing = [s for s in range(n) if not _spath(s).exists()]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)}/{n} shard files missing (first: "
                f"{_spath(missing[0]).name})")
        detail = (f"{idx['n_clips']} clips x {idx['n_variants']} variants, "
                  f"{n} shards, seq_len={idx['seq_len']}, "
                  f"dtype={idx['feat_dtype']}")
        if torch_fmt:
            from h36x_torch.data.shards import load_torch_shard

            shard = load_torch_shard(root, 0)
        else:
            shard = read_shard(shard_path(root, 0))
        rows = shard["feats"].shape[0]
        detail += f"; shard 0 reads ok ({rows} rows)"
        return detail

    return probe


def _verify_store(root):
    """Deep integrity scan (vs `--root`'s shallow existence/read check):
    recompute every shard's recorded per-array CRC32s and cross-check the
    index's clip->shard mapping against on-disk row counts."""

    def probe():
        from h36x_torch.data.shards import verify_store

        rep = verify_store(root)
        if rep["errors"]:
            for e in rep["errors"][:10]:
                print(f"       - {e}")
            if len(rep["errors"]) > 10:
                print(f"       - ... {len(rep['errors']) - 10} more")
            raise RuntimeError(f"{len(rep['errors'])} integrity error(s)")
        note = ("" if not rep["arrays_unchecked"] else
                f"; {rep['arrays_unchecked']} array(s) predate checksums "
                "(readable but unverifiable)")
        return (f"{rep['n_shards']} shards, {rep['rows']} rows, "
                f"{rep['arrays_checked']} arrays CRC-verified{note}")

    return probe


def _artifact_info(path):
    """Export-artifact check: re-hash the .pt2 against its .json sidecar's
    sha256 / nbytes, then read its h36x_torch.json metadata and report its
    platforms and shapes."""

    def probe():
        import hashlib
        import json
        from pathlib import Path

        p = Path(path)
        blob = p.read_bytes()
        side = Path(str(p) + ".json")
        verified = ""
        if side.exists():
            rec = json.loads(side.read_text())
            want_n = rec.get("nbytes")
            if want_n is not None and want_n != len(blob):
                raise RuntimeError(
                    f"size mismatch: sidecar records {want_n} bytes, file "
                    f"is {len(blob)} — truncated or mispaired")
            want = rec.get("sha256")
            if want is not None:
                got = hashlib.sha256(blob).hexdigest()
                if got != want:
                    raise RuntimeError(
                        f"sha256 mismatch: sidecar records {want[:12]}..., "
                        f"file hashes {got[:12]}... — blob corrupted")
                verified = ", sha256 verified"
        from h36x_torch.export import artifact_info

        info = artifact_info(blob)
        return (f"{info['nbytes'] / 1e6:.1f} MB, platforms "
                f"{info['platforms']}, in {info['in_avals']}{verified}")

    return probe


def _ckpt_info(path):
    def probe():
        import json
        from pathlib import Path

        def describe(man: dict) -> str:
            # training manifests carry epoch/step/best_val; cli.convert
            # writes {converted_from, format} only: report what exists
            if "epoch" in man:
                return (f"epoch {man['epoch']}, step {man.get('step', '?')}, "
                        f"best_val {man.get('best_val', float('nan')):.4f}")
            if "converted_from" in man:
                return (f"converted from {man['converted_from']} "
                        f"({man.get('format', 'unknown format')})")
            return f"manifest keys: {sorted(man)}"

        def arch(man: dict) -> str:
            mc = (man.get("config") or {}).get("model") or {}
            if not mc:
                return ""
            keys = ("latent_dim", "num_blocks", "groups", "regressor_iters")
            shown = {k: mc[k] for k in keys if k in mc}
            return ("; arch " + " ".join(f"{k}={v}" for k, v in shown.items())
                    if shown else "")

        def orbax(slot: Path) -> str:
            from h36x_torch.train.checkpoint import inspect_orbax

            info = inspect_orbax(slot)
            return (f"orbax {slot.name}: {info['arrays']} arrays, "
                    f"{info['bytes'] / 1e6:.1f} MB, {info['crc_checked']} "
                    "manifests/nodes CRC-32C verified")

        p = Path(path)
        if p.is_dir():  # a run directory, or an orbax one
            for name in ("last", "best"):
                if (p / f"{name}.json").exists():
                    man = json.loads((p / f"{name}.json").read_text())
                    detail = f"{name}: {describe(man)}{arch(man)}"
                    if man.get("backend") == "orbax" or "dir" in man:
                        from h36x_torch.train.checkpoint import _orbax_dir

                        slot = _orbax_dir(p, name)
                        if slot is None:
                            raise RuntimeError(f"{name}: the manifest names orbax "
                                               f"slot {man.get('dir')!r}, which is gone")
                        detail += "; " + orbax(slot)
                    return detail
            if (p / "_METADATA").exists():
                return orbax(p)
            raise FileNotFoundError("no last.json/best.json manifest found")
        man_path = p.with_suffix(".json")
        if not p.exists():
            raise FileNotFoundError(str(p))
        size_mb = p.stat().st_size / 1e6
        detail = f"{size_mb:.1f} MB"
        if man_path.exists():
            man = json.loads(man_path.read_text())
            detail += f", {describe(man)}{arch(man)}"
            want = man.get("sha256")
            if want is not None:  # recorded by save_checkpoint (msgpack)
                import hashlib

                blob = p.read_bytes()
                if man.get("nbytes") not in (None, len(blob)):
                    raise RuntimeError(
                        f"size mismatch: manifest records "
                        f"{man['nbytes']} bytes, file is {len(blob)} — "
                        "truncated or mispaired with this manifest")
                got = hashlib.sha256(blob).hexdigest()
                if got != want:
                    raise RuntimeError(
                        f"sha256 mismatch: manifest records {want[:12]}..., "
                        f"file hashes {got[:12]}... — blob corrupted or "
                        "mispaired with this manifest")
                detail += ", sha256 verified"
        return detail

    return probe


def dedup_stats(root, seq_len, stride, frame_skip):
    """Unique-frame-scheduler dedup counts from pose pickles alone (no
    video decode): the crop box of every window is a pure function of its
    2D-joint slice plus the frame dims (h36x_torch/extract/dedup.py keys the
    feature cache on (frame, box)). Dims come from the video header when
    the mp4 is present (one container open per video, no frame decode —
    the real H36M cameras are 1000x1002 while 2c would give ~1025x1031,
    which clamps edge boxes differently than the real scheduler); with no
    video the principal-point estimate dims = 2c is the fallback.

    Returns the counts; the derived ratios equal run_extract_dedup's
    reported `dedup_ratio` exactly when the whole tree is extracted with
    --augment."""
    import numpy as np

    from h36x_torch.data.clips import scan_clips
    from h36x_torch.geometry.crop import compute_square_crop_from_2d

    clips, gt_cache, _ = scan_clips(
        root, subjects=_all_subjects(root), seq_len=seq_len,
        stride=stride, frame_skip=frame_skip,
    )
    by_video: dict = {}
    for ci in clips:
        by_video.setdefault(ci.video_idx, []).append(ci)
    unique = 0
    total = 0
    stable = 0
    windows = 0
    uniq_frames = 0  # distinct subsampled frames covered (video scope)
    for cis in by_video.values():
        j2d_all = gt_cache[cis[0].gt_path][1]
        img_w = img_h = 0
        try:  # header-only open; the scheduler clamps on the DECODED dims
            import cv2

            cap = cv2.VideoCapture(cis[0].video_path)
            if cap.isOpened():
                img_w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                img_h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            cap.release()
        except ImportError:
            pass
        if img_w <= 0 or img_h <= 0:
            c = np.asarray(cis[0].cam_params.get("c", ()),
                           np.float64).reshape(-1)
            if c.size == 2 and np.all(c > 0):
                img_w, img_h = int(round(2 * c[0])), int(round(2 * c[1]))
            else:  # no principal point: generous bound, clamp only at edges
                img_h = img_w = int(np.ceil(j2d_all.max() * 1.6)) + 8
        seen = set()
        frames = set()
        prev = None
        for ci in cis:
            j2d = j2d_all[np.arange(ci.start, ci.end) * frame_skip]
            box = compute_square_crop_from_2d(j2d, img_h, img_w)
            bkey = tuple(int(v) for v in box[:3])
            windows += 1
            if prev is not None and bkey == prev:
                stable += 1
            prev = bkey
            for t in range(ci.start, ci.end):
                total += 1
                frames.add(t)
                if (t, bkey) not in seen:
                    seen.add((t, bkey))
                    unique += 1
        uniq_frames += len(frames)
    return {
        "n_clips": len(clips), "n_videos": len(by_video), "total": total,
        "unique": unique, "uniq_frames": uniq_frames, "stable": stable,
        "windows": windows,
    }


def dedup_ratios(s: dict) -> dict:
    """Device dedup vs the per-clip pipeline's 3 passes/clip-frame, per
    mode. cjitter costs seq_len per clip at --jitter-key clip but is
    cached like orig/hflip when re-keyed; --crop-scope video gives every
    frame ONE box, so unique (frame, box) pairs == distinct frames."""
    t, u, uf = s["total"], s["unique"], s["uniq_frames"]
    return {
        "clip": 3 * t / (t + 2 * u),
        "crop_video": 3 * t / (t + 2 * uf),
        "jitter_rekey": t / u,
        "full": t / uf,
    }


def _dedup_estimate(root, seq_len, stride, frame_skip):
    """The number that decides whether --crop-scope video or --jitter-key
    video|frame is worth turning on for a given dataset (see dedup_stats)."""

    def probe():
        s = dedup_stats(root, seq_len, stride, frame_skip)
        r = dedup_ratios(s)
        passes = (s["total"] + 2 * s["unique"]) / s["total"]
        pairs = max(s["windows"] - s["n_videos"], 1)
        return (f"{s['n_clips']} clips / {s['n_videos']} videos: "
                f"{100 * s['stable'] / pairs:.0f}% of consecutive windows "
                f"share a box; unique (frame, box) = "
                f"{s['unique']}/{s['total']} -> ~{r['clip']:.2f}x device "
                f"dedup at reference semantics ({passes:.2f} "
                f"passes/clip-frame); --crop-scope video guarantees "
                f"{r['crop_video']:.2f}x; --jitter-key video|frame -> "
                f"{r['jitter_rekey']:.2f}x ({r['full']:.2f}x with "
                f"--crop-scope video)")

    return probe


def run_preflight(root: str, seq_len: int, stride: int, frame_skip: int,
                  save_fp16: bool = False, rate_cfps: float = RATE_CFPS) -> list:
    """Dry-validate a raw H36M drop before hours are spent on it.

    Walks the raw layout the ingest stage expects (metadata.xml + per
    subject Videos/ + MyPoseFeatures/{D2_Positions,D3_Positions_mono},
    reference read_human_36m.py:308-340), checks pose readability in THIS
    environment (CDF needs spacepy; .npz/.npy siblings work everywhere),
    counts ingestable (sequence, camera) cells against the official
    7x15x2x4 grid, forecasts clip counts / store size / pool RAM /
    extraction time from the pose lengths, and prints the exact stage
    commands. Returns a list of hard-failure names (empty = launchable).
    """
    import os
    from os.path import exists, join

    import numpy as np

    from h36x_torch.config import ExtractConfig
    from h36x_torch.data.ingest import (
        H36M_CAMERA_SERIALS,
        SUBJECTS_ORDER,
        read_action_name,
        read_cam_parameters,
    )

    problems: list = []

    def say(line):
        print(f"  [preflight] {line}")

    def fail(name, line):
        print(f"  [preflight] FAIL: {line}")
        problems.append(name)

    xml_path = join(root, "metadata.xml")
    if not exists(xml_path):
        fail("metadata.xml", f"{xml_path} missing — cameras cannot be "
             "calibrated; this is not a raw H36M root")
        # an ingested tree is the most common mix-up
        if any(os.path.isdir(join(root, d)) and
               next(iter(glob_mod.glob(join(root, d, "*", "cam_*"))), None)
               for d in os.listdir(root) if d.startswith("S")):
            say("this looks like an INGESTED tree — run "
                "`python -m h36x_torch.cli.doctor --dedup-estimate <root>` on "
                "it instead")
        return problems
    try:
        read_cam_parameters(xml_path, 1, 1)
        say("metadata.xml parses; w0 calibration block present")
    except Exception as e:  # noqa: BLE001
        fail("metadata.xml", f"calibration parse failed: {e}")
        return problems

    subjects = [s for s in SUBJECTS_ORDER
                if os.path.isdir(join(root, f"S{s}"))]
    missing_subj = [s for s in SUBJECTS_ORDER if s not in subjects]
    if not subjects:
        fail("subjects", "no S*/ subject directories found")
        return problems
    say(f"subjects present: {' '.join(f'S{s}' for s in subjects)}"
        + (f" (missing from the official set: "
           f"{' '.join(f'S{s}' for s in missing_subj)})" if missing_subj
           else " (full official set)"))

    try:
        import spacepy  # noqa: F401

        have_spacepy = True
    except ImportError:
        have_spacepy = False

    def _idents(pattern):
        out = {}
        for p in glob_mod.glob(pattern):
            parts = os.path.basename(p).rsplit(".", 2)
            if len(parts) == 3:
                out[parts[1]] = p
        return out

    def _pose_len(path_2d) -> int:
        """Frame count of one pose file without jointing (cheap header-ish
        read; npz decompresses one array)."""
        if path_2d.endswith(".cdf"):
            for alt in (path_2d[:-4] + ".npz", path_2d[:-4] + ".npy"):
                if exists(alt):
                    path_2d = alt
                    break
        if path_2d.endswith(".cdf"):
            if not have_spacepy:
                return -1
            from spacepy import pycdf

            return int(pycdf.CDF(path_2d)["Pose"].shape[1])
        if path_2d.endswith(".npz"):
            with np.load(path_2d) as z:
                arr = z[z.files[0]]
            return int(arr.shape[1] if arr.ndim == 3 else arr.shape[0])
        arr = np.load(path_2d, mmap_mode="r")
        return int(arr.shape[1] if arr.ndim == 3 else arr.shape[0])

    cells = 0          # ingestable (sequence, camera) cells with video
    cells_no_video = 0
    cdf_only = 0       # pose files readable only via spacepy
    seq_total = 0
    seq_missing = []
    clips_total = 0
    frames_total = 0
    unknown_len = 0
    for sbj in subjects:
        for action_id in range(1, 16):
            for trial_id in (1, 2):
                seq_name = read_action_name(xml_path, sbj, action_id,
                                            trial_id)
                if seq_name is None:
                    continue
                if sbj == 11 and "Phoning 2" in seq_name:
                    continue  # official corrupt sequence (ingest skips it)
                seq_total += 1
                videos = _idents(join(root, f"S{sbj}", "Videos",
                                      f"{seq_name}.*mp4"))
                p2d = {}
                for ext in ("npy", "npz", "cdf"):
                    p2d.update(_idents(join(
                        root, f"S{sbj}", "MyPoseFeatures/D2_Positions",
                        f"{seq_name}.*{ext}")))
                p3d = {}
                for ext in ("npy", "npz", "cdf"):
                    p3d.update(_idents(join(
                        root, f"S{sbj}", "MyPoseFeatures/D3_Positions_mono",
                        f"{seq_name}.*{ext}")))
                idents = sorted(set(videos) | set(p2d) | set(p3d))
                # same condition ingest() warns on: positional assignment
                # is only ambiguous when cameras are missing
                if (idents and not set(idents) <= set(H36M_CAMERA_SERIALS)
                        and len(idents) < 4):
                    say(f"WARNING S{sbj} {seq_name!r}: only {len(idents)} "
                        f"non-official camera identifiers {idents} — ingest "
                        "falls back to positional assignment, which may "
                        "pair poses with the wrong calibration")
                got_any = False
                for serial in (idents if idents else []):
                    if serial not in p2d or serial not in p3d:
                        continue
                    for path in (p2d[serial], p3d[serial]):
                        if path.endswith(".cdf") and not (
                                exists(path[:-4] + ".npz")
                                or exists(path[:-4] + ".npy")):
                            cdf_only += 1
                    if serial in videos:
                        cells += 1
                        got_any = True
                        n = _pose_len(p2d[serial])
                        if n < 0:
                            unknown_len += 1
                        else:
                            usable = (n + frame_skip - 1) // frame_skip
                            c = max(0, (usable - seq_len) // stride + 1)
                            clips_total += c
                            frames_total += n
                    else:
                        cells_no_video += 1
                if not got_any:
                    seq_missing.append(f"S{sbj}/{seq_name}")

    official_cells = 0
    for sbj in subjects:
        n_seq = sum(1 for a in range(1, 16) for t in (1, 2)
                    if read_action_name(xml_path, sbj, a, t) is not None
                    and not (sbj == 11 and "Phoning 2" in
                             (read_action_name(xml_path, sbj, a, t) or "")))
        official_cells += n_seq * 4
    say(f"sequences: {seq_total} mapped; ingestable (sequence, camera) "
        f"cells with video+poses: {cells}/{official_cells}"
        + (f"; {cells_no_video} cells have poses but no video (clip scans "
           "skip them)" if cells_no_video else ""))
    if seq_missing:
        say(f"{len(seq_missing)} sequences have NO complete camera: "
            + ", ".join(seq_missing[:6])
            + (" ..." if len(seq_missing) > 6 else ""))
    if cells == 0:
        fail("cells", "no ingestable (sequence, camera) cells — check the "
             "Videos/ and MyPoseFeatures/ layout")
        return problems

    if cdf_only:
        if have_spacepy:
            say(f"{cdf_only} pose files are CDF-only (spacepy present: ok; "
                "consider pre-converting with h36x_torch.data.ingest.cdf_to_npz "
                "for spacepy-free machines)")
        else:
            fail("cdf", f"{cdf_only} pose files are CDF-only and spacepy "
                 "is ABSENT here — pre-convert on a spacepy machine: "
                 "python -c 'from h36x_torch.data.ingest import cdf_to_npz; ...' "
                 "(writes sibling .npz files ingest/preflight can read)")
    else:
        say("all pose files readable in this environment "
            f"(spacepy {'present' if have_spacepy else 'absent, not needed'})")

    if unknown_len:
        known = cells - unknown_len
        if known > 0:  # extrapolate the forecast over unreadable files
            scale = cells / known
            say(f"{unknown_len} pose files unreadable without spacepy — "
                f"clip forecast extrapolated x{scale:.2f}")
            clips_total = int(clips_total * scale)
            frames_total = int(frames_total * scale)

    # --- forecasts ---------------------------------------------------------
    dflt = ExtractConfig()
    n_vars = 4
    feat_bytes = 2 if save_fp16 else 4
    row_bytes = seq_len * (2048 * feat_bytes + 17 * 5 * 4) + 9 * 4
    store_gb = clips_total * n_vars * row_bytes / 2**30
    pool_clip_bytes = n_vars * seq_len * (2048 * 4 + 17 * 5 * 4) + 9 * 4
    pool_unbounded_gb = dflt.shuffle_pool * pool_clip_bytes / 2**30
    pool_bound_gb = (min(pool_unbounded_gb, dflt.shuffle_pool_gb)
                     if dflt.shuffle_pool_gb else pool_unbounded_gb)
    est_s = clips_total * seq_len / max(rate_cfps, 1.0)
    say(f"forecast: {clips_total} clips ({frames_total} raw frames) x "
        f"{n_vars} variants = {clips_total * n_vars} rows; store "
        f"~{store_gb:.1f} GiB {'fp16' if save_fp16 else 'fp32'}"
        + ("" if save_fp16 else
           f" (~{store_gb / 2 + clips_total * n_vars * seq_len * 17 * 5 * 4 / 2**31:.1f} GiB with --save-fp16)"))
    say(f"forecast: shuffle-pool host RAM ~{pool_bound_gb:.1f} GiB "
        f"(pool {dflt.shuffle_pool} clips would hold "
        f"{pool_unbounded_gb:.1f} GiB unbounded; --shuffle-pool-gb "
        f"{dflt.shuffle_pool_gb} caps it); add ~2-3 GiB decode/writer "
        "headroom")
    say(f"forecast: extraction ~{est_s / 60:.0f} min/card at "
        f"{rate_cfps:.0f} clip-frames/s (--rate; default: the opt engine's "
        f"backbone frames/s on an {RATE_CARD}, no dedup counted); e2e is "
        "decode/feed-bound below this device bound unless workers keep up")
    say("launch plan:")
    say(f"  1. python -m h36x_torch.cli.ingest --source-dir {root} --out-dir <ingested>")
    say("  2. python -m h36x_torch.cli.doctor --dedup-estimate <ingested>   "
        "(pick --crop-scope/--jitter-key)")
    say(f"  3. python -m h36x_torch.cli.extract --root <ingested> --out <features> "
        f"--augment true --seq-len {seq_len} --stride {stride} "
        f"--frame-skip {frame_skip}"
        + (" --save-fp16 true" if save_fp16 else "")
        + " --verify-after true")
    say("  4. python -m h36x_torch.cli.train --train-root <features> "
        "--train-subjects 1 5 6 7 8 "
        "--val-subjects 9 --outdir <runs>")
    return problems


def _all_subjects(root):
    import os
    import re

    subs = []
    for d in os.listdir(root):
        m = re.fullmatch(r"S(\d+)", d)
        if m:
            subs.append(int(m.group(1)))
    return sorted(subs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="", help="feature-shard store to check")
    p.add_argument("--ckpt", default="",
                   help="checkpoint file or run directory to check")
    p.add_argument("--artifact", default="",
                   help="cli.export artifact (.pt2): re-hash against its .json "
                        "sidecar and read its h36x_torch.json metadata")
    p.add_argument("--verify-store", default="",
                   help="feature-shard store: full integrity scan — "
                        "recompute per-array CRC32s, check truncation and "
                        "index/shard row agreement (reads every byte; "
                        "--root alone only checks existence + shard 0)")
    p.add_argument("--dedup-estimate", default="",
                   help="ingested clip tree: predict the unique-frame "
                        "scheduler's dedup ratio from pose data (no decode)")
    p.add_argument("--preflight", default="",
                   help="raw H36M drop: dry-validate layout/cameras/pose "
                        "readability, forecast clips/store/RAM/time, and "
                        "print the exact stage commands (no decode, no "
                        "hours burned on a broken tree)")
    p.add_argument("--save-fp16", action="store_true",
                   help="preflight: forecast the fp16 store size")
    p.add_argument("--rate", type=float, default=RATE_CFPS,
                   help="preflight: clip-frames/s/card for the time "
                        f"forecast (default {RATE_CFPS:.0f}: the opt engine's "
                        "backbone frames/s at 480 frames a dispatch, read by "
                        f"chip_smoke.py on an {RATE_CARD}; pass the e2e rate "
                        "your workers sustain for a wall-clock forecast)")
    p.add_argument("--seq-len", type=int, default=40)
    p.add_argument("--stride", type=int, default=5)
    p.add_argument("--frame-skip", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="'cpu' checks the CPU path: no card needed, kernels "
                        "skipped (default: cuda)")
    args = p.parse_args(argv)

    problems: list = []
    print("h36x_torch doctor")
    _check("cuda", _cuda_info(args.device), problems)
    _check("hopper kernels", _kernels_info(args.device), problems)
    _check("native library", _native_info, problems, required=False)
    for mod, why in (("cv2", "video decode"), ("spacepy", "raw CDF ingest"),
                     ("matplotlib", "show_batch / viz")):
        _check(f"{mod} ({why})", _optional(mod), problems, required=False)
    if args.root:
        _check(f"store {args.root}", _store_info(args.root), problems)
    if args.verify_store:
        _check(f"store integrity {args.verify_store}",
               _verify_store(args.verify_store), problems)
    if args.ckpt:
        _check(f"checkpoint {args.ckpt}", _ckpt_info(args.ckpt), problems)
    if args.artifact:
        _check(f"artifact {args.artifact}", _artifact_info(args.artifact),
               problems)
    if args.dedup_estimate:
        _check(
            f"dedup estimate {args.dedup_estimate}",
            _dedup_estimate(args.dedup_estimate, args.seq_len, args.stride,
                            args.frame_skip),
            problems,
        )

    if args.preflight:
        print(f"  preflight: raw H36M drop {args.preflight}")
        problems += run_preflight(
            args.preflight, args.seq_len, args.stride, args.frame_skip,
            save_fp16=args.save_fp16, rate_cfps=args.rate)

    if problems:
        raise SystemExit(f"doctor found problems: {', '.join(problems)}")
    print("all required checks passed")


if __name__ == "__main__":
    main()
