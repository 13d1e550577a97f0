"""Raw Human3.6M ingest (counterpart of h36x/data/ingest.py): metadata.xml
cameras and pose files -> the ingested tree. For every (subject, action,
trial, camera) it writes

    S{s}/{Action}_{trial0}/cam_{c0}/
        camera_wext.pkl   {'f', 'c', 'k', 'rt', 't'}
        gt_poses.pkl      {'2d': (N,17,2), '3d': (N,17,3)}  mm
        <renamed>.mp4     symlink to the raw video
    S{s}/{Action}_{trial0}/orig_seq_name.txt

skipping what exists (a second run writes nothing) and S11's corrupt
"Phoning 2". The trees both packages write from one raw tree are
identical, pickles included.

Pose files are `.cdf` in the official release: reading one needs spacepy
(imported only there); a `.npz`/`.npy` sibling of the same basename (see
:func:`cdf_to_npz`) is read instead when present, with numpy alone.
"""

from __future__ import annotations

import functools
import itertools
import os
import pickle
import xml.etree.ElementTree as ET
from glob import glob
from os.path import exists, join
from typing import List, Optional, Tuple

import numpy as np

from h36x_torch.geometry.camera import rotation_matrix_xyz
from h36x_torch.geometry.skeleton import H36M_RAW_JOINT_IDS

ACTION_NAMES = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Posing",
    "Purchases", "Sitting", "SittingDown", "Smoking", "TakingPhoto",
    "Waiting", "Walking", "WakingDog", "WalkTogether",
)

N_SUBJECTS = 11
N_CAMS = 4
SUBJECTS_ORDER = (1, 6, 7, 8, 5, 9, 11)  # the default processing order

# The official capture rig's four camera serials, in the order metadata.xml's
# w0 calibration block indexes them (cam_id 1..4). File names embed them
# ({seq}.{serial}.{ext}); matching on them keeps pose files paired with
# their calibration even when a camera's files are missing.
H36M_CAMERA_SERIALS = ("54138969", "55011271", "58860488", "60457274")


@functools.lru_cache(maxsize=4)
def _parse_metadata(xml_path: str):
    """metadata.xml's parsed root, cached: an ingest reads it for every
    (subject, action, trial, camera) cell."""
    return ET.parse(xml_path).getroot()


def read_cam_parameters(xml_path: str, sbj_id: int, cam_id: int):
    """Camera extrinsics, intrinsics and distortion from metadata.xml's w0.

    w0 is a flat space-separated vector: n_cams * n_subjects * 6 extrinsic
    values, camera-major, then 9 intrinsic values (f, c, distortion(5)) per
    camera. The distortion is repacked as (k1, k2, p1, p2, k3).

    Returns (rt (3,3), t (3,), f (2,), c (2,), k (5,)), float64.
    """
    sbj0 = sbj_id - 1
    cam0 = cam_id - 1

    root = _parse_metadata(xml_path)
    w0 = root.find("w0")
    if w0 is None:
        raise ValueError(f"no <w0> element in {xml_path}")
    tokens = w0.text.strip().lstrip("[").rstrip("]").split()

    ext_start = (cam0 * N_SUBJECTS + sbj0) * 6
    extr = np.array(tokens[ext_start : ext_start + 6], dtype=np.float64)
    int_start = N_CAMS * N_SUBJECTS * 6 + cam0 * 9
    intr = np.array(tokens[int_start : int_start + 9], dtype=np.float64)

    rt = rotation_matrix_xyz(extr[:3])
    t = extr[3:]
    f = intr[:2]
    c = intr[2:4]
    d = intr[4:]  # metadata order (k1, k2, k3, p1, p2)
    k = np.hstack((d[:2], d[3:5], d[2:3]))  # -> (k1, k2, p1, p2, k3)
    return rt, t, f, c, k


def read_action_name(xml_path: str, sbj_id: int, action_no: int,
                     trial_no: int) -> Optional[str]:
    """A subject's sequence name from the XML <mapping> table (its action
    numbers start at 2: action 1 is 'ALL'); None when there is no row."""
    root = _parse_metadata(xml_path)
    mapping = root.find("mapping")
    if mapping is None:
        raise ValueError(f"no <mapping> element in {xml_path}")
    for tr in list(mapping):
        cells = list(tr)
        if len(cells) < 2 + sbj_id:
            continue
        if cells[0].text == str(action_no + 1) and cells[1].text == str(trial_no):
            return cells[2 + sbj_id - 1].text
    return None


def read_poses(
    path: str,
    is_3d: bool = False,
    joint_ids: Tuple[int, ...] = H36M_RAW_JOINT_IDS,
    n_frames: Optional[int] = None,
) -> np.ndarray:
    """A pose sequence as float32 (N, len(joint_ids), dim), mm.

    The raw layout is a flat (1, N, 32 * dim) 'Pose' variable. A `.cdf`
    path reads its `.npz` or `.npy` sibling when one exists; a `.cdf`
    itself needs spacepy.
    """
    dim = 3 if is_3d else 2
    if path.endswith(".cdf"):
        for alt in (path[:-4] + ".npz", path[:-4] + ".npy"):
            if exists(alt):
                path = alt
                break
    if path.endswith(".cdf"):
        try:
            from spacepy import pycdf
        except ImportError as e:
            raise RuntimeError(
                f"reading {path} needs spacepy/pycdf (absent here). "
                "Pre-convert pose CDFs with h36x_torch.data.ingest.cdf_to_npz "
                "on a machine that has it, or place a sibling .npz/.npy file."
            ) from e
        poses = pycdf.CDF(path)["Pose"][...][0]
    elif path.endswith(".npz"):
        with np.load(path) as z:
            poses = z[z.files[0]]
        poses = poses[0] if poses.ndim == 3 else poses
    else:
        poses = np.load(path)
        poses = poses[0] if poses.ndim == 3 else poses

    if n_frames is None:
        n_frames = poses.shape[0]
    ids = np.asarray(joint_ids)
    out = poses[:n_frames].reshape(n_frames, -1, dim)[:, ids, :]
    return np.ascontiguousarray(out.astype(np.float32))


def cdf_to_npz(cdf_path: str, out_path: Optional[str] = None) -> str:
    """Convert a raw CDF's 'Pose' variable to .npz (all 32 joints), once,
    on a machine with spacepy."""
    from spacepy import pycdf

    poses = np.asarray(pycdf.CDF(cdf_path)["Pose"][...])
    out_path = out_path or cdf_path[:-4] + ".npz"
    np.savez_compressed(out_path, Pose=poses)
    return out_path


def _by_ident(pattern) -> dict:
    """{camera identifier: path} of the files matching `pattern`, the
    identifier being the middle part of {seq}.{ident}.{ext}."""
    out = {}
    for p in glob(pattern):
        parts = os.path.basename(p).rsplit(".", 2)
        if len(parts) == 3:
            out[parts[1]] = p
    return out


def _pose_files(dirpath, seq_name) -> dict:
    """Pose files by camera identifier, of every extension read_poses takes:
    a tree may hold only the .npz/.npy siblings. A later extension wins, and
    .cdf is safe to prefer because read_poses redirects it to a sibling."""
    out = {}
    for ext in ("npy", "npz", "cdf"):
        out.update(_by_ident(join(dirpath, f"{seq_name}.*{ext}")))
    return out


def ingest(
    source_dir: str,
    out_dir: str,
    subjects: Optional[List[int]] = None,
    trials: Tuple[int, ...] = (1, 2),
    cams: Tuple[int, ...] = (1, 2, 3, 4),
    actions: Optional[List[int]] = None,
    verbose: bool = True,
) -> int:
    """Walk subject x action x trial x camera and write the ingested tree.
    None means every subject (action); an empty list means none.

    Returns the number of (sequence, camera) cells with a video, written or
    found complete.
    """
    xml_path = join(source_dir, "metadata.xml")
    subjects = list(subjects) if subjects is not None else list(SUBJECTS_ORDER)
    actions = list(actions) if actions is not None else list(range(1, 16))
    n_done = 0

    for sbj_id, action_id, trial_id in itertools.product(subjects, actions, trials):
        seq_name = read_action_name(xml_path, sbj_id, action_id, trial_id)
        if seq_name is None:
            if verbose:
                print(f"S{sbj_id} action {action_id} trial {trial_id}: no mapping, skipping")
            continue
        if sbj_id == 11 and "Phoning 2" in seq_name:
            continue  # corrupt sequence in the official release

        save_seq = f"{ACTION_NAMES[action_id - 1]}_{trial_id - 1}"
        output_base = join(out_dir, f"S{sbj_id}", save_seq)

        # the sequence's files, keyed by the camera identifier in their names
        videos = _by_ident(join(source_dir, f"S{sbj_id}", "Videos", f"{seq_name}.*mp4"))
        pose2d = _pose_files(join(source_dir, f"S{sbj_id}", "MyPoseFeatures/D2_Positions"),
                             seq_name)
        pose3d = _pose_files(
            join(source_dir, f"S{sbj_id}", "MyPoseFeatures/D3_Positions_mono"), seq_name)
        idents = sorted(set(videos) | set(pose2d) | set(pose3d))
        # cam_id -> identifier: absolute through the official serials, so a
        # camera whose files are all absent shifts no other camera onto its
        # calibration; other identifiers (converted or synthetic trees) go
        # by position, with a warning when cameras are missing
        canonical = set(idents) <= set(H36M_CAMERA_SERIALS)
        if not canonical and idents and len(idents) < len(cams) and verbose:
            print(f"WARNING: S{sbj_id} {seq_name!r}: only {len(idents)} "
                  f"camera identifiers found ({idents}) and they are not "
                  "official H36M serials — positional cam assignment may "
                  "pair poses with the wrong calibration")

        for cam_id in cams:
            if canonical:
                ident = (H36M_CAMERA_SERIALS[cam_id - 1]
                         if cam_id <= len(H36M_CAMERA_SERIALS) else None)
                if ident not in idents:
                    ident = None
            else:
                ident = idents[cam_id - 1] if cam_id <= len(idents) else None
            if ident is None or ident not in pose2d or ident not in pose3d:
                if verbose:
                    print(f"  missing pose files for cam {cam_id}"
                          f"{f' (camera {ident})' if ident else ''}, skipping")
                continue

            # directories only for cells that are written
            output_dir = join(output_base, f"cam_{cam_id - 1}")
            os.makedirs(output_dir, exist_ok=True)
            if verbose:
                print(f"S{sbj_id} {seq_name!r} -> {output_dir}")
            name_path = join(output_base, "orig_seq_name.txt")
            if not exists(name_path):
                with open(name_path, "w") as f:
                    f.write(seq_name)

            cam_path = join(output_dir, "camera_wext.pkl")
            if not exists(cam_path):
                rt, t, f, c, k = read_cam_parameters(xml_path, sbj_id, cam_id)
                with open(cam_path, "wb") as fw:
                    pickle.dump({"f": f, "c": c, "k": k, "rt": rt, "t": t}, fw)

            gt_path = join(output_dir, "gt_poses.pkl")
            if not exists(gt_path):
                poses2d = read_poses(pose2d[ident])
                poses3d = read_poses(pose3d[ident], is_3d=True)
                with open(gt_path, "wb") as fgt:
                    pickle.dump({"2d": poses2d, "3d": poses3d}, fgt)

            if ident in videos:
                out_video = join(
                    output_dir,
                    f"S{sbj_id}_{ACTION_NAMES[action_id - 1]}_{trial_id - 1}"
                    f"_cam_{cam_id - 1}.mp4")
                # lexists: a dangling link (the raw tree moved) reads as
                # absent to exists(), and relinking over it would raise
                if os.path.lexists(out_video) and not exists(out_video):
                    os.unlink(out_video)
                if not os.path.lexists(out_video):
                    os.symlink(os.path.abspath(videos[ident]), out_video)
                n_done += 1
            elif verbose:
                print(f"  no video for cam {cam_id} (camera {ident}) — poses "
                      "written, but clip scans skip video-less cells (not counted)")

    return n_done
