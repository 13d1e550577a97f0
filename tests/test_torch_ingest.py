"""h36x_torch's raw-H36M ingest and mask helpers against h36x on the CPU.
The same raw tree (h36x's fixture layout: metadata.xml with the w0 and
mapping blocks, npz poses beside empty .cdf files, stub mp4s) ingested by
both packages gives identical trees: file lists, symlink targets,
orig_seq_name.txt, and pickles with equal keys, dtypes and arrays. Then
the cases of tests/test_ingest.py through the port: camera gap, a fully
absent official camera, an npz-only tree, empty subjects, idempotence, a
dangling link repaired, a CDF without spacepy, the CLI, and the ingested
tree feeding the port's scan_clips; and masks.py against h36x's with cv2
and h5py."""

import os
import pickle

import numpy as np
import pytest

from h36x.data import ingest as jax_ingest
from h36x.data import masks as jax_masks
from h36x.geometry.camera import rotation_matrix_xyz as jax_rotation
from h36x_torch.data import ingest, masks
from h36x_torch.geometry.camera import rotation_matrix_xyz
from h36x_torch.geometry.skeleton import H36M_RAW_JOINT_IDS
from tests.test_ingest import _write_metadata_xml, raw_tree  # noqa: F401 (fixture)


def tree_listing(root) -> dict:
    """relative path -> ('dir',) | ('link', target) | ('file', bytes)."""
    out = {}
    for base, dirs, files in os.walk(root):
        for d in dirs:
            out[os.path.relpath(os.path.join(base, d), root)] = ("dir",)
        for f in files:
            p = os.path.join(base, f)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.readlink(p))
            else:
                with open(p, "rb") as fh:
                    out[rel] = ("file", fh.read())
    return out


def assert_same_tree(got_root, want_root) -> None:
    got, want = tree_listing(got_root), tree_listing(want_root)
    assert sorted(got) == sorted(want)
    for rel, entry in want.items():
        if rel.endswith(".pkl"):
            with open(os.path.join(got_root, rel), "rb") as f:
                a = pickle.load(f)
            with open(os.path.join(want_root, rel), "rb") as f:
                b = pickle.load(f)
            assert list(a) == list(b), rel
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (rel, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel} {k}")
        assert got[rel][0] == entry[0], rel
        if entry[0] == "file":
            assert got[rel][1] == entry[1], rel  # the pickles too, byte for byte
        elif entry[0] == "link":
            assert got[rel][1] == entry[1], rel


def both(raw, tmp_path, **kw):
    """Ingest `raw` with each package; returns (port's count, port root,
    h36x root)."""
    port, ref = tmp_path / "port", tmp_path / "h36x"
    n = ingest.ingest(str(raw), str(port), verbose=False, **kw)
    assert n == jax_ingest.ingest(str(raw), str(ref), verbose=False, **kw)
    return n, port, ref


def test_constants_are_h36x_s():
    for name in ("ACTION_NAMES", "SUBJECTS_ORDER", "H36M_CAMERA_SERIALS", "N_SUBJECTS",
                 "N_CAMS"):
        assert getattr(ingest, name) == getattr(jax_ingest, name), name
    from h36x.geometry.skeleton import H36M_RAW_JOINT_IDS as jax_ids

    assert H36M_RAW_JOINT_IDS == jax_ids
    angles = np.random.default_rng(0).normal(size=(5, 3))
    for a in angles:
        np.testing.assert_array_equal(rotation_matrix_xyz(a), jax_rotation(a))


def test_cameras_and_action_names_match_h36x(tmp_path, rng):
    _write_metadata_xml(tmp_path / "metadata.xml", rng)
    xml = str(tmp_path / "metadata.xml")
    for sbj, cam in ((1, 1), (3, 2), (11, 4)):
        for a, b in zip(ingest.read_cam_parameters(xml, sbj, cam),
                        jax_ingest.read_cam_parameters(xml, sbj, cam)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ingest.read_action_name(xml, 5, 1, 2) == "Seq_2_2_S5"
    assert ingest.read_action_name(xml, 1, 99, 1) is None


@pytest.mark.parametrize("is_3d, ext", [(False, "npz"), (True, "npz"), (True, "npy")])
def test_read_poses_matches_h36x(tmp_path, rng, is_3d, ext):
    flat = rng.normal(size=(1, 7, 32 * (3 if is_3d else 2))).astype(np.float64)
    if ext == "npz":
        np.savez_compressed(tmp_path / "seq.npz", Pose=flat)
    else:
        np.save(tmp_path / "seq.npy", flat)
    path = str(tmp_path / "seq.cdf")  # redirected to the sibling
    got = ingest.read_poses(path, is_3d=is_3d)
    want = jax_ingest.read_poses(path, is_3d=is_3d)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ingest.read_poses(path, is_3d=is_3d, n_frames=3),
                                  want[:3])


def test_cdf_without_spacepy_raises(tmp_path):
    (tmp_path / "x.cdf").write_bytes(b"notacdf")
    with pytest.raises(RuntimeError, match="spacepy"):
        ingest.read_poses(str(tmp_path / "x.cdf"))


def test_full_tree_is_h36x_s(raw_tree, tmp_path):  # noqa: F811
    n, port, ref = both(raw_tree, tmp_path, subjects=[1], actions=[1])
    assert n == 8
    assert_same_tree(port, ref)
    cam = port / "S1" / "Directions_1" / "cam_3"
    assert os.path.islink(cam / "S1_Directions_1_cam_3.mp4")
    assert (port / "S1" / "Directions_1" / "orig_seq_name.txt").read_text() == "Seq_2_2_S1"


def test_npz_only_tree_is_h36x_s(raw_tree, tmp_path):  # noqa: F811
    for cdf in raw_tree.rglob("*.cdf"):
        cdf.unlink()
    n, port, ref = both(raw_tree, tmp_path, subjects=[1], actions=[1])
    assert n == 8
    assert_same_tree(port, ref)


def test_interior_camera_gap_is_h36x_s(raw_tree, tmp_path):  # noqa: F811
    p2 = raw_tree / "S1" / "MyPoseFeatures" / "D2_Positions"
    for ext in ("cdf", "npz"):
        (p2 / f"Seq_2_1_S1.2.{ext}").unlink()
    n, port, ref = both(raw_tree, tmp_path, subjects=[1], actions=[1])
    assert n == 7
    assert_same_tree(port, ref)
    base = port / "S1" / "Directions_0"
    assert not (base / "cam_1" / "gt_poses.pkl").exists()
    with open(base / "cam_2" / "gt_poses.pkl", "rb") as f:
        got = pickle.load(f)
    src = np.load(p2 / "Seq_2_1_S1.3.npz")["Pose"]
    np.testing.assert_array_equal(
        got["2d"], src[0].reshape(-1, 32, 2)[:, np.asarray(H36M_RAW_JOINT_IDS)])


def test_absent_official_camera_shifts_no_serial(tmp_path, rng):
    """Official serials, camera 2's files all absent: cams 0, 2, 3 keep
    their own poses and calibration; no cam_1 directory."""
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_metadata_xml(raw / "metadata.xml", rng)
    seq = "Seq_2_1_S1"
    dirs = [raw / "S1" / d for d in ("Videos", "MyPoseFeatures/D2_Positions",
                                     "MyPoseFeatures/D3_Positions_mono")]
    for d in dirs:
        d.mkdir(parents=True)
    for i, serial in enumerate(ingest.H36M_CAMERA_SERIALS):
        if i == 1:
            continue
        (dirs[0] / f"{seq}.{serial}.mp4").write_bytes(b"fakemp4")
        np.savez_compressed(dirs[1] / f"{seq}.{serial}.npz",
                            Pose=rng.normal(size=(1, 10, 64)).astype(np.float32))
        np.savez_compressed(dirs[2] / f"{seq}.{serial}.npz",
                            Pose=rng.normal(size=(1, 10, 96)).astype(np.float32))
    n, port, ref = both(raw, tmp_path, subjects=[1], actions=[1], trials=(1,))
    assert n == 3
    assert_same_tree(port, ref)
    assert not (port / "S1" / "Directions_0" / "cam_1").exists()


def test_empty_subjects_means_nothing(raw_tree, tmp_path):  # noqa: F811
    out = tmp_path / "out"
    assert ingest.ingest(str(raw_tree), str(out), subjects=[], verbose=False) == 0
    assert ingest.ingest(str(raw_tree), str(out), subjects=[1], actions=[],
                         verbose=False) == 0
    assert not out.exists() or not any(out.iterdir())


def test_second_run_changes_nothing_and_repairs_a_dangling_link(raw_tree, tmp_path):  # noqa: F811
    out = tmp_path / "out"
    ingest.ingest(str(raw_tree), str(out), subjects=[1], actions=[1], verbose=False)
    cam = out / "S1" / "Directions_0" / "cam_0"
    stamps = {p: p.stat().st_mtime_ns for p in out.rglob("*.pkl")}
    link = cam / "S1_Directions_0_cam_0.mp4"
    target = os.readlink(link)
    link.unlink()
    os.symlink(str(tmp_path / "moved_away.mp4"), link)  # dangling
    assert ingest.ingest(str(raw_tree), str(out), subjects=[1], actions=[1],
                         verbose=False) == 8
    assert {p: p.stat().st_mtime_ns for p in out.rglob("*.pkl")} == stamps
    assert os.readlink(link) == target


def test_s11_phoning_2_is_skipped(tmp_path, rng):
    """A sequence named "Phoning 2" with every file present ingests for S1
    and is skipped for S11 (corrupt in the official release)."""
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_metadata_xml(raw / "metadata.xml", rng)
    xml = (raw / "metadata.xml").read_text()
    for sbj in (11, 1):
        xml = xml.replace(f"Seq_6_2_S{sbj}<", "Phoning 2<")
        base = raw / f"S{sbj}"
        for d, dim in (("MyPoseFeatures/D2_Positions", 64),
                       ("MyPoseFeatures/D3_Positions_mono", 96)):
            (base / d).mkdir(parents=True)
            np.savez_compressed(base / d / "Phoning 2.1.npz",
                                Pose=np.zeros((1, 4, dim), np.float32))
        (base / "Videos").mkdir()
        (base / "Videos" / "Phoning 2.1.mp4").write_bytes(b"fakemp4")
    (raw / "metadata.xml").write_text(xml)
    for sbj, cells in ((1, 1), (11, 0)):
        n, port, ref = both(raw, tmp_path / f"S{sbj}", subjects=[sbj], actions=[5],
                            trials=(2,))
        assert n == cells
        assert_same_tree(port, ref)


def test_cli_requires_dirs_and_runs(raw_tree, tmp_path, capsys):  # noqa: F811
    from h36x_torch.cli.ingest import main

    with pytest.raises(SystemExit):
        main([])
    assert main(["--source-dir", str(raw_tree), "--out-dir", str(tmp_path / "out"),
                 "--subjects", "1"]) == 8
    assert "ingested 8" in capsys.readouterr().out
    jax_ingest.ingest(str(raw_tree), str(tmp_path / "ref"), subjects=[1], verbose=False)
    assert_same_tree(tmp_path / "out", tmp_path / "ref")


def test_ingested_tree_feeds_the_ports_scan_clips(raw_tree, tmp_path):  # noqa: F811
    from h36x.data.clips import scan_clips as jax_scan_clips
    from h36x_torch.data.clips import scan_clips

    out = tmp_path / "out"
    ingest.ingest(str(raw_tree), str(out), subjects=[1], actions=[1], verbose=False)
    clips, _, _ = scan_clips(str(out), subjects=[1], seq_len=4, stride=1, frame_skip=2)
    want, _, _ = jax_scan_clips(str(out), subjects=[1], seq_len=4, stride=1, frame_skip=2)
    assert len(clips) == len(want) == 16
    for a, b in zip(clips, want):
        assert (a.video_path, a.subject, a.action, a.cam, a.start, a.end) == (
            b.video_path, b.subject, b.action, b.cam, b.start, b.end)
        np.testing.assert_array_equal(a.cam_params["f"], b.cam_params["f"])


# -- masks -------------------------------------------------------------------------


def _blobs(rng, n=3, side=40):
    """A stack of masks: a large blob moving a little and a small one."""
    out = np.zeros((n, side, side), bool)
    for i in range(n):
        y, x = 8 + i, 6 + 2 * i
        out[i, y:y + 15, x:x + 12] = True
        out[i, 30:33, 32:35] = True
    return out | (rng.random(out.shape) < 0.002)


def test_masks_match_h36x(rng):
    stack = _blobs(rng)
    box = masks.crop_from_silhouettes(stack)
    assert box == jax_masks.crop_from_silhouettes(stack)
    for mask in (stack[1], stack[1].astype(np.uint8) * 255):
        got = masks.clean_mask_to_crop(mask, *box)
        want = jax_masks.clean_mask_to_crop(mask, *box)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="empty"):
        masks.crop_from_silhouettes(np.zeros((1, 5, 5), bool))
    joints = rng.normal(size=(17, 3))
    for in_meter in (False, True):
        np.testing.assert_array_equal(
            masks.reroot_joints(joints, joints[3], in_meter),
            jax_masks.reroot_joints(joints, joints[3], in_meter))


def test_read_silhouettes_matches_h36x(tmp_path, rng):
    """A MATLAB-style .h5 (a `Masks` column of object references, each mask
    stored transposed as MATLAB does), read by both packages."""
    import h5py

    path = tmp_path / "masks.h5"
    stack = _blobs(rng, n=4).astype(np.uint8)
    with h5py.File(path, "w") as f:
        refs = f.create_dataset("Masks", (4, 1), dtype=h5py.ref_dtype)
        for i in range(4):
            refs[i, 0] = f.create_dataset(f"m{i}", data=stack[i].T).ref
    got, want = masks.read_silhouettes(str(path)), jax_masks.read_silhouettes(str(path))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)
    assert len(masks.read_silhouettes(str(path), n_frames=2)) == 2
