"""The port's tools against h36x's on the CPU, at small widths (latent 64,
feature 32, 2 blocks): the weight converters (models/torch_import.py), the
four cli.convert functions (stores and checkpoints byte for byte h36x's,
each package reading the other's), cli.parity's verdicts and exit codes in
batch mode and --full, cli.doctor --device cpu with h36x's exit codes,
show_batch writing a .gif, and the port's quickstart."""

import json
import os
import pathlib
import pickle
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.models.torch_import import convert_torch_phd as jax_convert_phd
from h36x.train.step import make_forward as jax_make_forward
from h36x_torch.models import torch_import
from tests.helpers import make_synthetic_store
from tests.test_phd_import import _fake_phd_state_dict
from tests.test_resnet import _fake_torchvision_state_dict

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=2)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def assert_trees_bit_for_bit(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


# -- the weight converters -------------------------------------------------------


def test_convert_torch_phd_matches_h36x_and_the_reference_module():
    """The reference's PHD (the torch module of tests/test_trajectory_parity.py)
    through both packages' converters, bit for bit; the port's forward on
    the converted params equals the reference module's at 1e-4."""
    from h36x_torch.infer import make_fused_forward
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
    from tests.test_trajectory_parity import TorchPHD, _to_reference_keys

    torch.manual_seed(0)
    ref = TorchPHD().float().eval()
    sd = _to_reference_keys(ref.state_dict())
    params = torch_import.convert_torch_phd(sd)
    assert_trees_bit_for_bit(params, jax_convert_phd(sd))
    assert torch_import.infer_model_config(params) == __import__(
        "h36x.models.torch_import", fromlist=["x"]).infer_model_config(params)

    back = torch_import.export_phd_to_torch(params)
    from h36x.models.torch_import import export_phd_to_torch as jax_export

    want = jax_export(jax_convert_phd(sd))
    assert back.keys() == want.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == want[k].dtype and back[k].tobytes() == want[k].tobytes(), k
        if k != "f_3D.y0":
            assert back[k].tobytes() == sd[k].tobytes(), k

    model = PHDFor3DJoints(**SMALL, device="cpu")
    model.load_state_dict(params_from_flax(params))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 6, 32)).astype(np.float32))
    got = make_fused_forward(param_tree(model), precise=True)(x)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), ref(x).numpy(), rtol=1e-4, atol=1e-4)

    with pytest.raises(KeyError):
        torch_import.convert_torch_phd({"f_movie.blocks.0.bogus.weight": np.zeros(3)})


def test_load_torch_phd_reads_the_model_key(tmp_path, rng):
    sd = _fake_phd_state_dict(rng, latent=64, feature=32)
    path = tmp_path / "best.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, path)
    assert_trees_bit_for_bit(torch_import.load_torch_phd(path), jax_convert_phd(sd))


def test_convert_torch_resnet50_matches_h36x(tmp_path, rng):
    from h36x.models.torch_import import convert_torch_resnet50 as jax_convert

    sd = _fake_torchvision_state_dict(rng)
    sd["fc.weight"] = np.zeros((10, 2048), np.float32)
    want = jax_convert(sd)
    assert_trees_bit_for_bit(torch_import.convert_torch_resnet50(sd), want)
    path = tmp_path / "resnet50.pt"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}},
               path)
    assert_trees_bit_for_bit(torch_import.load_torch_resnet50(path), want)
    with pytest.raises(KeyError):
        torch_import.convert_torch_resnet50({"conv1.weight": sd["conv1.weight"]})


# -- cli.convert ------------------------------------------------------------------


def _bytes(path):
    return pathlib.Path(path).read_bytes()


def test_convert_checkpoints_byte_for_byte_and_read_across(tmp_path, rng):
    from h36x.cli import convert as jax_convert
    from h36x.train.checkpoint import load_params_only as jax_load
    from h36x_torch.cli import convert
    from h36x_torch.models.phd import PHDFor3DJoints
    from h36x_torch.train.checkpoint import load_params_only

    sd = _fake_phd_state_dict(rng, latent=64, feature=32)
    ckpt = tmp_path / "best.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    convert.main(["--torch-ckpt", str(ckpt), "--out", str(tmp_path / "p"), "--name", "best",
                  "--groups", "16"])
    jax_convert.main(["--torch-ckpt", str(ckpt), "--out", str(tmp_path / "j"),
                      "--name", "best", "--groups", "16"])
    for name in ("best.msgpack", "best.json"):
        assert _bytes(tmp_path / "p" / name) == _bytes(tmp_path / "j" / name), name
    assert json.loads(_bytes(tmp_path / "p" / "best.json"))["config"]["model"]["groups"] == 16

    # each package reads the other's
    model = PHDFor3DJoints(**SMALL, groups=16, device="cpu")
    port_read = load_params_only(tmp_path / "j" / "best.msgpack", model.state_dict())
    template = jax.device_get(FlaxPHD(**SMALL).init(jax.random.key(0),
                                                    jnp.zeros((1, 4, 32)))["params"])
    jax_read = jax_load(str(tmp_path / "p" / "best.msgpack"), template)
    assert_trees_bit_for_bit(jax.tree.map(np.asarray, jax_read), jax_convert_phd(sd))
    from h36x_torch.models.phd import params_from_flax

    want = params_from_flax(jax_convert_phd(sd))
    assert all(torch.equal(port_read[k], want[k]) for k in want)

    # and back to the reference's state_dict
    # (one file name: the zip archive's records are named after it)
    convert.main(["--to-torch-ckpt", str(tmp_path / "j" / "best.msgpack"),
                  "--out", str(tmp_path / "p" / "back.pt")])
    jax_convert.main(["--to-torch-ckpt", str(tmp_path / "p" / "best.msgpack"),
                      "--out", str(tmp_path / "j" / "back.pt")])
    assert _bytes(tmp_path / "p" / "back.pt") == _bytes(tmp_path / "j" / "back.pt")
    back = torch.load(tmp_path / "p" / "back.pt", weights_only=True)
    assert back.keys() == sd.keys()
    assert all(back[k].numpy().tobytes() == sd[k].tobytes() for k in sd if k != "f_3D.y0")


def test_to_torch_ckpt_refuses_an_orbax_directory(tmp_path):
    """Refused before the port read orbax; now `--to-torch-ckpt` of an orbax
    save (its `outdir/last` reference) gives the bytes it gives for a
    msgpack save of the same params."""
    from h36x_torch.cli import convert
    from h36x_torch.models.phd import PHDFor3DJoints
    from h36x_torch.train import checkpoint
    from h36x_torch.train.state import make_optimizer

    model = PHDFor3DJoints(**SMALL, device="cpu")
    opt, _ = make_optimizer(model, 1e-3)
    checkpoint.save_checkpoint_orbax(tmp_path / "o", "last", model, opt, 0, 1.0, 0)
    checkpoint.save_checkpoint(tmp_path / "m", "last", model, opt, 0, 1.0, 0)
    outs = []
    for ref in (tmp_path / "o" / "last", tmp_path / "m" / "last.msgpack"):
        out = ref.parent / "sd" / "best.pt"  # one file name: zip records carry it
        convert.main(["--to-torch-ckpt", str(ref), "--out", str(out)])
        outs.append(_bytes(out))
    assert outs[0] == outs[1]
    with pytest.raises(SystemExit, match="provide"):
        convert.main(["--out", str(tmp_path)])


def test_convert_shard_stores_byte_for_byte_and_read_across(tmp_path):
    from h36x.cli import convert as jax_convert
    from h36x.data.features import FeatureClipDataset as JaxDataset
    from h36x_torch.cli import convert
    from h36x_torch.data.features import FeatureClipDataset

    store = tmp_path / "store"
    store.mkdir()
    make_synthetic_store(store, n_shards=2, clips_per_shard=3, n_vars=2, seq_len=4,
                         feat_dim=8, subjects=(1, 5))
    convert.export_shard_store(str(store), str(tmp_path / "pt_p"))
    jax_convert.export_shard_store(str(store), str(tmp_path / "pt_j"))
    assert _bytes(tmp_path / "pt_p" / "index.pt") == _bytes(tmp_path / "pt_j" / "index.pt")
    for sid in range(2):
        # the legacy format names storages by their address: equal content
        a, b = (torch.load(tmp_path / d / f"shard_{sid:05d}.pt", weights_only=True)
                for d in ("pt_p", "pt_j"))
        assert a.keys() == b.keys() and a["meta"] == b["meta"] and a["n_vars"] == b["n_vars"]
        assert all(torch.equal(a[k], b[k]) for k in ("feats", "joints3d", "joints2d", "K"))

    convert.main(["--torch-shards", str(tmp_path / "pt_j"), "--out", str(tmp_path / "h_p")])
    jax_convert.main(["--torch-shards", str(tmp_path / "pt_p"), "--out",
                      str(tmp_path / "h_j")])
    names = sorted(os.listdir(tmp_path / "h_j"))
    assert names == sorted(os.listdir(tmp_path / "h_p")) == sorted(os.listdir(store))
    for name in names:
        assert _bytes(tmp_path / "h_p" / name) == _bytes(tmp_path / "h_j" / name), name
        if name.endswith(".h36x"):  # the index drops the shuffle record, as h36x's
            assert _bytes(tmp_path / "h_p" / name) == _bytes(store / name), name

    # each package reads the other's torch store
    rows = [0, 3, 5]
    want = JaxDataset(store, augment=True).get_batch(rows)
    for got in (FeatureClipDataset(tmp_path / "pt_j", augment=True).get_batch(rows),
                JaxDataset(tmp_path / "pt_p", augment=True).get_batch(rows)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- cli.parity ---------------------------------------------------------------------


@pytest.fixture
def parity_artifacts(tmp_path, rng):
    """A reference checkpoint and an NPZ whose predictions are h36x's on it."""
    sd = _fake_phd_state_dict(rng, latent=64, feature=32)
    ckpt = tmp_path / "best.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, ckpt)
    feats = rng.normal(size=(2, 6, 32)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, jax_convert_phd(sd))
    pred = np.asarray(jax_make_forward(FlaxPHD(**SMALL))(params, jnp.asarray(feats)))
    npz = tmp_path / "debug_batch.npz"
    np.savez_compressed(npz, video=feats, joints3d=rng.normal(size=(2, 6, 17, 3)) * 0.1,
                        predicted3djoints=pred, meta=np.array([{}, {}], dtype=object))
    return npz, ckpt


PARITY_FLAGS = ["--latent-dim", "64", "--num-blocks", "2", "--device", "cpu"]


def test_parity_pass_and_fail_exit_codes(parity_artifacts, tmp_path, capsys):
    from h36x_torch.cli import convert, parity

    npz, ckpt = parity_artifacts
    parity.main(["--npz", str(npz), "--torch-ckpt", str(ckpt), *PARITY_FLAGS])
    out = capsys.readouterr().out
    assert "mpjpe" in out and "-> PASS" in out

    # --ckpt: the converted checkpoint, its architecture from the manifest
    convert.main(["--torch-ckpt", str(ckpt), "--out", str(tmp_path / "runs")])
    parity.main(["--npz", str(npz), "--ckpt", str(tmp_path / "runs" / "best.msgpack"),
                 "--device", "cpu"])
    assert "-> PASS" in capsys.readouterr().out

    data = dict(np.load(npz, allow_pickle=True))
    data["predicted3djoints"] = data["predicted3djoints"] + 0.05  # 50 mm off
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, **data)
    with pytest.raises(SystemExit) as e:
        parity.main(["--npz", str(bad), "--torch-ckpt", str(ckpt), *PARITY_FLAGS])
    assert e.value.code == 1 and "-> FAIL" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="provide --torch-ckpt or --ckpt"):
        parity.main(["--npz", str(npz), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parity.main(["--npz", str(npz), "--torch-ckpt", str(ckpt)])


def test_parity_full_chain(tmp_path, rng, capsys):
    """--full on a cv2-written tree (two cameras with the same (subject,
    action, start), as tests/test_parity_cli.py): extraction, the lookup by
    camera, GT delta 0, then PASS against the reference module's
    predictions on the extracted features, the store reused."""
    cv2 = pytest.importorskip("cv2")
    from h36x_torch.cli import parity
    from h36x_torch.data.features import FeatureClipDataset

    h = w = 48
    n_frames = 24
    root = tmp_path / "ingested"
    j3d = None
    for cam in ("cam_0", "cam_1"):
        cam_dir = root / "S1" / "Walking_0" / cam
        cam_dir.mkdir(parents=True)
        vw = cv2.VideoWriter(str(cam_dir / "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (w, h))
        for _ in range(n_frames):
            vw.write(rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
        vw.release()
        cam_j3d = rng.normal(size=(n_frames, 17, 3)).astype(np.float32) * 100
        cam_j2d = (rng.random((n_frames, 17, 2)) * 30 + 9).astype(np.float32)
        j3d = cam_j3d if cam == "cam_0" else j3d
        with open(cam_dir / "gt_poses.pkl", "wb") as f:
            pickle.dump({"2d": cam_j2d, "3d": cam_j3d}, f)
        with open(cam_dir / "camera_wext.pkl", "wb") as f:
            pickle.dump({"f": np.array([90.0, 90.0]), "c": np.array([24.0, 24.0]),
                         "k": np.zeros(5), "rt": np.eye(3), "t": np.zeros(3)}, f)
    resnet = tmp_path / "resnet50.pt"
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in _fake_torchvision_state_dict(rng).items()}, resnet)
    # the reference's PHD module, its predictions the NPZ's (as a reference
    # results dump holds them)
    from tests.test_trajectory_parity import TorchPHD, _to_reference_keys

    torch.manual_seed(1)
    ref = TorchPHD(latent=64, feature=2048, number_blocks=1).eval()
    phd = tmp_path / "best.pt"
    torch.save({"model": {k: torch.from_numpy(v)
                          for k, v in _to_reference_keys(ref.state_dict()).items()}}, phd)
    meta, gts = [], []
    for start in (0, 2):
        meta.append({"subject": 1, "action": "Walking_0", "cam": "cam_0", "start": start})
        gts.append(j3d[np.arange(start, start + 6) * 2] / 1000.0)
    npz = tmp_path / "reference_batch.npz"
    np.savez_compressed(npz, joints3d=np.stack(gts), meta=np.array(meta, dtype=object))
    argv = ["--full", "--npz", str(npz), "--resnet-state-dict", str(resnet),
            "--clips-root", str(root), "--torch-ckpt", str(phd),
            "--workdir", str(tmp_path / "work"), "--stride", "2", "--resize", "32",
            "--batch-size", "2", "--num-workers", "2", "--latent-dim", "64",
            "--num-blocks", "1", "--device", "cpu"]
    parity.main(argv)
    out = capsys.readouterr().out
    assert "extracting features" in out
    assert "GT-joints delta store-vs-npz: 0.0000 mm" in out
    assert "prediction-delta check skipped" in out

    store = FeatureClipDataset(tmp_path / "work" / "features", test_set=True)
    by_key = {(c["subject"], c["start"], c["cam"]): i for i, (c, _) in enumerate(store.items)}
    feats = store.get_batch([by_key[(1, 0, "cam_0")], by_key[(1, 2, "cam_0")]])[0]
    with torch.no_grad():
        pred = ref(torch.from_numpy(feats)).numpy()
    np.savez_compressed(npz, joints3d=np.stack(gts), meta=np.array(meta, dtype=object),
                        predicted3djoints=pred)
    parity.main(argv)
    out = capsys.readouterr().out
    assert "reusing existing feature store" in out and "-> PASS" in out


# -- cli.doctor ------------------------------------------------------------------------


def _doctor_both(argv, capsys):
    """(port's exit, its output, h36x's exit) on the same flags: exit None
    when main returned, else the SystemExit's message."""
    from h36x.cli.doctor import main as jax_main
    from h36x_torch.cli.doctor import main

    results = []
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        try:
            fn(argv + extra)
            results.append(None)
        except SystemExit as e:
            results.append(str(e.code))
        results.append(capsys.readouterr().out)
    return results[0], results[1], results[2]


def test_doctor_env_only(capsys):
    from h36x_torch.cli.doctor import main

    code, out, jax_code = _doctor_both([], capsys)
    assert code is None and jax_code is None
    assert "[ok] cuda" in out and "[ok] hopper kernels: skipped (cpu)" in out
    assert "all required checks passed" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda, hopper kernels"):
            main([])


def test_doctor_store_ckpt_and_bad_paths_match_h36x(tmp_path, capsys):
    store = tmp_path / "store"
    store.mkdir()
    make_synthetic_store(store, n_shards=2, clips_per_shard=4, n_vars=1, seq_len=6,
                         feat_dim=16, subjects=(1,))
    code, out, jax_code = _doctor_both(["--root", str(store), "--verify-store", str(store)],
                                       capsys)
    assert code is None and jax_code is None
    assert "shard 0 reads ok" in out and "arrays CRC-verified" in out

    (tmp_path / "best.msgpack").write_bytes(b"\x00" * 128)
    (tmp_path / "best.json").write_text(json.dumps(
        {"converted_from": "ref/last.pt", "format": "torch"}))
    code, out, jax_code = _doctor_both(["--ckpt", str(tmp_path / "best.msgpack")], capsys)
    assert code is None and jax_code is None
    assert "converted from ref/last.pt (torch)" in out

    (store / "shard_00001.h36x").unlink()
    for argv in (["--root", str(store)], ["--ckpt", str(tmp_path / "nope.msgpack")]):
        code, out, jax_code = _doctor_both(argv, capsys)
        assert code is not None and "problems" in code and jax_code is not None, argv
        assert "[FAIL]" in out

    # an orbax run: both doctors pass it, the port's after reading every array
    from h36x_torch.models.phd import PHDFor3DJoints
    from h36x_torch.train import checkpoint
    from h36x_torch.train.state import make_optimizer

    orbax = tmp_path / "orbax_run"
    model = PHDFor3DJoints(**SMALL, device="cpu")
    checkpoint.save_checkpoint_orbax(orbax, "last", model, make_optimizer(model, 1e-3)[0],
                                     1, 0.5, 3)
    code, out, jax_code = _doctor_both(["--ckpt", str(orbax)], capsys)
    assert code is None and jax_code is None
    assert "last: epoch 1, step 3" in out and "orbax last.0" in out


def test_doctor_checks_an_artifact(tmp_path, capsys):
    from h36x_torch.cli.doctor import main
    from h36x_torch.export import export_forward, save_artifact
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree

    model = PHDFor3DJoints(latent_dim=32, feature_dim=16, number_blocks=1, groups=8,
                           regressor_hidden=32, device="cpu")
    blob = export_forward(param_tree(model), seq_len=4, feature_dim=16, groups=8,
                          platforms=("cpu",))
    path = save_artifact(blob, tmp_path / "phd.pt2")
    import hashlib

    side = pathlib.Path(str(path) + ".json")
    side.write_text(json.dumps({"sha256": hashlib.sha256(blob).hexdigest(),
                                "nbytes": len(blob)}))
    main(["--artifact", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sha256 verified" in out and "platforms ['cpu']" in out
    side.write_text(json.dumps({"sha256": "0" * 64}))
    with pytest.raises(SystemExit, match="artifact"):
        main(["--artifact", str(path), "--device", "cpu"])
    assert "sha256 mismatch" in capsys.readouterr().out


def test_doctor_dedup_estimate_matches_h36x(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for action in ("Walking_0", "Eating_0"):
        cam_dir = tmp_path / "S1" / action / "cam_0"
        cam_dir.mkdir(parents=True)
        (cam_dir / "video.mp4").write_bytes(b"")
        j2d = np.tile((rng.random((1, 17, 2)) * 40 + 12).astype(np.float32), (40, 1, 1))
        with open(cam_dir / "gt_poses.pkl", "wb") as f:
            pickle.dump({"2d": j2d, "3d": rng.normal(size=(40, 17, 3)).astype(np.float32)}, f)
        with open(cam_dir / "camera_wext.pkl", "wb") as f:
            pickle.dump({"f": np.array([90.0, 90.0]), "c": np.array([30.0, 33.0]),
                         "k": np.zeros(5), "rt": np.eye(3), "t": np.zeros(3)}, f)
    code, out, jax_code = _doctor_both(["--dedup-estimate", str(tmp_path), "--seq-len", "8",
                                        "--stride", "2", "--frame-skip", "2"], capsys)
    assert code is None and jax_code is None
    line = [ln for ln in out.splitlines() if "dedup estimate" in ln]
    assert len(line) == 1 and "14 clips / 2 videos" in line[0]
    assert "unique (frame, box) = 40/112" in line[0] and "~1.75x device dedup" in line[0]


# -- show_batch and the quickstart -----------------------------------------------------


def test_show_batch_writes_a_gif(tmp_path, rng, capsys):
    import matplotlib

    matplotlib.use("Agg")
    from h36x_torch.cli.show_batch import main

    j3d = rng.normal(size=(2, 4, 17, 3)).astype(np.float32)
    j3d[..., 2] += 4.0
    npz = tmp_path / "b.npz"
    np.savez(npz, predicted3djoints=j3d, joints3d=j3d,
             joints2d=rng.random((2, 4, 17, 2)).astype(np.float32) * 100,
             cam_K=np.tile(np.diag([100.0, 100.0, 1.0]), (2, 1, 1)))
    for mode in ("reproject", "video3d"):
        gif = tmp_path / f"{mode}.gif"
        main([str(npz), "--mode", mode, "--save", str(gif), "--fps", "5"])
        assert gif.stat().st_size > 0 and _bytes(gif)[:3] == b"GIF"
    assert "model prediction" in capsys.readouterr().out


def test_quickstart_torch_runs_on_the_cpu(capsys):
    path = ROOT / "examples" / "quickstart_torch.py"
    main = runpy.run_path(str(path))["main"]
    main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "best val MPJPE" in out and "AR 5-step forecast: (5, 17, 3)" in out
    assert "batch rollout: (1, 5, 17, 3)" in out
