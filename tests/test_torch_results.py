"""h36x_torch's results stage against h36x's on the CPU: `evaluate_test` on
the same store and params (a short tail batch included), the video helpers,
`dump_debug_batch` and `dump_result_batch` field for field, and the
`cli.results` / `cli.debug_batch` entry points on the ingested tree of
tests/test_full_pipeline.py (mp4 clips decoded with OpenCV by both
packages). Small sizes: latent 64, feature 32, one block, T 8. Metrics and
predictions agree within rtol 1e-4 / atol 1e-5 (the forward tolerance of
tests/test_serve.py); everything read from the store is equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from h36x.cli.debug_batch import main as jax_debug_main
from h36x.cli.results import main as jax_results_main
from h36x.data import shards as jax_shards
from h36x.data.features import FeatureClipDataset as JaxDataset
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train import checkpoint as jax_ckpt
from h36x.train import results as jax_results
from h36x.train.losses import mpjpe, mse3d
from h36x.train.state import create_train_state, make_optimizer
from h36x_torch.cli.debug_batch import main as debug_main
from h36x_torch.cli.results import main as results_main
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.infer import make_fused_forward
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
from h36x_torch.train import results
from tests.helpers import make_synthetic_store
from tests.test_full_pipeline import ingested_tree  # noqa: F401  (a fixture)

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(latent_dim=64, feature_dim=32, number_blocks=1)
T = 8


@pytest.fixture(scope="module")
def flax_state():
    model = FlaxPHD(**ARCH)
    optimizer, _ = make_optimizer(lr=1e-3)
    state = jax.jit(lambda key, x: create_train_state(model, optimizer, key, x))(
        jax.random.key(0), jnp.zeros((1, T, 32)))
    return model, state


@pytest.fixture(scope="module")
def port_model(flax_state):
    model = PHDFor3DJoints(**ARCH, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(flax_state[1].params))))
    return model


@pytest.fixture
def store(tmp_path):
    """10 clips of subject 9: batch 4 leaves a tail of 2."""
    root = tmp_path / "store"
    root.mkdir()
    make_synthetic_store(root, n_shards=1, clips_per_shard=10, n_vars=1,
                         seq_len=T, feat_dim=32, subjects=(9,))
    return root


def _write_tree_store(root, rng, clips=4):
    """A feature store whose rows point into the ingested tree (subject 9,
    Posing_0, cam_0: 20 subsampled frames at skip 2)."""
    root.mkdir()
    arrays = {
        "feats": rng.normal(size=(clips, T, 32)).astype(np.float32),
        "joints3d": rng.normal(size=(clips, T, 17, 3)).astype(np.float32) * 1000,
        "joints2d": rng.normal(size=(clips, T, 17, 2)).astype(np.float32) * 100,
        "K": np.tile(np.eye(3, dtype=np.float32) * 1000, (clips, 1, 1)),
    }
    rows = [{"subject": 9, "action": "Posing_0", "cam": "cam_0", "start": 4 * c,
             "end": 4 * c + T} for c in range(clips)]
    meta = [{**r, "aug": "orig", "frame_skip": 2} for r in rows]
    jax_shards.write_shard(jax_shards.shard_path(root, 0), arrays, meta, 1)
    jax_shards.write_index(
        root, [{"shard_id": 0, "row": c, **r} for c, r in enumerate(rows)],
        n_shards=1, n_clips=clips, n_variants=1, aug_names=["orig"], seq_len=T,
        frame_skip=2, feat_dtype="float32")
    return root


# -- evaluate_test ----------------------------------------------------------------


def test_evaluate_test_matches_h36x_with_short_tail(store, flax_state, port_model):
    flax_model, state = flax_state
    want = jax_results.evaluate_test(
        flax_model, state.params, JaxDataset(str(store), subjects=[9], test_set=True),
        batch_size=4)
    ds = FeatureClipDataset(store, subjects=[9], test_set=True)
    assert len(ds) == 10
    got = results.evaluate_test(port_model, ds, batch_size=4)
    assert got[2] == got[0] and got[3] == 0.0
    np.testing.assert_allclose(got[:3], want[:3], **TOL)
    # and the exact dataset mean of one forward over all 10 rows
    feats, j3d, _, _, _ = ds.get_batch(list(range(10)))
    pred = flax_model.apply({"params": state.params}, jnp.asarray(feats))[2]
    np.testing.assert_allclose(got[0], float(mse3d(pred, jnp.asarray(j3d))), rtol=1e-5)
    np.testing.assert_allclose(got[1], float(mpjpe(pred, jnp.asarray(j3d))), rtol=1e-5)


def test_evaluate_test_plain_equals_kernels_flag_on_the_cpu(store, port_model):
    ds = FeatureClipDataset(store, subjects=[9], test_set=True)
    assert (results.evaluate_test(port_model, ds, 4, use_kernels=False)
            == results.evaluate_test(port_model, ds, 4, use_kernels=True))


def test_evaluate_test_mesh_raises(store, flax_state, port_model):
    """evaluate_test(mesh=) runs (it raised before the mesh was ported):
    over 4 virtual CPU devices, the tail of 2 rows padded to 4 with weight 0,
    it equals the one-device metrics at rtol 1e-6, and h36x's over its own
    4-device mesh at TOL (tests/test_torch_mesh.py holds more cases)."""
    from h36x.parallel.mesh import make_mesh as jax_make_mesh
    from h36x_torch.parallel.mesh import make_mesh

    ds = FeatureClipDataset(store, subjects=[9], test_set=True)
    want = results.evaluate_test(port_model, ds, 4)
    got = results.evaluate_test(port_model, ds, 4, mesh=make_mesh(4, devices=["cpu"] * 4))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert port_model.tp is None
    flax_model, state = flax_state
    jax_got = jax_results.evaluate_test(
        flax_model, state.params, JaxDataset(str(store), subjects=[9], test_set=True),
        batch_size=4, mesh=jax_make_mesh(data=4, model=1, devices=jax.devices()[:4]))
    np.testing.assert_allclose(got[:3], jax_got[:3], **TOL)


# -- video helpers ------------------------------------------------------------------


def test_pad_or_trim_matches_h36x(rng):
    v = rng.integers(0, 255, size=(5, 4, 4, 3)).astype(np.uint8)
    assert results.pad_or_trim_video(v, 5) is v
    for target in (3, 5, 8):
        got = results.pad_or_trim_video(v, target)
        np.testing.assert_array_equal(got, jax_results.pad_or_trim_video(v, target))
    np.testing.assert_array_equal(results.pad_or_trim_video(v, 8)[5], v[-1])


def test_resize_matches_h36x(rng):
    v = rng.integers(0, 255, size=(2, 32, 32, 3)).astype(np.uint8)
    out = results.resize_video_hw(v, 16)
    assert out.shape == (2, 16, 16, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jax_results.resize_video_hw(v, 16))
    assert results.resize_video_hw(v, None) is v


def test_find_video_path(tmp_path):
    d = tmp_path / "S9" / "Walking_0" / "cam_0"
    d.mkdir(parents=True)
    (d / "S9_Walking_0_cam_0.mp4").write_bytes(b"x")
    for cam in ("cam_0", "0"):
        meta = {"subject": 9, "action": "Walking_0", "cam": cam}
        assert (results.find_video_path(str(tmp_path), meta)
                == jax_results.find_video_path(str(tmp_path), meta))
    with pytest.raises(FileNotFoundError):
        results.find_video_path(str(tmp_path), {"subject": 1, "action": "X", "cam": "0"})


# -- the NPZ dumps ------------------------------------------------------------------


def _assert_npz_equal(got, want, close=()):
    assert set(got.files) == set(want.files)
    for name in want.files:
        if name == "meta":
            assert list(got[name]) == list(want[name])
        elif name in close:
            assert got[name].shape == want[name].shape
            np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=name)
        else:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_dump_debug_batch_field_for_field(store, tmp_path):
    jax_results.dump_debug_batch(JaxDataset(str(store), subjects=[9], test_set=True),
                                 str(tmp_path / "jax.npz"), batch_size=4)
    payload = results.dump_debug_batch(
        FeatureClipDataset(store, subjects=[9], test_set=True),
        str(tmp_path / "torch.npz"), batch_size=4)
    got = np.load(tmp_path / "torch.npz", allow_pickle=True)
    assert set(got.files) == set(payload) == {"video", "joints3d", "joints2d", "cam_K",
                                               "meta"}
    assert got["joints3d"].shape == (4, T, 17, 3) and got["cam_K"].shape == (4, 3, 3)
    assert isinstance(got["meta"][0], dict)
    _assert_npz_equal(got, np.load(tmp_path / "jax.npz", allow_pickle=True))
    with pytest.raises(ValueError, match="test_set=True"):
        results.dump_debug_batch(FeatureClipDataset(store, subjects=[9]),
                                 str(tmp_path / "x.npz"))


@pytest.mark.parametrize("fused", [False, True])
def test_dump_result_batch_field_for_field(ingested_tree, tmp_path, rng, flax_state,  # noqa: F811
                                           port_model, fused):
    pytest.importorskip("cv2")
    flax_model, state = flax_state
    store = _write_tree_store(tmp_path / "tree_store", rng)
    kw = dict(seq_len=T, batch_size=3, save_n=2, video_size=16,
              test_metrics=(0.5, 0.25, 0.5, 0.0))
    jax_results.dump_result_batch(
        flax_model, state.params, JaxDataset(str(store), subjects=[9], test_set=True),
        str(ingested_tree), str(tmp_path / "jax.npz"), **kw)
    forward_fn = (make_fused_forward(param_tree(port_model), groups=port_model.groups,
                                     precise=True) if fused else None)
    payload = results.dump_result_batch(
        port_model, FeatureClipDataset(store, subjects=[9], test_set=True),
        str(ingested_tree), str(tmp_path / "torch.npz"), forward_fn=forward_fn, **kw)
    got = np.load(tmp_path / "torch.npz", allow_pickle=True)
    assert set(got.files) == set(payload) == {
        "video", "joints3d", "predicted3djoints", "joints2d", "K", "meta", "test_metrics"}
    assert got["video"].shape == (2, T, 16, 16, 3) and got["video"].dtype == np.uint8
    assert got["predicted3djoints"].dtype == np.float32
    _assert_npz_equal(got, np.load(tmp_path / "jax.npz", allow_pickle=True),
                      close=("predicted3djoints",))


def test_dump_result_batch_uses_the_stores_seq_len(ingested_tree, tmp_path, rng,  # noqa: F811
                                                   port_model, capsys):
    pytest.importorskip("cv2")
    store = _write_tree_store(tmp_path / "tree_store", rng)
    ds = FeatureClipDataset(store, subjects=[9], test_set=True)
    payload = results.dump_result_batch(port_model, ds, str(ingested_tree),
                                        str(tmp_path / "a.npz"), seq_len=5, save_n=1,
                                        video_size=None)
    assert "WARNING: requested seq_len 5" in capsys.readouterr().out
    assert payload["video"].shape == (1, T, 64, 64, 3)
    with pytest.raises(ValueError, match="test_set=True"):
        results.dump_result_batch(port_model, FeatureClipDataset(store, subjects=[9]),
                                  str(ingested_tree), str(tmp_path / "b.npz"), seq_len=T)


# -- the CLIs -----------------------------------------------------------------------


@pytest.fixture
def tree_run(ingested_tree, tmp_path, rng, flax_state):  # noqa: F811
    """(store pointing into the ingested tree, h36x checkpoint with manifest)."""
    pytest.importorskip("cv2")
    store = _write_tree_store(tmp_path / "tree_store", rng)
    cfg = {"model": {"latent_dim": 64, "feature_dim": 32, "num_blocks": 1},
           "data": {"seq_len": T}}
    jax_ckpt.save_checkpoint(tmp_path / "runs", "best", flax_state[1], 0, 1.0, cfg)
    return ingested_tree, store, tmp_path / "runs" / "best.msgpack"


@pytest.mark.parametrize("fused", [False, True])
def test_results_cli_matches_h36x(tree_run, tmp_path, capsys, fused):
    tree, store, ckpt_path = tree_run
    argv = ["--features-root", str(store), "--preprocessed-root", str(tree),
            "--model-path", str(ckpt_path), "--batch-size", "3", "--save-n", "2",
            "--video-size", "32", "--subjects", "9"] + (["--fused"] if fused else [])
    # h36x's --fused dump is its Pallas path, which runs only on a TPU: its
    # plain dump is the same function and stands in for it here
    jax_results_main([*[a for a in argv if a != "--fused"],
                      "--out", str(tmp_path / "jax.npz")])
    jax_line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("Test metrics")]
    results_main([*argv, "--out", str(tmp_path / "torch.npz"), "--device", "cpu"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("Test metrics")]
    assert "Model config from checkpoint manifest" in out
    assert f"[OK] Saved batch to: {tmp_path / 'torch.npz'}" in out
    # the same metrics line, number for number at the printed precision
    assert len(line) == len(jax_line) == 1
    got_nums = [float(tok) for tok in line[0].replace("|", " ").split()
                if tok.replace(".", "").isdigit()]
    want_nums = [float(tok) for tok in jax_line[0].replace("|", " ").split()
                 if tok.replace(".", "").isdigit()]
    assert len(got_nums) == 5  # loss, mpjpe m, mpjpe mm, l3d, and "0.0" of the l2d note
    np.testing.assert_allclose(got_nums, want_nums, rtol=1e-4, atol=2e-2)
    assert line[0].split("|")[0] == jax_line[0].split("|")[0]
    assert line[0].endswith("| l2d: n/a (not computed; NPZ stores 0.0 for field parity)")
    got = np.load(tmp_path / "torch.npz", allow_pickle=True)
    assert got["video"].shape == (2, T, 32, 32, 3)
    assert np.isfinite(got["test_metrics"]).all()
    _assert_npz_equal(got, np.load(tmp_path / "jax.npz", allow_pickle=True),
                      close=("predicted3djoints", "test_metrics"))


def test_results_cli_refusals(tree_run, tmp_path):
    tree, store, ckpt_path = tree_run
    argv = ["--features-root", str(store), "--preprocessed-root", str(tree),
            "--out", str(tmp_path / "x.npz")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        results_main([*argv, "--model-path", str(ckpt_path)])
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        results_main([*argv, "--model-path", str(tmp_path / "nope.msgpack"),
                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="contradict"):
        results_main([*argv, "--model-path", str(ckpt_path), "--latent-dim", "128",
                      "--device", "cpu"])


def test_debug_batch_cli_matches_h36x(tree_run, tmp_path, capsys):
    _, store, _ = tree_run
    jax_debug_main(["--root", str(store), "--out", str(tmp_path / "jax.npz"),
                    "--batch-size", "3"])
    want_out = capsys.readouterr().out.replace("jax.npz", "X.npz")
    debug_main(["--root", str(store), "--out", str(tmp_path / "torch.npz"),
                "--batch-size", "3"])
    assert capsys.readouterr().out.replace("torch.npz", "X.npz") == want_out
    _assert_npz_equal(np.load(tmp_path / "torch.npz", allow_pickle=True),
                      np.load(tmp_path / "jax.npz", allow_pickle=True))
