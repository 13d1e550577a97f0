"""h36x_torch.cli.predict against h36x.cli.predict on the CPU: one synthetic
feature store and one h36x msgpack checkpoint (with its manifest) go through
both CLIs in the three modes (batch rollout, streaming with and without
freeze plus a forecast, plain forward); the NPZs must hold the same fields,
equal `joints3d` and `meta`, and predictions within rtol 1e-3 / atol 1e-4
(the rollout tolerance of tests/test_torch_rollout.py). Small sizes: latent
64, feature 32, one block, G 8, T 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from h36x.cli.predict import main as jax_predict_main
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train import checkpoint as jax_ckpt
from h36x.train.state import create_train_state, make_optimizer
from h36x_torch.cli.predict import main as predict_main
from tests.helpers import make_synthetic_store

TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def store_and_ckpt(tmp_path_factory):
    """A 6-clip test-subject store and an h36x checkpoint whose manifest
    records the non-default architecture (as h36x's trainer writes it)."""
    root = tmp_path_factory.mktemp("predict")
    store = root / "store"
    store.mkdir()
    make_synthetic_store(store, n_shards=1, clips_per_shard=6, n_vars=1,
                         seq_len=8, feat_dim=32, subjects=(9,))
    model = FlaxPHD(latent_dim=64, feature_dim=32, joints_num=17,
                    number_blocks=1, groups=8)
    optimizer, _ = make_optimizer(lr=1e-3)
    state = jax.jit(lambda key, x: create_train_state(model, optimizer, key, x))(
        jax.random.key(0), jnp.zeros((1, 8, 32)))
    cfg = {"model": {"latent_dim": 64, "feature_dim": 32, "num_blocks": 1,
                     "groups": 8},
           "data": {"seq_len": 8}}
    jax_ckpt.save_checkpoint(root, "best", state, 0, 1.0, cfg)
    return store, root / "best.msgpack"


MODES = {
    "batch_rollout": (["--forecast", "5"],
                      {"predicted3djoints": (3, 8, 17, 3), "future3djoints": (3, 5, 17, 3)},
                      "batch rollout (+5 future frames)"),
    "streaming": (["--streaming", "--forecast", "3"],
                  {"predicted3djoints": (3, 8, 17, 3), "future3djoints": (3, 3, 17, 3)},
                  "streaming +3 forecast frames"),
    "streaming_freeze": (["--streaming", "--freeze", "--forecast", "3"],
                         {"predicted3djoints": (3, 8, 17, 3),
                          "future3djoints": (3, 3, 17, 3)},
                         "streaming (frozen-stats O(1) push) +3 forecast frames"),
    "streaming_window": (["--streaming", "--freeze", "--window", "3", "--forecast", "0"],
                         {"predicted3djoints": (3, 8, 17, 3)},
                         "streaming (frozen-stats O(1) push)"),
    "forward": (["--forecast", "0"], {"predicted3djoints": (3, 8, 17, 3)},
                "batch forward"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_cli_matches_h36x(store_and_ckpt, tmp_path, capsys, mode):
    store, ckpt_path = store_and_ckpt
    flags, shapes, label = MODES[mode]
    common = ["--features-root", str(store), "--model-path", str(ckpt_path),
              "--subjects", "9", "--clips", "3", *flags]
    jax_predict_main([*common, "--out", str(tmp_path / "jax.npz")])
    jax_text = capsys.readouterr().out
    payload = predict_main([*common, "--out", str(tmp_path / "torch.npz"),
                            "--device", "cpu"], precise=True)
    text = capsys.readouterr().out
    # the same two printed lines (MPJPE of random weights: compare loosely)
    assert "Model config from checkpoint manifest" in text
    assert f"Served 3 clips ({label}); context MPJPE" in text
    assert f"Served 3 clips ({label}); context MPJPE" in jax_text
    assert f"[OK] Saved predictions to: {tmp_path / 'torch.npz'}" in text

    want = np.load(tmp_path / "jax.npz", allow_pickle=True)
    got = np.load(tmp_path / "torch.npz", allow_pickle=True)
    assert set(got.files) == set(want.files) == {"joints3d", "meta", *shapes}
    assert set(payload) == set(got.files)
    np.testing.assert_array_equal(got["joints3d"], want["joints3d"])
    assert list(got["meta"]) == list(want["meta"])
    for name, shape in shapes.items():
        assert got[name].shape == shape and got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=name)


def test_predict_cli_conflicting_flag_exits(store_and_ckpt, tmp_path):
    store, ckpt_path = store_and_ckpt
    with pytest.raises(SystemExit, match="contradict"):
        predict_main(["--features-root", str(store), "--model-path", str(ckpt_path),
                      "--out", str(tmp_path / "x.npz"), "--subjects", "9",
                      "--clips", "1", "--num-blocks", "2", "--device", "cpu"])


def test_predict_cli_missing_checkpoint_raises(store_and_ckpt, tmp_path):
    store, _ = store_and_ckpt
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        predict_main(["--features-root", str(store),
                      "--model-path", str(tmp_path / "nope.msgpack"),
                      "--out", str(tmp_path / "x.npz"), "--device", "cpu"])


def test_predict_cli_needs_cuda_unless_asked_for_the_cpu(store_and_ckpt, tmp_path):
    store, ckpt_path = store_and_ckpt
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_main(["--features-root", str(store), "--model-path", str(ckpt_path),
                      "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()


def test_predict_cli_plain_engines_equal_the_default_on_the_cpu(store_and_ckpt, tmp_path):
    """`use_kernels=False` (what a card run is held against) and the default
    are the same plain path on the CPU."""
    store, ckpt_path = store_and_ckpt
    argv = ["--features-root", str(store), "--model-path", str(ckpt_path),
            "--subjects", "9", "--clips", "2", "--forecast", "2", "--device", "cpu",
            "--out", str(tmp_path / "a.npz")]
    a = predict_main(argv)
    b = predict_main(argv, use_kernels=False)
    for name in ("predicted3djoints", "future3djoints"):
        np.testing.assert_array_equal(a[name], b[name])
