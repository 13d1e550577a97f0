"""The public names h36x_torch took over from h36x in its last module slice,
each held against h36x on the CPU: project_point_radial, H36M_JOINT_NAMES,
to_json, count_params, the torch augment ops (color_jitter's helpers on
both hue routes with the same factors, hflip_video, reverse_time), the
native hflip_clip / bcs_jitter_clip, PreprocessedClips, and the
subpackages' re-exports."""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h36x.config as jax_config
import h36x.data.augment as jax_augment
import h36x_torch.config as port_config
import h36x_torch.data.augment as port_augment

TOL = dict(rtol=1e-5, atol=1e-5)


def test_project_point_radial_matches_h36x(rng):
    from h36x.geometry.camera import project_point_radial as jax_radial
    from h36x_torch.geometry.camera import project_point_radial

    P = rng.normal(size=(40, 3)).astype(np.float32) * 300
    P[:, 2] = np.abs(P[:, 2]) + 3000.0
    angles = rng.uniform(-0.2, 0.2, 3)
    from h36x_torch.geometry.camera import rotation_matrix_xyz

    args = (rotation_matrix_xyz(angles), rng.normal(size=3) * 50,
            np.array([1145.0, 1143.5]), np.array([512.5, 515.4]),
            np.array([-0.2, 0.24, 1e-3, -2e-4, -2e-3]))
    want = np.asarray(jax_radial(P, *args))
    got = project_point_radial(torch.from_numpy(P), *args)
    assert got.dtype == torch.float32 and got.shape == (40, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # arrays as well as tensors, as h36x takes them
    np.testing.assert_allclose(project_point_radial(P, *args).numpy(), want, **TOL)


def test_joint_names_match_h36x():
    from h36x.geometry.skeleton import H36M_JOINT_NAMES as want
    from h36x_torch.geometry.skeleton import H36M_JOINT_NAMES, NUM_JOINTS

    assert H36M_JOINT_NAMES == want and len(H36M_JOINT_NAMES) == NUM_JOINTS


# the port's fields that h36x has no counterpart of, at their defaults:
# extraction's second backbone (ViT-H) is the port's alone
PORT_ONLY = {"ExtractConfig": {"backbone": "resnet50"}}


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig", "ExtractConfig",
                                  "IngestConfig"])
def test_to_json_matches_h36x(name):
    cfg = getattr(port_config, name)()
    fields = json.loads(port_config.to_json(cfg))
    for key, default in PORT_ONLY.get(name, {}).items():
        assert fields.pop(key) == default
    assert json.dumps(fields, indent=2, sort_keys=True) == \
        jax_config.to_json(getattr(jax_config, name)())
    assert port_config.to_json(dataclasses.replace(cfg)) == port_config.to_json(cfg)


def test_count_params_matches_h36x():
    from h36x.models.resnet import ResNet50 as FlaxResNet50
    from h36x.models.resnet import count_params as jax_count
    from h36x_torch.models.resnet import ResNet50, count_params

    shapes = jax.eval_shape(FlaxResNet50().init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = jax_count(variables)
    assert count_params(ResNet50(device="cpu")) == want
    assert count_params(variables) == want


# -- the torch augment ops -----------------------------------------------------


@pytest.fixture(scope="module")
def video():
    return np.random.default_rng(3).random((3, 6, 5, 3)).astype(np.float32)


@pytest.mark.parametrize("op, factor", [("_adjust_brightness", 1.23),
                                        ("_adjust_contrast", 0.81),
                                        ("_adjust_saturation", 1.17),
                                        ("_adjust_hue", 0.037),
                                        ("_adjust_hue", -0.049),
                                        ("_adjust_hue_yiq", 0.037),
                                        ("_adjust_hue_yiq", -0.049)])
def test_jitter_ops_match_h36x(video, op, factor):
    want = getattr(jax_augment, op)(jnp.asarray(video), jnp.float32(factor))
    got = getattr(port_augment, op)(torch.from_numpy(video), factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hsv_round_trip_matches_h36x(video):
    want = jax_augment._rgb_to_hsv(jnp.asarray(video))
    got = port_augment._rgb_to_hsv(torch.from_numpy(video))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    back = port_augment._hsv_to_rgb(*got)
    np.testing.assert_allclose(back.numpy(), video, **TOL)


@pytest.mark.parametrize("hue_mode", ["yiq", "hsv"])
def test_color_jitter_with_given_factors_matches_h36x(video, hue_mode):
    """The same factors and order through both packages' helpers, as
    h36x's color_jitter chains them (its key draws them; the port's
    generator does)."""
    order, fb, fc, fs, fh = [2, 0, 3, 1], 1.21, 0.77, 1.13, -0.031
    hue_fn = jax_augment._adjust_hue_yiq if hue_mode == "yiq" else jax_augment._adjust_hue
    ops = (lambda v: jax_augment._adjust_brightness(v, jnp.float32(fb)),
           lambda v: jax_augment._adjust_contrast(v, jnp.float32(fc)),
           lambda v: jax_augment._adjust_saturation(v, jnp.float32(fs)),
           lambda v: hue_fn(v, jnp.float32(fh)))
    want = jnp.asarray(video)
    for op in order:
        want = ops[op](want)
    got = port_augment._apply_jitter(torch.from_numpy(video), order, fb, fc, fs, fh,
                                     hue_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_color_jitter_draws_from_its_generator(video):
    x = torch.from_numpy(video)
    a = port_augment.color_jitter(x, torch.Generator().manual_seed(4))
    b = port_augment.color_jitter(x, torch.Generator().manual_seed(4))
    c = port_augment.color_jitter(x, torch.Generator().manual_seed(5), hue_mode="hsv")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == x.shape and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    with pytest.raises(ValueError, match="hue_mode"):
        port_augment.color_jitter(x, hue_mode="lab")


def test_hflip_video_and_reverse_time_match_h36x(video):
    x = torch.from_numpy(video)
    np.testing.assert_array_equal(port_augment.hflip_video(x).numpy(),
                                  np.asarray(jax_augment.hflip_video(jnp.asarray(video))))
    for axis in (0, 1):
        np.testing.assert_array_equal(
            port_augment.reverse_time(x, axis).numpy(),
            np.asarray(jax_augment.reverse_time(jnp.asarray(video), axis)))


# -- the native wrappers ------------------------------------------------------


def test_native_hflip_and_bcs_jitter_match_h36x():
    from h36x import native as jax_native
    from h36x_torch import native

    if not (native.available() and jax_native.available()):
        pytest.skip("a native library did not build (g++ missing)")
    frames = np.random.default_rng(1).integers(0, 256, (3, 9, 7, 3), dtype=np.uint8)
    strided = frames[:, ::2]
    for clip in (frames, strided):
        assert native.hflip_clip(clip).tobytes() == jax_native.hflip_clip(clip).tobytes()
    for order in ([0, 1, 2], [2, 0, 1], [1]):
        got = native.bcs_jitter_clip(frames, 1.2, 0.8, 1.1, order)
        assert got.tobytes() == jax_native.bcs_jitter_clip(frames, 1.2, 0.8, 1.1,
                                                           order).tobytes()
    np.testing.assert_array_equal(native.hflip_clip(frames), frames[:, :, ::-1])
    with pytest.raises(ValueError, match="unknown op"):
        native.bcs_jitter_clip(frames, 1.0, 1.0, 1.0, [3])


# -- PreprocessedClips --------------------------------------------------------


@pytest.fixture(scope="module")
def clip_tree(tmp_path_factory):
    """A tiny ingested tree with a real mp4 (as tests/test_clips_api.py)."""
    cv2 = pytest.importorskip("cv2")
    import pickle

    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(2)
    cam_dir = root / "S1" / "Walking_0" / "cam_0"
    cam_dir.mkdir(parents=True)
    h, w, n = 64, 64, 24
    vw = cv2.VideoWriter(str(cam_dir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (w, h))
    for i in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()
    with open(cam_dir / "gt_poses.pkl", "wb") as f:
        pickle.dump({"2d": (rng.random((n, 17, 2)) * 40 + 10).astype(np.float32),
                     "3d": rng.normal(size=(n, 17, 3)).astype(np.float32) * 100}, f)
    with open(cam_dir / "camera_wext.pkl", "wb") as f:
        pickle.dump({"f": np.array([100.0, 100.0]), "c": np.array([27.0, 32.0]),
                     "k": np.zeros(5), "rt": np.eye(3), "t": np.zeros(3)}, f)
    return root


@pytest.mark.parametrize("augment", [False, True])
def test_preprocessed_clips_match_h36x(clip_tree, augment):
    from h36x.data.clips import PreprocessedClips as JaxClips
    from h36x_torch.data.clips import PreprocessedClips

    kw = dict(subjects=[1], seq_len=4, stride=2, frame_skip=2, resize=32,
              augment=augment, jitter_seed=3)
    port, ref = PreprocessedClips(str(clip_tree), **kw), JaxClips(str(clip_tree), **kw)
    assert len(port) == len(ref) > 1
    assert [c.start for c in port.clips] == [c.start for c in ref.clips]
    for idx in (0, len(ref) - 1):
        got, want = port[idx], ref[idx]
        if not augment:
            got, want = [got], [want]
        assert len(got) == len(want) == (4 if augment else 1)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert np.shape(a) == np.shape(b)
                np.testing.assert_allclose(np.asarray(a, np.float64),
                                           np.asarray(b, np.float64), **TOL)


# -- the subpackages' re-exports -------------------------------------------------

@pytest.mark.parametrize("sub", ["geometry", "data", "extract", "models", "ops",
                                 "parallel", "train", "utils", "viz"])
def test_subpackage_reexports_resolve(sub):
    import ast
    import pathlib

    init = pathlib.Path(importlib.import_module(f"h36x.{sub}").__file__)
    names = {a.asname or a.name for node in ast.parse(init.read_text()).body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert names
    port = importlib.import_module(f"h36x_torch.{sub}")
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"h36x_torch.{sub} lacks {missing}"
    for n in names:
        obj = getattr(port, n)
        assert getattr(obj, "__module__", None) in (None, "builtins") or \
            obj.__module__.startswith("h36x_torch"), n


def test_top_level_and_named_imports():
    import h36x_torch
    from h36x_torch.geometry import project_with_K  # noqa: F401
    from h36x_torch.ops import causal_conv1d, resize_bilinear  # noqa: F401

    assert h36x_torch.config is port_config
