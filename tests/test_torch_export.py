"""h36x_torch.export and h36x_torch.cli.export against h36x's export on the
CPU: the same flax params (h36x's model.init, carried across by
params_from_flax) exported by both packages, the artifacts called on the
same features. Tolerances are h36x's own (tests/test_export.py): float32
rtol 1e-4 / atol 1e-5, bfloat16 2e-2 of the float32 forward; the bf16
artifacts against h36x's by BF16_MEAN_TOL, set from readings."""

import hashlib
import json
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from h36x import export as jax_export
from h36x.infer import phd_forward_fused as jax_phd_forward_fused
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x_torch import export, infer
from h36x_torch.cli.export import main as export_main
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
from h36x_torch.serve import _rollout, make_rollout_fn

SEQ, FEAT, STEPS = 10, 32, 3
ARCH = dict(latent_dim=64, feature_dim=FEAT, number_blocks=1, groups=8)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 2e-2  # max |bf16 artifact - f32 forward| (h36x's bound)
# Bounds on mean |port - h36x| of the bf16 artifacts' compute, set from
# readings of _bf16_gaps: the `setup` params, features _feats(16, seed) for
# seeds 1-5. "joints": the forward artifact's output against h36x's bf16
# artifact; "future": the rollout artifact's forecast against h36x's;
# "phi": the plain engine on the bf16 params and features (what the
# artifacts compute, bit for bit) against h36x's plain engine on the same.
#   The port: joints 2.0e-4 to 3.9e-4, phi 4.4e-4 to 8.7e-4, future 8.6e-4
#   to 1.6e-3 (bf16 sums in other orders).
#   Controls (ARTIFACT_CONTROLS): the float32 artifacts, joints 8.4e-4, phi
#   2.8e-3, future 2.2e-3 and up; GroupNorm statistics and output in
#   float32 (the model dtype's rule, where h36x's artifact keeps the
#   operands' bf16), joints 5.6e-4, phi 1.7e-3, future 2.0e-3 and up.
# Each bound lies between the port's largest reading and the controls'
# smallest.
BF16_MEAN_TOL = {"joints": 4.7e-4, "phi": 1.2e-3, "future": 1.8e-3}
SIDECAR_KEYS = {"platforms", "in_avals", "out_avals", "nbytes", "kind", "dtype",
                "sha256"}


@pytest.fixture(scope="module")
def setup():
    model = FlaxPHD(**ARCH)
    feats = np.random.default_rng(0).normal(size=(2, SEQ, FEAT)).astype(np.float32)
    params = jax.device_get(model.init(jax.random.key(0), jnp.asarray(feats))["params"])
    port = PHDFor3DJoints(**ARCH, device="cpu")
    port.load_state_dict(params_from_flax(params))
    return model, params, param_tree(port)


@pytest.fixture(scope="module")
def artifacts(setup):
    """The port's forward artifacts (f32, bf16, f32 at batch 3) and rollout,
    exported from the model's own param tree (nn.Parameters), with the
    warnings export gave."""
    _, _, tree = setup
    kw = dict(seq_len=SEQ, feature_dim=FEAT, groups=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = {"f32": export.export_forward(tree, **kw),
               "bf16": export.export_forward(tree, compute_dtype=torch.bfloat16,
                                             **kw),
               "b3": export.export_forward(tree, batch=3, **kw),
               "rollout": export.export_rollout(tree, steps=STEPS, **kw),
               "rollout_bf16": export.export_rollout(
                   tree, steps=STEPS, compute_dtype=torch.bfloat16, **kw)}
    out["warnings"] = [str(w.message) for w in caught]
    return out


@pytest.fixture(scope="module")
def loaded(artifacts):
    """The port's artifacts loaded on the CPU."""
    return {k: export.load_artifact(v, device="cpu") for k, v in artifacts.items()
            if k != "warnings"}


@pytest.fixture(scope="module")
def theirs(setup):
    """h36x's artifacts of the same params, loaded, and "phi_bf16": h36x's
    plain engine's phi on the bf16 params and features (what its bf16
    artifacts compute)."""
    _, params, _ = setup
    kw = dict(seq_len=SEQ, feature_dim=FEAT, groups=8, platforms=("cpu",))
    bf16 = jax_export._cast_params(params, jnp.bfloat16)
    return {"f32": jax_export.load_artifact(jax_export.export_forward(params, **kw)),
            "bf16": jax_export.load_artifact(jax_export.export_forward(
                params, compute_dtype=jnp.bfloat16, **kw)),
            "rollout": jax_export.load_artifact(jax_export.export_rollout(
                params, steps=STEPS, **kw)),
            "rollout_bf16": jax_export.load_artifact(jax_export.export_rollout(
                params, steps=STEPS, compute_dtype=jnp.bfloat16, **kw)),
            "phi_bf16": lambda x: jax_phd_forward_fused(
                bf16, jnp.asarray(x).astype(jnp.bfloat16), groups=8,
                use_pallas=False)[0]}


@pytest.fixture(scope="module")
def checkpoint(setup, tmp_path_factory):
    """h36x's params saved as a port checkpoint with its manifest (the
    architecture and window both CLIs read)."""
    from h36x_torch.train.checkpoint import save_params

    _, params, _ = setup
    model_cfg = {"latent_dim": 64, "feature_dim": FEAT, "num_blocks": 1,
                 "groups": 8}
    return save_params(tmp_path_factory.mktemp("ckpt"), "best",
                       params_from_flax(params),
                       config={"model": model_cfg, "data": {"seq_len": SEQ}})


def _feats(b, seed=1):
    return np.random.default_rng(seed).normal(size=(b, SEQ, FEAT)).astype(np.float32)


@pytest.mark.parametrize("b", [1, 2, 5])
def test_forward_artifact_matches_h36x(setup, loaded, theirs, b):
    """One symbolic-batch artifact at batch 1, 2 and 5 against h36x's
    export_forward and model.apply."""
    model, params, _ = setup
    x = _feats(b)
    got = loaded["f32"](x)
    assert got.dtype == torch.float32 and got.shape == (b, SEQ, 17, 3)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x))[2])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs["f32"](x)), **TOL)


def test_fixed_batch_refuses_other_sizes(loaded):
    fn = loaded["b3"]
    assert fn(_feats(3)).shape == (3, SEQ, 17, 3)
    with pytest.raises(Exception, match=r"size\(\)\[0\] == 3"):
        fn(_feats(2))


def _gn_in_float32(x, scale, bias, kernel, conv_bias, residual=None, dtype=None,
                   **kw):
    """Control: GroupNorm statistics and output in float32 over the bf16
    operands, the conv in their dtype (h36x's artifact takes the statistics
    in bf16, its plain formulation's own dtype)."""
    return _REFERENCE_GN(x.float(), scale.float(), bias.float(), kernel,
                         conv_bias, residual=residual, dtype=x.dtype, **kw)


_REFERENCE_GN = infer.reference_gn_relu_cconv
ARTIFACT_CONTROLS = ("float32", "float32 GroupNorm")


def _bf16_engine(tree, x, monkeypatch, patches=None):
    """The plain engine on the bf16 params and features, eagerly, with
    `patches` (names of h36x_torch.infer) applied: (phi, joints, future)."""
    cast = export._cast_params(tree, torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with monkeypatch.context() as m, torch.inference_mode():
        for name, fn in (patches or {}).items():
            m.setattr(infer, name, fn)
        phi = infer._movie(cast, xb, 8, False)
        joints = infer._regressor(phi, cast["f_3D"], 17, False)
        future = _rollout(cast, xb, STEPS, 17, 8, False)[1]
    return phi, joints.float(), future.float()


def _bf16_gaps(theirs, x, phi, joints, future):
    """mean |port - h36x| of phi, the forward's joints and the rollout's
    future joints (BF16_MEAN_TOL's readings)."""
    def gap(a, b):
        return float(np.abs(np.asarray(a.float()) - np.asarray(b, np.float32)).mean())

    return {"phi": gap(phi, theirs["phi_bf16"](x).astype(jnp.float32)),
            "joints": gap(joints, theirs["bf16"](x)),
            "future": gap(future, theirs["rollout_bf16"](x)[1])}


def _port_bf16_gaps(setup, loaded, theirs, x, monkeypatch):
    """The port's bf16 artifacts on x, held against what the plain engine
    computes on the bf16 params bit for bit, and their gaps to h36x's."""
    phi, joints, future = _bf16_engine(setup[2], x, monkeypatch)
    got, (ctx, fut) = loaded["bf16"](x), loaded["rollout_bf16"](x)
    assert got.dtype == fut.dtype == torch.float32
    assert torch.equal(got, joints) and torch.equal(ctx, joints)
    assert torch.equal(fut, future)
    return _bf16_gaps(theirs, x, phi, got, fut)


def test_bf16_artifact_smaller_close_and_near_h36x(setup, artifacts, loaded, theirs,
                                                   monkeypatch):
    """Under 0.6x the f32 file, float32 out, within 2e-2 of model.apply and
    within BF16_MEAN_TOL of h36x's bf16 artifacts."""
    model, params, _ = setup
    assert len(artifacts["bf16"]) < 0.6 * len(artifacts["f32"])
    x = _feats(16, seed=1)
    gaps = _port_bf16_gaps(setup, loaded, theirs, x, monkeypatch)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x))[2])
    assert float(np.abs(loaded["bf16"](x).numpy() - want).max()) < BF16_TOL
    assert all(gaps[k] <= BF16_MEAN_TOL[k] for k in gaps), gaps


@pytest.mark.parametrize("seed", [2, 3, 4, 5])
def test_bf16_artifacts_within_the_bounds_at_other_seeds(setup, loaded, theirs,
                                                         monkeypatch, seed):
    """The readings BF16_MEAN_TOL was set from: other features."""
    gaps = _port_bf16_gaps(setup, loaded, theirs, _feats(16, seed), monkeypatch)
    assert all(gaps[k] <= BF16_MEAN_TOL[k] for k in gaps), gaps


@pytest.mark.parametrize("control", ARTIFACT_CONTROLS)
def test_bf16_artifact_bounds_refuse_other_semantics(setup, loaded, theirs,
                                                     monkeypatch, control):
    """An artifact that computes otherwise than h36x's bf16 artifact fails
    BF16_MEAN_TOL at every seed of the readings: the float32 artifacts, or
    float32 GroupNorm statistics."""
    tree = setup[2]
    for seed in range(1, 6):
        x = _feats(16, seed)
        if control == "float32":
            with torch.inference_mode():
                phi = infer._movie(export._cast_params(tree), torch.from_numpy(x),
                                   8, False)
            outs = phi, loaded["f32"](x), loaded["rollout"](x)[1]
        else:
            outs = _bf16_engine(tree, x, monkeypatch,
                                {"reference_gn_relu_cconv": _gn_in_float32})
        gaps = _bf16_gaps(theirs, x, *outs)
        assert any(gaps[k] > BF16_MEAN_TOL[k] for k in gaps), (seed, gaps)


@pytest.mark.parametrize("b", [1, 3])
def test_rollout_artifact_matches_h36x(setup, loaded, theirs, b):
    _, _, tree = setup
    x = _feats(b, seed=2)
    ctx, fut = loaded["rollout"](x)
    assert ctx.shape == (b, SEQ, 17, 3) and fut.shape == (b, STEPS, 17, 3)
    want_ctx, want_fut = theirs["rollout"](x)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), **TOL)
    np.testing.assert_allclose(fut.numpy(), np.asarray(want_fut), **TOL)
    # and the port's own plain rollout, bit for bit
    mine = make_rollout_fn(tree, STEPS, groups=8, use_kernels=False, device="cpu",
                           precise=True)(x)
    assert torch.equal(ctx, mine[0]) and torch.equal(fut, mine[1])


def test_file_roundtrip_and_info(artifacts, tmp_path):
    path = export.save_artifact(artifacts["f32"], tmp_path / "a" / "phd.pt2")
    assert path.read_bytes() == artifacts["f32"]
    out = export.load_artifact(path, device="cpu")(_feats(2))
    assert out.shape == (2, SEQ, 17, 3) and torch.isfinite(out).all()
    info = export.artifact_info(path)
    assert info == {"platforms": ["cpu", "cuda"],
                    "in_avals": [f"float32[b,{SEQ},{FEAT}]"],
                    "out_avals": [f"float32[b,{SEQ},17,3]"],
                    "nbytes": len(artifacts["f32"])}
    assert export.artifact_input_shape(path) == (None, SEQ, FEAT)
    assert export.artifact_input_shape(artifacts["b3"]) == (3, SEQ, FEAT)
    assert export.artifact_info(artifacts["rollout"])["out_avals"] == [
        f"float32[b,{SEQ},17,3]", f"float32[b,{STEPS},17,3]"]
    assert not list(tmp_path.glob("a/*.tmp.*"))


def test_export_lifts_no_parameter_that_requires_grad(setup, artifacts, loaded):
    """The model's own param tree (nn.Parameters) exports without torch's
    warning about constants that require grad: they are detached first."""
    _, _, tree = setup
    assert any(t.requires_grad for t in jax.tree.leaves(tree))
    assert not [w for w in artifacts["warnings"] if "requires grad" in w]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loaded["f32"]._module(torch.from_numpy(_feats(1)))
    assert not [w for w in caught if "requires grad" in str(w.message)]
    fn = loaded["f32"]
    assert fn.tensors() and not any(t.requires_grad for t in fn.tensors())
    assert all(t.device.type == "cpu" for t in fn.tensors())


def test_load_without_cuda_raises_unless_cpu(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_artifact(artifacts["f32"])
    assert export.load_artifact(artifacts["f32"], device="cpu").device.type == "cpu"


def test_platforms_other_than_cpu_and_cuda_refused(setup):
    with pytest.raises(ValueError, match="tpu"):
        export.export_forward(setup[2], seq_len=SEQ, feature_dim=FEAT, groups=8,
                              platforms=("cpu", "tpu"))


def test_artifact_runs_without_h36x_torch(artifacts, loaded, tmp_path):
    """The saved artifact loads and runs in a process that imports neither
    h36x_torch nor jax: torch.export alone."""
    path = export.save_artifact(artifacts["f32"], tmp_path / "phd.pt2")
    x = _feats(2)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "from torch.export.passes import move_to_device_pass\n"
        "ep = move_to_device_pass(torch.export.load(sys.argv[1]), 'cpu')\n"
        "with torch.inference_mode():\n"
        "    y = ep.module()(torch.from_numpy(np.load(sys.argv[2])))\n"
        "np.save(sys.argv[3], y.numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('h36x_torch', 'h36x', 'jax')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code, str(path), str(tmp_path / "x.npy"),
                    str(tmp_path / "y.npy")], cwd=tmp_path, check=True,
                   timeout=300)
    want = loaded["f32"](x)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want.numpy())


@pytest.mark.parametrize("kind, dtype", [("forward", "float32"),
                                         ("forward", "bfloat16"),
                                         ("rollout", "float32"),
                                         ("rollout", "bfloat16")])
def test_cli_export_check_and_sidecar(loaded, checkpoint, tmp_path, capsys,
                                      kind, dtype):
    """cli.export --check on a checkpoint of h36x's params (architecture and
    window from its manifest), both kinds: the sidecar has h36x's keys and
    the file's sha256; the artifact computes what the module's own export
    of the same params does (held against h36x's above)."""
    out = tmp_path / "art" / "phd.pt2"
    export_main(["--model-path", str(checkpoint), "--out", str(out),
                 "--kind", kind, "--forecast", str(STEPS), "--dtype", dtype,
                 "--platforms", "cuda,cpu", "--check", "--device", "cpu"])
    assert "[check] max |artifact - model forward (f32)|" in capsys.readouterr().out
    sidecar = json.loads((tmp_path / "art" / "phd.pt2.json").read_text())
    want_keys = SIDECAR_KEYS | ({"forecast"} if kind == "rollout" else set())
    assert set(sidecar) == want_keys
    blob = out.read_bytes()
    assert sidecar["sha256"] == hashlib.sha256(blob).hexdigest()
    assert sidecar["nbytes"] == len(blob)
    assert (sidecar["kind"], sidecar["dtype"]) == (kind, dtype)
    assert sidecar["platforms"] == ["cpu", "cuda"]
    assert sidecar["in_avals"] == [f"float32[b,{SEQ},{FEAT}]"]
    x = _feats(2, seed=4)
    got = export.load_artifact(blob, device="cpu")(x)
    want = loaded[{("forward", "float32"): "f32", ("forward", "bfloat16"): "bf16",
                   ("rollout", "float32"): "rollout",
                   ("rollout", "bfloat16"): "rollout_bf16"}[kind, dtype]](x)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert torch.equal(a, b)


def test_cli_export_sidecar_keys_are_h36xs(checkpoint, tmp_path):
    """h36x's own export CLI, on the same checkpoint, writes the keys the
    port's sidecar holds."""
    from h36x.cli.export import main as jax_export_main

    out = tmp_path / "phd.hlo"
    jax_export_main(["--model-path", str(checkpoint), "--out", str(out),
                     "--platforms", "cpu"])
    assert set(json.loads((tmp_path / "phd.hlo.json").read_text())) == SIDECAR_KEYS


def test_cli_export_refuses_tpu(tmp_path):
    with pytest.raises(SystemExit, match="tpu"):
        export_main(["--model-path", str(tmp_path / "x.msgpack"),
                     "--platforms", "cpu,tpu"])


def test_export_check_fails_a_wrong_artifact(checkpoint, tmp_path, monkeypatch):
    """--check compares against the model: an artifact of other weights
    fails it."""
    real = export.export_forward

    def shifted(tree, **kw):
        return real(jax.tree.map(lambda t: t.detach() + 0.05, tree), **kw)

    monkeypatch.setattr(export, "export_forward", shifted)
    with pytest.raises(SystemExit, match="artifact check failed"):
        export_main(["--model-path", str(checkpoint), "--out",
                     str(tmp_path / "phd.pt2"), "--check", "--device", "cpu"])
