"""h36x_torch checkpoints and serving daemon: checkpoints cross between the
packages both ways, the msgpack codec agrees with the `msgpack` package,
and the port's BatchingServer answers concurrent requests with the port's
forward (on the CPU here)."""

import asyncio
import dataclasses
import hashlib
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train import checkpoint as jax_ckpt
from h36x.train.state import create_train_state, make_optimizer
from h36x_torch.cli import serve as serve_cli
from h36x_torch.infer import make_fused_forward
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
from h36x_torch import export
from h36x_torch.serve_daemon import (
    BatchingServer,
    bucket_size,
    build_predict_fn,
    request_async,
    stats_async,
)
from h36x_torch.train import checkpoint as ckpt
from h36x_torch.utils import msgpack_lite

T, F = 6, 32
ARCH = dict(latent_dim=64, feature_dim=F, number_blocks=1)


@pytest.fixture(scope="module")
def flax_state():
    model = FlaxPHD(**ARCH)
    optimizer, _ = make_optimizer(lr=1e-3, freeze_ar=True)
    # jitted: one compile instead of the init's ops one by one
    init = jax.jit(lambda key, x: create_train_state(model, optimizer, key, x))
    return init(jax.random.key(0), jnp.zeros((2, T, F)))


def _assert_tree_bits_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, x in la:
        y = lb[path]
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


def test_h36x_trainstate_checkpoint_loads_bit_for_bit(flax_state, tmp_path):
    jax_ckpt.save_checkpoint(tmp_path, "last", flax_state, epoch=1,
                             best_val=0.5, config={"model": {"latent_dim": 64}})
    path = tmp_path / "last.msgpack"
    _assert_tree_bits_equal(ckpt.load_params_raw(path),
                            jax.device_get(flax_state.params))
    model = PHDFor3DJoints(**ARCH, device="cpu")
    sd = ckpt.load_params_only(path, model.state_dict())
    model.load_state_dict(sd)
    assert ckpt.load_recorded_model_config(path) == {"latent_dim": 64}


def test_port_save_params_loads_in_h36x(flax_state, tmp_path):
    params = jax.device_get(flax_state.params)
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    path = ckpt.save_params(tmp_path, "best", sd, config={"data": {"seq_len": T}})
    _assert_tree_bits_equal(jax_ckpt.load_params_raw(path), params)
    restored = jax_ckpt.load_params_only(path, params)
    _assert_tree_bits_equal(restored, params)
    assert jax_ckpt.load_recorded_config(path) == {"data": {"seq_len": T}}
    manifest = json.loads((tmp_path / "best.json").read_text())
    blob = path.read_bytes()
    assert manifest["nbytes"] == len(blob)
    assert manifest["sha256"] == hashlib.sha256(blob).hexdigest()


def test_load_params_only_refuses_shape_mismatch(flax_state, tmp_path):
    jax_ckpt.save_checkpoint(tmp_path, "last", flax_state, epoch=0, best_val=1.0)
    wider = PHDFor3DJoints(**dict(ARCH, latent_dim=96, groups=8), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params_only(tmp_path / "last.msgpack", wider.state_dict())


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "last").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.load_params_raw(tmp_path / "last")


@pytest.mark.parametrize("value", [
    {"a": [1, -3, 300, -70000, 2**40, 1.5, None, True, False, "x" * 40,
           b"\x00" * 300],
     "arr": np.arange(12, dtype=np.float32).reshape(3, 4),
     "i64": np.arange(3, dtype=np.int64), "scalar": np.int32(7),
     "big": {str(i): i for i in range(20)}},
])
def test_msgpack_lite_matches_flax_codec(value):
    # port encoder -> flax decoder, and flax encoder -> port decoder
    from_port = serialization.msgpack_restore(msgpack_lite.packb(value))
    from_flax = msgpack_lite.unpackb(serialization.msgpack_serialize(value))
    for got in (from_port, from_flax):
        np.testing.assert_array_equal(got["arr"], value["arr"])
        np.testing.assert_array_equal(got["i64"], value["i64"])
        assert got["scalar"] == 7 and got["scalar"].dtype == np.int32
        assert got["a"] == value["a"] and got["big"] == value["big"]


def test_msgpack_lite_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    arr = np.arange(30, dtype=np.float32).reshape(5, 6)
    blob = serialization.msgpack_serialize({"w": arr})
    assert b"__msgpack_chunked_array__" in blob
    np.testing.assert_array_equal(msgpack_lite.unpackb(blob)["w"], arr)
    assert msgpack.unpackb(msgpack_lite.packb({"k": 1})) == {"k": 1}


@pytest.fixture(scope="module")
def served_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("served")
    model = PHDFor3DJoints(**ARCH, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    ckpt.save_params(d, "best", model.state_dict())
    return d / "best.msgpack", model


def test_daemon_concurrent_requests_match_port_forward(served_ckpt):
    path, model = served_ckpt
    predict_fn, pad_to = build_predict_fn(
        model_path=str(path), seq_len=T, feature_dim=F, latent_dim=64,
        num_blocks=1, max_batch=8, warm=True, device="cpu")
    assert pad_to == 0  # checkpoint mode: batches at their exact size
    server = BatchingServer(predict_fn, seq_len=T, feature_dim=F, max_batch=8,
                            max_wait_ms=200.0)
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(T, F)).astype(np.float32) for _ in range(5)]

    async def run():
        srv = await server.start(host="127.0.0.1", port=0)
        port = srv.sockets[0].getsockname()[1]
        try:
            return await asyncio.gather(*[
                request_async(f, host="127.0.0.1", port=port, timeout_s=60)
                for f in feats])
        finally:
            server.stop()
            srv.close()
            await srv.wait_closed()

    outs = asyncio.run(run())
    want = make_fused_forward(param_tree(model))(torch.from_numpy(np.stack(feats)))
    for got, w in zip(outs, want.numpy()):
        assert got.shape == (T, 17, 3)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    assert server.stats["requests"] == 5 and server.stats["batches"] == 1
    assert server.stats_snapshot()["batch_device_ms"]["n"] == 1


def test_default_device_without_cuda_raises(served_ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_predict_fn(model_path=str(served_ckpt[0]), seq_len=T,
                         feature_dim=F, latent_dim=64, num_blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PHDFor3DJoints(**ARCH)


def _serve(server, clients):
    """Start `server` on a local port, run `clients(port)`, stop it."""
    async def run():
        srv = await server.start(host="127.0.0.1", port=0)
        try:
            return await clients(srv.sockets[0].getsockname()[1])
        finally:
            server.stop()
            srv.close()
            await srv.wait_closed()

    return asyncio.run(run())


def _gather(feats, stats=False):
    async def clients(port):
        out = await asyncio.gather(*[request_async(f, host="127.0.0.1", port=port,
                                                   timeout_s=60) for f in feats])
        if stats:
            return out, await stats_async(host="127.0.0.1", port=port, timeout_s=30)
        return out
    return clients


@pytest.mark.parametrize("max_batch, n, pad_to, bucket_pad, rows", [
    (8, 3, 0, True, 4),   # artifact mode: the next power of two
    (6, 5, 0, True, 6),   # bucket_size(5) = 8, clamped at max_batch
    (8, 3, 8, False, 8),  # a fixed pad
    (8, 3, 0, False, 3),  # checkpoint mode: the exact size
])
def test_bucket_padding(max_batch, n, pad_to, bucket_pad, rows):
    """A coalesced batch of n reaches predict_fn padded to `rows`; replies
    are the real rows' (h36x's tests/test_serve_daemon.py::
    test_bucket_padding)."""
    assert [bucket_size(k) for k in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 16]
    seen = []

    def spy(feats):
        seen.append(feats.shape[0])
        return np.repeat(feats.sum(axis=2, keepdims=True), 51, axis=2).reshape(
            feats.shape[0], T, 17, 3)

    server = BatchingServer(spy, seq_len=T, feature_dim=F, max_batch=max_batch,
                            max_wait_ms=200.0, pad_to=pad_to, bucket_pad=bucket_pad)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(T, F)).astype(np.float32) for _ in range(n)]
    outs = _serve(server, _gather(feats))
    assert seen == [rows] and server.stats["rows"] == n
    for got, f in zip(outs, feats):
        np.testing.assert_array_equal(got, spy(f[None])[0])


@pytest.fixture(scope="module")
def artifacts(served_ckpt, tmp_path_factory):
    """A forward and a 2-step rollout artifact of the served model, and a
    forward of fixed batch 4, saved."""
    d = tmp_path_factory.mktemp("artifacts")
    tree = param_tree(served_ckpt[1])
    kw = dict(seq_len=T, feature_dim=F)
    return (export.save_artifact(export.export_forward(tree, **kw), d / "fwd.pt2"),
            export.save_artifact(export.export_rollout(tree, steps=2, **kw),
                                 d / "roll.pt2"),
            export.save_artifact(export.export_forward(tree, batch=4, **kw),
                                 d / "fwd_b4.pt2"))


def test_artifact_is_served(artifacts, served_ckpt, monkeypatch):
    """build_predict_fn(artifact=) serves the artifact on the device thread,
    warmed at every bucket up to max_batch; 5 concurrent requests coalesce
    into one batch padded to 8 and reply what the artifact computes
    directly, which is the model's float32 forward."""
    path, model = served_ckpt
    calls = []
    real = export.LoadedArtifact.__call__
    monkeypatch.setattr(export.LoadedArtifact, "__call__",
                        lambda self, x: calls.append(x.shape[0]) or real(self, x))
    predict_fn, pad_to = build_predict_fn(artifact=str(artifacts[0]), max_batch=8,
                                          warm=True, device="cpu")
    assert pad_to == 0 and calls == [1, 2, 4, 8]
    server = BatchingServer(predict_fn, seq_len=T, feature_dim=F, max_batch=8,
                            max_wait_ms=200.0, pad_to=pad_to, bucket_pad=True)
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(T, F)).astype(np.float32) for _ in range(5)]
    outs, stats = _serve(server, _gather(feats, stats=True))
    assert calls[4:] == [8] and stats["batches"] == 1 and stats["rows"] == 5
    direct = export.load_artifact(artifacts[0], device="cpu")(np.stack(feats))
    want = make_fused_forward(param_tree(model), use_kernels=False, precise=True)(
        torch.from_numpy(np.stack(feats)))
    for i, got in enumerate(outs):
        np.testing.assert_array_equal(got, direct[i].numpy())
        np.testing.assert_allclose(got, want[i].numpy(), rtol=1e-5, atol=1e-6)


def test_fixed_batch_artifact_is_served(artifacts, monkeypatch):
    """An artifact of fixed batch 4: build_predict_fn returns pad_to=4 and
    warms that size only; 3 requests reach it padded to 4 rows and reply
    what it computes; a max_batch above 4 is refused."""
    calls = []
    real = export.LoadedArtifact.__call__
    monkeypatch.setattr(export.LoadedArtifact, "__call__",
                        lambda self, x: calls.append(x.shape[0]) or real(self, x))
    predict_fn, pad_to = build_predict_fn(artifact=str(artifacts[2]), max_batch=4,
                                          warm=True, device="cpu")
    assert pad_to == 4 and calls == [4]
    server = BatchingServer(predict_fn, seq_len=T, feature_dim=F, max_batch=4,
                            max_wait_ms=200.0, pad_to=pad_to, bucket_pad=True)
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(T, F)).astype(np.float32) for _ in range(3)]
    outs = _serve(server, _gather(feats))
    assert calls[1:] == [4]
    padded = np.concatenate([np.stack(feats), np.zeros((1, T, F), np.float32)])
    direct = export.load_artifact(artifacts[2], device="cpu")(padded)
    for i, got in enumerate(outs):
        np.testing.assert_array_equal(got, direct[i].numpy())
    with pytest.raises(ValueError, match="fixed batch 4"):
        build_predict_fn(artifact=str(artifacts[2]), max_batch=8, device="cpu")


def test_rollout_artifact_served_with_split(artifacts):
    """A rollout artifact replies (ctx, future) concatenated on time with a
    'split' header; the client splits it back, equal to the artifact called
    directly."""
    predict_fn, pad_to = build_predict_fn(artifact=str(artifacts[1]), max_batch=4,
                                          device="cpu")
    server = BatchingServer(predict_fn, seq_len=T, feature_dim=F, max_batch=4,
                            max_wait_ms=200.0, pad_to=pad_to, bucket_pad=True)
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=(T, F)).astype(np.float32) for _ in range(3)]
    outs = _serve(server, _gather(feats))
    ctx, fut = export.load_artifact(artifacts[1], device="cpu")(np.stack(feats))
    for i, (c, f) in enumerate(outs):
        assert c.shape == (T, 17, 3) and f.shape == (2, 17, 3)
        np.testing.assert_array_equal(c, ctx[i].numpy())
        np.testing.assert_array_equal(f, fut[i].numpy())


def test_cli_serve_artifact(artifacts, monkeypatch, capsys):
    """cli.serve --artifact: wire shapes from the artifact, bucket padding,
    a flag contradicting the artifact's shape refused."""
    import h36x_torch.serve_daemon as daemon

    got = {}

    async def fake_serve_forever(server, drain_s=10.0, **bind):
        got["server"] = server

    monkeypatch.setattr(daemon, "serve_forever", fake_serve_forever)
    serve_cli.main(["--artifact", str(artifacts[0]), "--device", "cpu",
                    "--max-batch", "4", "--seq-len", str(T)])
    server = got["server"]
    assert (server.seq_len, server.feature_dim) == (T, F)
    assert (server.pad_to, server.bucket_pad, server.max_batch) == (0, True, 4)
    assert f"wire shapes: T={T} D={F}" in capsys.readouterr().out
    for flag, value in (("--seq-len", T + 1), ("--feature-dim", F * 2)):
        with pytest.raises(SystemExit, match="contradicts the artifact"):
            serve_cli.main(["--artifact", str(artifacts[0]), "--device", "cpu",
                            flag, str(value)])


def test_cli_serve_fixed_batch_artifact(artifacts, monkeypatch):
    """cli.serve --artifact of a fixed batch: max_batch defaults to that
    batch, every batch is padded to it, and a larger --max-batch is
    refused."""
    import h36x_torch.serve_daemon as daemon

    got = {}

    async def fake_serve_forever(server, drain_s=10.0, **bind):
        got["server"] = server

    monkeypatch.setattr(daemon, "serve_forever", fake_serve_forever)
    serve_cli.main(["--artifact", str(artifacts[2]), "--device", "cpu"])
    assert (got["server"].pad_to, got["server"].max_batch) == (4, 4)
    with pytest.raises(SystemExit, match="exceeds the artifact's fixed batch 4"):
        serve_cli.main(["--artifact", str(artifacts[2]), "--device", "cpu",
                        "--max-batch", "8"])


@pytest.mark.parametrize("argv, msg", [
    (["--stats", "--model-path", "x.msgpack"], "takes no model source"),
    ([], "is required"),
    (["--artifact", "a.hlo", "--groups", "8"], "cannot take effect"),
    (["--artifact", "a.pt2", "--latent-dim", "64", "--num-blocks", "1"],
     "--latent-dim --num-blocks: artifact mode"),
])
def test_cli_conflicts(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        serve_cli.main(argv)


def test_cli_model_flags_contradicting_manifest(served_ckpt, tmp_path):
    from h36x_torch.config import ModelConfig

    cfg = {"model": dict(dataclasses.asdict(ModelConfig()), latent_dim=64)}
    path = ckpt.save_params(tmp_path, "best", served_ckpt[1].state_dict(),
                            config=cfg)
    with pytest.raises(SystemExit, match="contradict"):
        serve_cli.main(["--model-path", str(path), "--latent-dim", "128",
                        "--device", "cpu"])
