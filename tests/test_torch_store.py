"""The rest of h36x_torch's shard store against h36x on the CPU:
merge_stores (index.json and shard bytes equal to h36x's merge of the same
parts, moved and kept, and the same refusals), cli.merge_shards with its
--verify CRC gate, bfloat16 shard arrays (held as their uint16 bits: a
store h36x writes through ml_dtypes reads bit for bit, the port's bf16
shards are h36x's bytes, and the dataset and feed turn the bits into
torch.bfloat16 under every --data.feed-dtype), and the reference's torch
.pt stores (index.pt and shard_XXXXX.pt) read through both packages'
datasets to the same batches."""

import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from h36x.data import features as jax_features
from h36x.data import shards as jax_shards
from h36x_torch.data import features, shards
from h36x_torch.parallel.feed import FEED_DTYPES, to_device


def part_store(root, rng, subject, n_shards=2, clips=3, n_vars=2, t=4, f=16,
               feat_dtype="float32", mod=shards):
    """A part store of `n_shards` shards of `clips` clips, every clip key
    (subject, action, cam, start) its own."""
    root.mkdir(parents=True, exist_ok=True)
    writer = mod.ShardWriter(root, n_vars=n_vars)
    index = []
    for sid in range(n_shards):
        rows = clips * n_vars
        feats = rng.normal(size=(rows, t, f)).astype(np.float32)
        arrays = {"feats": feats.astype(ml_dtypes.bfloat16) if feat_dtype == "bfloat16"
                  else feats.astype(feat_dtype),
                  "joints3d": (rng.normal(size=(rows, t, 17, 3)) * 1000).astype(np.float32),
                  "joints2d": (rng.normal(size=(rows, t, 17, 2)) * 100).astype(np.float32),
                  "K": np.tile(np.eye(3, dtype=np.float32) * 1000, (rows, 1, 1))}
        meta = []
        for c in range(clips):
            start = 10 * (sid * clips + c)
            meta += [{"subject": subject, "action": "Walking", "cam": "cam_0",
                      "start": start, "aug": v} for v in range(n_vars)]
            index.append({"shard_id": sid, "row": c * n_vars, "subject": subject,
                          "action": "Walking", "cam": "cam_0", "start": start})
        writer.write(arrays, meta)
    mod.write_index(root, index, n_shards=n_shards, n_clips=len(index), n_variants=n_vars,
                    aug_names=["orig", "hflip"][:n_vars], seq_len=t, frame_skip=2,
                    feat_dtype=feat_dtype, shuffle_seed=123, shuffle_pool=16)
    return root


def three_parts(tmp_path, rng):
    return [part_store(tmp_path / "parts" / f"p{i}", rng, subject)
            for i, subject in enumerate((1, 5, 9))]


def copy_parts(parts, dest):
    out = []
    for p in parts:
        shutil.copytree(p, dest / p.name)
        out.append(dest / p.name)
    return out


# -- merge ---------------------------------------------------------------------------


@pytest.mark.parametrize("move", [True, False])
def test_merge_equals_h36x_s_merge(tmp_path, rng, move):
    parts = three_parts(tmp_path, rng)
    mine, theirs = copy_parts(parts, tmp_path / "a"), copy_parts(parts, tmp_path / "b")
    got = shards.merge_stores(mine, tmp_path / "port", move=move)
    want = jax_shards.merge_stores(theirs, tmp_path / "h36x", move=move)
    assert got == want
    assert ((tmp_path / "port" / "index.json").read_bytes()
            == (tmp_path / "h36x" / "index.json").read_bytes())
    assert got["n_shards"] == 6 and got["n_clips"] == 18
    for sid in range(6):
        assert (shards.shard_path(tmp_path / "port", sid).read_bytes()
                == shards.shard_path(tmp_path / "h36x", sid).read_bytes())
    for part in mine:
        assert (len(list(part.glob("shard_*.h36x"))) == 0) == move
        assert (part / "index.json").exists()
    assert shards.verify_store(tmp_path / "port")["errors"] == []
    ds = features.FeatureClipDataset(tmp_path / "port", subjects=[9], augment=True)
    assert len(ds) == 12 and {c["shard_id"] for c in ds.clips} == {4, 5}


def test_merge_refuses_what_h36x_refuses(tmp_path, rng):
    a = part_store(tmp_path / "a", rng, 1)
    dup = part_store(tmp_path / "dup", rng, 1)
    with pytest.raises(ValueError, match="more than one part"):
        shards.merge_stores([a, dup], tmp_path / "m1")
    assert not list((tmp_path / "m1").iterdir())  # checked before any link
    other = part_store(tmp_path / "other", rng, 5, t=6)
    with pytest.raises(ValueError, match="disagrees on seq_len"):
        shards.merge_stores([a, other], tmp_path / "m2")
    with pytest.raises(ValueError, match="no part stores"):
        shards.merge_stores([], tmp_path / "m3")
    b = part_store(tmp_path / "b", rng, 5)
    shards.merge_stores([a, b], tmp_path / "m4", move=False)
    with pytest.raises(ValueError, match="not empty"):
        shards.merge_stores([a, b], tmp_path / "m4", move=False)
    (b / "shard_00001.h36x").unlink()
    with pytest.raises(FileNotFoundError, match="missing shard_00001"):
        shards.merge_stores([a, b], tmp_path / "m5")


def test_merge_cli_verify_gate(tmp_path, rng, capsys):
    """--verify refuses a part whose payload no longer matches its CRC32;
    repaired, the merge passes and the parts stay (--keep-parts)."""
    from h36x_torch.cli.merge_shards import main as merge_main

    a, b = part_store(tmp_path / "a", rng, 1), part_store(tmp_path / "b", rng, 5)
    path = shards.shard_path(b, 0)
    blob = bytearray(path.read_bytes())
    blob[-20] ^= 0x02
    path.write_bytes(blob)
    with pytest.raises(SystemExit, match="integrity"):
        merge_main(["--parts", str(a), str(b), "--out", str(tmp_path / "m"),
                    "--verify", "--keep-parts"])
    assert "CRC32 mismatch" in capsys.readouterr().out
    assert not (tmp_path / "m" / "index.json").exists()
    blob[-20] ^= 0x02
    path.write_bytes(blob)
    idx = merge_main(["--parts", str(a), str(b), "--out", str(tmp_path / "m2"),
                      "--verify", "--keep-parts"])
    assert idx["n_clips"] == 12 and shards.shard_path(b, 0).exists()
    assert shards.verify_store(tmp_path / "m2")["errors"] == []
    assert jax_shards.verify_store(tmp_path / "m2")["errors"] == []


# -- bfloat16 ------------------------------------------------------------------------


def test_bf16_store_written_by_h36x_reads_bit_for_bit(tmp_path, rng):
    root = part_store(tmp_path / "s", rng, 1, feat_dtype="bfloat16", mod=jax_shards)
    for sid in range(2):
        got = shards.read_shard(shards.shard_path(root, sid), mmap=False)
        want = jax_shards.read_shard(jax_shards.shard_path(root, sid), mmap=False)
        assert got["feats"].dtype == np.dtype("<u2")
        assert got["feats"].tobytes() == want["feats"].tobytes()
        bf = shards.bf16_tensor(got["feats"])
        assert bf.dtype == torch.bfloat16
        np.testing.assert_array_equal(bf.float().numpy(), want["feats"].astype(np.float32))
    assert shards.verify_store(root)["errors"] == []


@pytest.mark.parametrize("given", ["tensor", "bits"])
def test_bf16_shard_bytes_equal_h36x_s(tmp_path, rng, given):
    """A torch.bfloat16 tensor, or its uint16 bits, written by the port:
    the same bytes as h36x's shard of the same values (ml_dtypes)."""
    feats = torch.from_numpy(rng.normal(size=(4, 3, 8)).astype(np.float32)).bfloat16()
    other = {"joints3d": np.zeros((4, 3, 17, 3), np.float32)}
    meta = [{"row": i} for i in range(4)]
    value = feats if given == "tensor" else shards.bf16_bits(feats)
    shards.write_shard(tmp_path / "port.h36x", {"feats": value, **other}, meta, 1)
    jax_shards.write_shard(tmp_path / "h36x.h36x",
                           {"feats": feats.float().numpy().astype(ml_dtypes.bfloat16),
                            **other}, meta, 1)
    assert (tmp_path / "port.h36x").read_bytes() == (tmp_path / "h36x.h36x").read_bytes()
    assert shards.np_dtype("bfloat16") == np.dtype("<u2")
    assert shards.dtype_name(np.dtype("<u2")) == "bfloat16"


@pytest.mark.parametrize("feed", sorted(FEED_DTYPES))
def test_bf16_store_feeds_every_feed_dtype(tmp_path, rng, feed):
    """The dataset's batch of a bf16 store holds the bits; the feed makes
    them torch.bfloat16 (never float32 on the host) and casts to the feed
    dtype: the values are h36x's batch (its feed_dtype cast) exactly."""
    root = part_store(tmp_path / "s", rng, 1, feat_dtype="bfloat16", mod=jax_shards)
    idx = [5, 0, 3, 1]
    batch = features.FeatureClipDataset(root, augment=True).get_batch(idx)
    assert batch[0].dtype == np.dtype("<u2")
    dev = to_device(batch, torch.device("cpu"), FEED_DTYPES[feed])
    assert dev[0].dtype == FEED_DTYPES[feed]
    want = jax_features.FeatureClipDataset(root, augment=True,
                                           feed_dtype=feed).get_batch(idx)
    np.testing.assert_array_equal(dev[0].float().numpy(), want[0].astype(np.float32))
    for a, b in zip(dev[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), b)


# -- the reference's .pt stores ------------------------------------------------------


def torch_store(root, rng, feat_dtype=torch.float32):
    """index.pt + shard_00000.pt / shard_00001.pt as the reference writes
    them (torch.save of dicts of tensors), subjects 1 and 5."""
    root.mkdir()
    clips = []
    for sid in range(2):
        rows = 6
        torch.save({
            "feats": torch.from_numpy(rng.normal(size=(rows, 4, 16)).astype(np.float32))
            .to(feat_dtype),
            "joints3d": torch.from_numpy((rng.normal(size=(rows, 4, 17, 3)) * 1000)
                                         .astype(np.float32)),
            "joints2d": torch.from_numpy(rng.normal(size=(rows, 4, 17, 2)).astype(np.float32)),
            "K": torch.eye(3).repeat(rows, 1, 1),
            "meta": [{"subject": 1 + 4 * sid, "row": r} for r in range(rows)],
            "n_vars": 2,
        }, root / f"shard_{sid:05d}.pt")
        clips += [{"shard_id": sid, "row": 2 * c, "subject": 1 + 4 * sid,
                   "action": "Walking", "cam": "cam_0", "start": c} for c in range(3)]
    torch.save({"clips": clips, "n_shards": 2, "n_clips": 6, "n_variants": 2,
                "aug_names": ["orig", "hflip"], "seq_len": 4, "frame_skip": 2},
               root / "index.pt")
    return root


def test_torch_store_reads_as_h36x_reads_it(tmp_path, rng):
    root = torch_store(tmp_path / "pt", rng)
    assert shards.load_index(root) == jax_shards.load_index(root)
    assert shards.load_index(root)["torch_format"] is True
    for subjects, augment in (([1, 5], True), ([5], False)):
        got = features.FeatureClipDataset(root, subjects=subjects, augment=augment,
                                          test_set=True)
        want = jax_features.FeatureClipDataset(root, subjects=subjects, augment=augment,
                                               test_set=True)
        assert got.torch_format and len(got) == len(want)
        idx = list(range(len(got)))[::-1]
        for a, b in zip(got.get_batch(idx), want.get_batch(idx)):
            if isinstance(b, list):
                assert a == b
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no integrity records"):
        shards.verify_store(root)
    with pytest.raises(ValueError, match="torch-format"):
        shards.merge_stores([root], tmp_path / "merged")


def test_bf16_torch_store_feeds_bf16(tmp_path, rng):
    """A .pt store of bfloat16 tensors: the shard loader keeps their bits,
    the feed gives the same tensor values."""
    root = torch_store(tmp_path / "pt", rng, feat_dtype=torch.bfloat16)
    shard = shards.load_torch_shard(root, 1)
    want = torch.load(root / "shard_00001.pt", weights_only=True)["feats"]
    assert torch.equal(shards.bf16_tensor(shard["feats"]), want)
    batch = features.FeatureClipDataset(root, augment=True).get_batch([7, 6])
    feats = to_device(batch, torch.device("cpu"))[0]
    assert feats.dtype == torch.bfloat16 and torch.equal(feats, want[[1, 0]])  # clip 3 of 6: shard 1, rows 0-1


def test_missing_index_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"no index.json \(or reference index.pt\)"):
        shards.load_index(tmp_path)
