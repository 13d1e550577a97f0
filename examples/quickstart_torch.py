"""h36x_torch quickstart: the port's whole main path on synthetic data, end
to end, with models drawn from a seed: extraction (ResNet-50), phase-1
training of PHD, then the batch forward, streaming and the AR rollout.

Run:  python examples/quickstart_torch.py               (on the card)
      python examples/quickstart_torch.py --device cpu  (the plain path)

The sizes are small enough for a CPU. On the card every op runs its
hand-written Hopper kernel; without a card, pass --device cpu.
"""

import argparse
import tempfile

import numpy as np
import torch

from h36x_torch.config import ExtractConfig, TrainConfig
from h36x_torch.data.clips import ClipIndex
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.data.sampler import MixedShardBatchSampler, SequentialBatchSampler
from h36x_torch.extract.pipeline import run_extract
from h36x_torch.infer import make_fused_forward
from h36x_torch.models.phd import param_tree
from h36x_torch.serve import StreamingPredictor, make_rollout_fn
from h36x_torch.train.loop import fit


class SyntheticClips:
    """Stands in for an ingested H36M tree (see h36x_torch.cli.ingest)."""

    def __init__(self, n=12, t=8, hw=64):
        self.n, self.t, self.hw = n, t, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        frames = rng.integers(0, 256, size=(self.t, self.hw, self.hw, 3)).astype(np.uint8)
        j3d = rng.normal(size=(self.t, 17, 3)).astype(np.float32) * 100
        j2d = (rng.random((self.t, 17, 2)) * 40 + 12).astype(np.float32)
        cam = {"f": np.array([90.0, 90.0]), "c": np.array([32.0, 32.0]),
               "k": np.zeros(5), "rt": np.eye(3), "t": np.zeros(3)}
        ci = ClipIndex("synthetic.mp4", "synthetic.pkl", 1 + i % 2, "Demo_0",
                       "cam_0", cam, i * 4, i * 4 + self.t)
        return frames, j3d, j2d, cam, ci


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="default: cuda")
    device = p.parse_args(argv).device
    with tempfile.TemporaryDirectory() as store, tempfile.TemporaryDirectory() as runs:
        # 1) feature extraction: crops + augmentation on the host, the
        #    backbone (random weights from seed 0) on the device
        run_extract(
            ExtractConfig(out=store, seq_len=8, resize=32, batch_size=4,
                          num_workers=2, augment=True, shard_size=4,
                          shuffle_pool=64),
            dataset=SyntheticClips(), device=device,
        )

        # 2) phase-1 training over the shard store
        cfg = TrainConfig()
        cfg.outdir = runs
        cfg.data.seq_len = 8
        cfg.model.latent_dim = 64
        cfg.model.num_blocks = 1
        cfg.optim.epochs = 2
        cfg.optim.batch_size = 4
        cfg.optim.log_every = 0
        train_set = FeatureClipDataset(store, subjects=[1], augment=True)
        val_set = FeatureClipDataset(store, subjects=[2])
        model, best = fit(
            cfg, train_set, val_set,
            MixedShardBatchSampler(train_set, 4, shards_per_batch=2, seed=0),
            SequentialBatchSampler(val_set, 4), device=device,
        )
        print(f"\nbest val MPJPE: {best:.3f} m")

        # 3) inference: batch forward, streaming, and the AR rollout
        feats = val_set.get_batch([0])[0]
        x = torch.from_numpy(feats).to(model.input_proj.kernel.device)
        params = param_tree(model)
        forward = make_fused_forward(params, groups=cfg.model.groups, precise=True)
        print("batch joints:", tuple(forward(x).shape))

        sp = StreamingPredictor(params, window=8, feature_dim=feats.shape[-1],
                                groups=cfg.model.groups, device=x.device)
        for t in range(8):
            joints_t = sp.push(feats[0, t])
        print("streaming last-frame joints:", tuple(joints_t.shape))
        print("AR 5-step forecast:", tuple(sp.forecast(5).shape))
        _, future = make_rollout_fn(params, steps=5, groups=cfg.model.groups,
                                    device=x.device)(x)
        print("batch rollout:", tuple(future.shape))


if __name__ == "__main__":
    main()
