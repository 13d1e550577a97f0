"""Write tests/golden/orbax_v1/ and tests/golden/orbax_v1.npz with h36x.

h36x's `save_checkpoint_orbax` of a phase-1 TrainState (latent 64,
feature 32, one residual block per net, groups 8, regressor hidden 64)
after two AdamW steps on a seeded batch, so that mu, nu and the counts are
not zero; the npz holds every array of the same state under its '/'-joined
tree path. The JAX package reads the directory with orbax, the port with
its own OCDBT / zarr / zstd reader (tests/test_torch_orbax.py, and
chip_smoke.py on the card). Run from the repository root on a CPU:

    JAX_PLATFORMS=cpu python scripts/make_orbax_golden.py
"""

import dataclasses
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from h36x.config import TrainConfig  # noqa: E402
from h36x.models.phd import PHDFor3DJoints  # noqa: E402
from h36x.train import checkpoint as ckpt  # noqa: E402
from h36x.train.state import create_train_state, make_optimizer  # noqa: E402
from h36x.train.step import make_train_step  # noqa: E402

ARCH = dict(latent_dim=64, feature_dim=32, num_blocks=1, ar_num_blocks=1, groups=8,
            regressor_hidden=64, dropout=0.0)
OUT = ROOT / "tests" / "golden"


def flat(tree, prefix=""):
    out = {}
    items = tree._asdict().items() if hasattr(tree, "_asdict") else (
        tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, path + "/"))
        elif hasattr(v, "shape"):
            out[path] = np.asarray(v)
    return out


def main():
    cfg = TrainConfig()
    cfg.model = dataclasses.replace(cfg.model, **ARCH)
    cfg.data.seq_len = 8
    m = cfg.model
    model = PHDFor3DJoints(latent_dim=m.latent_dim, feature_dim=m.feature_dim,
                           number_blocks=m.num_blocks, ar_blocks=m.ar_num_blocks,
                           groups=m.groups, regressor_hidden=m.regressor_hidden,
                           dropout=m.dropout)
    tx, _ = make_optimizer(1e-3)
    state = create_train_state(model, tx, jax.random.key(12), jnp.zeros((2, 8, 32)))
    step = make_train_step(model, tx, donate=False)
    rng = np.random.default_rng(12)
    batch = (rng.standard_normal((4, 8, 32)).astype(np.float32),
             rng.standard_normal((4, 8, 17, 3)).astype(np.float32),
             rng.standard_normal((4, 8, 17, 2)).astype(np.float32),
             np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)))
    for i in range(2):
        state, _ = step(state, batch, jax.random.key(i))
    shutil.rmtree(OUT / "orbax_v1", ignore_errors=True)
    ckpt.save_checkpoint_orbax(OUT / "orbax_v1", "last", state, epoch=1, best_val=0.5,
                               config=dataclasses.asdict(cfg), extra={"no_improve": 0})
    np.savez(OUT / "orbax_v1.npz", **flat(jax.device_get(state)))


if __name__ == "__main__":
    main()
