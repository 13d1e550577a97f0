"""Shared CLI plumbing: checkpoint-recorded model-config resolution
(counterpart of h36x/cli/common.py).

The training config is recorded in the checkpoint manifest; the CLIs
resolve the architecture back from it. Shape-visible mismatches
(latent_dim, num_blocks) fail loudly at param restore; `groups` and
`regressor_iters` change the math but not the params, so a mismatch would
evaluate silently wrong — which is why flags that contradict the manifest
raise.
"""

from __future__ import annotations

import dataclasses

from h36x_torch.config import ModelConfig

# ModelConfig fields that define the architecture a checkpoint was trained with
ARCH_FIELDS = (
    "latent_dim", "feature_dim", "joints_num", "num_blocks",
    "ar_num_blocks", "groups", "kernel_size", "regressor_iters",
    "regressor_hidden",
)


def resolve_model_config(model_path, cli_values: dict,
                         ignore_recorded: bool = False) -> dict:
    """Merge model hyper-parameters: defaults <- recorded <- explicit flags.

    `cli_values` maps ARCH_FIELDS names to argparse values (None = flag not
    given). A flag that contradicts the manifest-recorded value raises
    SystemExit naming both (unless ignore_recorded). Returns a full dict
    over ARCH_FIELDS."""
    from h36x_torch.train.checkpoint import load_recorded_model_config

    defaults = dataclasses.asdict(ModelConfig())
    recorded = {} if ignore_recorded else load_recorded_model_config(model_path)

    resolved = {}
    conflicts = []
    from_manifest = []
    for field in ARCH_FIELDS:
        flag = cli_values.get(field)
        rec = recorded.get(field)
        if flag is not None and rec is not None and flag != rec:
            conflicts.append(f"{field}: flag {flag!r} vs recorded {rec!r}")
        if flag is not None:
            resolved[field] = flag
        elif rec is not None:
            resolved[field] = rec
            if rec != defaults[field]:
                from_manifest.append(f"{field}={rec}")
        else:
            resolved[field] = defaults[field]
    if conflicts:
        raise SystemExit(
            "model flags contradict the architecture recorded in the "
            f"checkpoint manifest next to {model_path}:\n  "
            + "\n  ".join(conflicts)
            + "\n(drop the flags to use the recorded config, or pass "
            "--ignore-model-config to override it deliberately)")
    if from_manifest:
        print("Model config from checkpoint manifest: " + " ".join(from_manifest))
    return resolved


def build_model_from_arch(mc: dict, *, generator=None, device=None):
    """PHDFor3DJoints from a resolved ARCH_FIELDS dict — one constructor
    call for every consumer."""
    from h36x_torch.models.phd import PHDFor3DJoints

    return PHDFor3DJoints(
        latent_dim=mc["latent_dim"],
        feature_dim=mc["feature_dim"],
        joints_num=mc["joints_num"],
        number_blocks=mc["num_blocks"],
        ar_blocks=mc["ar_num_blocks"],
        groups=mc["groups"],
        kernel_size=mc["kernel_size"],
        regressor_iters=mc["regressor_iters"],
        regressor_hidden=mc["regressor_hidden"],
        generator=generator,
        device=device,
    )


def add_model_config_flags(parser):
    """Register the standard model-shape flags with a None default (so
    "not given" differs from "typed the default"), plus
    --ignore-model-config."""
    helps = {
        "latent_dim": "f_movie latent width",
        "num_blocks": "f_movie residual depth",
        "groups": "GroupNorm groups (shape-invisible: a mismatch with the "
                  "training config evaluates silently wrong)",
        "regressor_iters": "joint-regressor refinement rounds "
                           "(shape-invisible too)",
    }
    for field, text in helps.items():
        parser.add_argument(f"--{field.replace('_', '-')}", type=int,
                            default=None,
                            help=f"{text}; default: the "
                                 "value recorded in the checkpoint manifest "
                                 "(falls back to the training default)")
    parser.add_argument("--ignore-model-config", action="store_true",
                        help="ignore the architecture recorded in the "
                             "checkpoint manifest and use flags/defaults")
