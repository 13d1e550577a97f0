"""CLI: online serving daemon with dynamic batching
(h36x_torch/serve_daemon.py; counterpart of h36x/cli/serve.py).

    python -m h36x_torch.cli.serve --artifact phd.pt2 [--device cpu]
    python -m h36x_torch.cli.serve --model-path runs/best.msgpack [--device cpu]

serves an artifact of h36x_torch.cli.export (weights, architecture and
window baked in; batches padded to pre-warmed power-of-two buckets, or to
the batch of an artifact exported with a fixed --batch; a rollout artifact
replies with its own output shape and the "split" of its context rows) or a training checkpoint (h36x's or the port's `.msgpack`,
through the port's CUDA kernels). Both run on the GPU; `--device cpu` runs
them on the CPU instead. `--stats` queries a RUNNING daemon (counts,
coalesced batch sizes, device/request latency percentiles) and exits.
"""

import argparse
import asyncio
import json

from h36x_torch.config import FEATURE_DIM, SEQ_LEN


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--artifact", default="",
                     help="artifact from h36x_torch.cli.export (a symbolic "
                          "batch serves all sizes, padded to pre-warmed "
                          "power-of-two buckets; a fixed batch, every batch "
                          "padded to it)")
    src.add_argument("--model-path", default="", help="checkpoint .msgpack")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; "
                        "'cpu' runs the plain PyTorch path)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7036)
    p.add_argument("--unix", default="", help="unix socket path (overrides "
                                              "host/port)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="wire T; default: the artifact's input shape / the "
                        "checkpoint manifest's data.seq_len (falls back to "
                        f"{SEQ_LEN})")
    p.add_argument("--feature-dim", type=int, default=None,
                   help="wire D; default: the artifact's input shape / the "
                        "checkpoint manifest's model.feature_dim (falls back "
                        f"to {FEATURE_DIM})")
    from h36x_torch.cli.common import add_model_config_flags, resolve_model_config

    add_model_config_flags(p)
    p.add_argument("--max-batch", type=int, default=None,
                   help="largest coalesced batch (default 16; an artifact "
                        "exported with a fixed --batch: that batch, and no "
                        "more)")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=1024,
                   help="reject requests past this queue depth with an "
                        "explicit overload error instead of queueing "
                        "without bound (0 = unbounded)")
    p.add_argument("--drain-s", type=float, default=10.0,
                   help="on SIGTERM/SIGINT: stop accepting and give queued "
                        "+ in-flight batches this long to finish before "
                        "stopping (graceful rolling-restart shutdown)")
    p.add_argument("--stats", action="store_true",
                   help="query a RUNNING daemon's operational stats "
                        "(request/batch counts, latency percentiles) at "
                        "--host/--port or --unix, print JSON, and exit")
    args = p.parse_args(argv)

    if args.stats:
        if args.artifact or args.model_path:
            raise SystemExit(
                "--stats queries a running daemon — it takes no model "
                "source; drop --artifact/--model-path")
        from h36x_torch.serve_daemon import get_stats

        bind = ({"unix_path": args.unix} if args.unix
                else {"host": args.host, "port": args.port})
        print(json.dumps(get_stats(**bind, timeout_s=10.0), indent=2))
        return
    if not args.artifact and not args.model_path:
        raise SystemExit(
            "one of --artifact or --model-path is required (or --stats)")
    # artifact mode has the weights AND architecture baked in — an explicit
    # model flag cannot take effect, and silently ignoring it would let an
    # operator believe it did
    if args.artifact:
        ignored = [name for name, v in
                   (("--latent-dim", args.latent_dim),
                    ("--num-blocks", args.num_blocks),
                    ("--groups", args.groups),
                    ("--regressor-iters", args.regressor_iters))
                   if v is not None]
        if ignored:
            raise SystemExit(
                f"{' '.join(ignored)}: artifact mode serves the architecture "
                "baked into the artifact at export time — these flags cannot "
                "take effect; drop them (re-export with h36x_torch.cli.export "
                "to change the architecture)")

    from h36x_torch.serve_daemon import BatchingServer, build_predict_fn, serve_forever
    from h36x_torch.train.checkpoint import load_recorded_config

    mc = resolve_model_config(
        args.model_path,
        {"latent_dim": args.latent_dim, "num_blocks": args.num_blocks,
         "groups": args.groups, "regressor_iters": args.regressor_iters},
        ignore_recorded=args.ignore_model_config or bool(args.artifact))

    # wire shapes (T, D): the artifact's input shape / the checkpoint
    # manifest are authoritative — a hand-typed mismatch would reject or
    # mis-shape every request
    seq_len, feature_dim = args.seq_len, args.feature_dim
    if args.artifact:
        from h36x_torch.export import artifact_input_shape

        art_b, art_t, art_d = artifact_input_shape(args.artifact)
        for flag, art, name in ((seq_len, art_t, "--seq-len"),
                                (feature_dim, art_d, "--feature-dim")):
            if flag is not None and flag != art:
                raise SystemExit(
                    f"{name} {flag} contradicts the artifact's input shape "
                    f"(T={art_t}, D={art_d}) — drop the flag; the artifact "
                    "is authoritative")
        seq_len, feature_dim = art_t, art_d
    else:
        art_b = None
        if feature_dim is None:
            feature_dim = mc["feature_dim"]
        if seq_len is None and not args.ignore_model_config:
            seq_len = ((load_recorded_config(args.model_path).get("data") or {})
                       .get("seq_len"))
        if seq_len is None:
            seq_len = SEQ_LEN
    print(f"wire shapes: T={seq_len} D={feature_dim}")
    max_batch = args.max_batch or art_b or 16
    if art_b is not None and max_batch > art_b:
        raise SystemExit(
            f"--max-batch {max_batch} exceeds the artifact's fixed batch "
            f"{art_b}: drop the flag, or re-export without --batch")

    predict_fn, pad_to = build_predict_fn(
        artifact=args.artifact, model_path=args.model_path,
        seq_len=seq_len, feature_dim=feature_dim,
        latent_dim=mc["latent_dim"], num_blocks=mc["num_blocks"],
        groups=mc["groups"], ar_blocks=mc["ar_num_blocks"],
        kernel_size=mc["kernel_size"], joints_num=mc["joints_num"],
        regressor_hidden=mc["regressor_hidden"],
        regressor_iters=mc["regressor_iters"],
        max_batch=max_batch, warm=True, device=args.device,
    )
    server = BatchingServer(
        predict_fn, seq_len=seq_len, feature_dim=feature_dim,
        max_batch=max_batch, max_wait_ms=args.max_wait_ms, pad_to=pad_to,
        bucket_pad=bool(args.artifact), max_queue=args.max_queue,
    )
    bind = ({"unix_path": args.unix} if args.unix
            else {"host": args.host, "port": args.port})
    try:
        asyncio.run(serve_forever(server, drain_s=args.drain_s, **bind))
    except KeyboardInterrupt:
        pass  # platforms where the loop signal handler is unavailable


if __name__ == "__main__":
    main()
