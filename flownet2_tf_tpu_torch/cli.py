"""CLI of the torch port: ``python -m flownet2_tf_tpu_torch.cli {train,test}``.

Port of two subcommands of ``flownet2_tf_tpu/cli.py``:

* ``train``: training on the procedural ``--synthetic`` dataset, bf16 by
  default as in the JAX package (``--compute_dtype float32`` for the f32
  path), with the JAX flags this port supports (schedule, checkpoints and
  resume, warm starts, ``--grad_accum``, ``--eval_every``,
  ``--transfer_flow_dtype``); one JSON line per logged step. The dataset
  readers, ``--remat``, image summaries and data parallelism are not
  ported yet.
* ``test``: single-pair inference, f32 by default or
  ``--compute_dtype bfloat16`` -> ``.flo`` / flow PNG, and the same JSON
  line on stdout.

The device is explicit (``--device``, default ``cuda``; ``cuda`` without a
card raises). The other subcommands, the approximation knobs
(``--half_res_warp``, ``--warp_res``, ``--fusion_res``, ``--f32_features``)
and spatial tiling are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_warm_start_spec(spec: str):
    """``PATH:SRC_SCOPE:DST_SCOPE`` -> a ``(path, src, dst)`` tuple (a
    tuple list, so two specs may splice two scopes of one checkpoint)."""
    parts = spec.rsplit(":", 2)
    if len(parts) != 3 or not parts[0]:
        raise SystemExit(
            f"--warm_start: malformed spec {spec!r}; expected "
            "PATH:SRC_SCOPE:DST_SCOPE (SRC may be empty to splice the "
            "whole checkpoint, e.g. ./logs/flownet_c::FlowNetC)"
        )
    return tuple(parts)


def cmd_train(args):
    from flownet2_tf_tpu_torch.data.loader import (
        BatchLoader,
        SyntheticFlowDataset,
    )
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    if not args.synthetic:
        raise ValueError(
            "train: only --synthetic data is supported by the torch port; "
            "the dataset readers (FlyingChairs, Things3D, Sintel, "
            "TFRecords) are ROADMAP Queue 1 item 19"
        )
    cfg = TrainConfig(
        model=args.model,
        schedule=args.schedule,
        log_dir=args.log_dir or f"./logs/flownet_{args.model}",
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        augment=not args.no_augment,
        max_steps=args.max_steps,
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every,
        grad_accum=args.grad_accum,
        eval_every=args.eval_every,
        transfer_flow_dtype=args.transfer_flow_dtype,
        device=args.device,
    )
    trainer = Trainer(cfg)
    batch_size = args.batch_size or 8
    ds = SyntheticFlowDataset(
        size=args.synthetic_size, height=args.synthetic_height,
        width=args.synthetic_width, seed=args.seed,
    )
    loader = BatchLoader(ds, batch_size=batch_size)
    # crop must stay a multiple of 64 (model stride constraint)
    preprocess = None if args.no_augment else {
        "crop_height": max(64, args.synthetic_height // 64 * 64),
        "crop_width": max(64, args.synthetic_width // 64 * 64),
        "image_a": {},
        "image_b": {},
    }
    eval_loader = None
    if args.eval_every:
        eval_ds = SyntheticFlowDataset(
            size=max(16, batch_size * 2), height=args.synthetic_height,
            width=args.synthetic_width, seed=args.seed + 9999,
        )
        eval_loader = BatchLoader(eval_ds, batch_size=batch_size,
                                  shuffle=False)
    warm = None
    if args.warm_start:
        warm = [parse_warm_start_spec(spec) for spec in args.warm_start]
    trainer.fit(loader, preprocess=preprocess, warm_start_checkpoints=warm,
                eval_loader=eval_loader)
    return 0


def cmd_test(args):
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.training import infer

    ckpt = args.ckpt
    if ckpt is None:
        # reference default-path convention
        name = get_model(args.model).name
        ckpt = f"./checkpoints/{name}/{name.lower()}.npz"
    flow = infer.test_pair(
        args.model,
        ckpt,
        args.input_a,
        args.input_b,
        args.out,
        save_image=not args.no_image,
        save_flo=not args.no_flo,
        compute_dtype=args.compute_dtype,
        device=args.device,
    )
    print(
        json.dumps(
            {
                "model": args.model,
                "out_dir": args.out,
                "flow_shape": list(flow.shape),
                "mean_magnitude": float(
                    (flow[..., 0] ** 2 + flow[..., 1] ** 2).mean() ** 0.5
                ),
            }
        )
    )
    return 0


def build_parser():
    parser = argparse.ArgumentParser(
        prog="flownet2_tf_tpu_torch",
        description="FlowNet 2.0 on PyTorch/CUDA (port of flownet2_tf_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a model (synthetic data)")
    _add_model_arg(p)
    p.add_argument("--schedule", default="long",
                   help="long (S_long), fine (S_fine), short")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--checkpoint_every", type=int, default=2500)
    p.add_argument("--eval_every", type=int, default=0,
                   help="evaluate validation EPE every N steps")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="run each step as N equal microbatches, averaging "
                        "gradients (batch size must divide by N)")
    p.add_argument("--transfer_flow_dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"],
                   help="host->device GT-flow dtype (cast back to f32 on "
                        "the device)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the procedural dataset (no downloads); "
                        "required: the dataset readers are not ported yet")
    p.add_argument("--synthetic_size", type=int, default=512)
    p.add_argument("--synthetic_height", type=int, default=128)
    p.add_argument("--synthetic_width", type=int, default=128)
    p.add_argument(
        "--warm_start", action="append", default=None,
        metavar="PATH:SRC_SCOPE:DST_SCOPE",
        help="splice a prior-stage checkpoint (a .npz or a run directory), "
             "e.g. ./logs/flownet_c::FlowNetC (repeatable)",
    )
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("test", help="single-pair inference")
    _add_model_arg(p)
    p.add_argument("--ckpt", default=None,
                   help="JAX-layout .npz; default: "
                        "./checkpoints/<Model>/<model>.npz")
    p.add_argument("--input_a", required=True)
    p.add_argument("--input_b", required=True)
    p.add_argument("--out", default="./")
    p.add_argument("--no_image", action="store_true")
    p.add_argument("--no_flo", action="store_true")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    _add_device_arg(p)
    p.set_defaults(fn=cmd_test)
    return parser


def _add_model_arg(p):
    p.add_argument(
        "--model", default="s",
        help="model name: s, c, cs, css, sd, 2 (or flownet_* aliases)",
    )


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1, cpu (no fallback: "
                        "cuda without a GPU raises)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
