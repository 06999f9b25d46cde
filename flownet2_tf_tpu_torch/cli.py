"""CLI of the torch port: ``python -m flownet2_tf_tpu_torch.cli test ...``.

Port of the ``test`` subcommand of ``flownet2_tf_tpu/cli.py``: single-pair
inference -> ``.flo`` / flow PNG, and the same JSON line on stdout. The
device is explicit (``--device``, default ``cuda``). The other subcommands
and the approximation knobs (``--half_res_warp``, ``--warp_res``,
``--fusion_res``, ``--f32_features``) and spatial tiling are not ported
yet.
"""

from __future__ import annotations

import argparse
import json
import sys


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

    p = sub.add_parser("test", help="single-pair inference")
    p.add_argument(
        "--model", default="s",
        help="model name: s, c, cs, css, sd, 2 (or flownet_* aliases)",
    )
    p.add_argument("--ckpt", default=None,
                   help="JAX-layout .npz; default: "
                        "./checkpoints/<Model>/<model>.npz")
    p.add_argument("--input_a", required=True)
    p.add_argument("--input_b", required=True)
    p.add_argument("--out", default="./")
    p.add_argument("--no_image", action="store_true")
    p.add_argument("--no_flo", action="store_true")
    p.add_argument("--compute_dtype", default="float32", choices=["float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1, cpu (no fallback: "
                        "cuda without a GPU raises)")
    p.set_defaults(fn=cmd_test)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
