"""CLI of the torch port: ``python -m flownet2_tf_tpu_torch.cli
{train,test,eval,bench,profile,make-tfrecords,convert,export,serve,info}``.

Port of the ten subcommands of ``flownet2_tf_tpu/cli.py``:

* ``train``: training, bf16 by default as in the JAX package
  (``--compute_dtype float32`` for the f32 path), on a dataset's raw
  layout (``--dataset``, ``--data_root``) or its TFRecords
  (``--tfrecords_train``/``--tfrecords_val``, fed as uint8 images), or on
  the procedural ``--synthetic`` dataset, with the JAX flags this port
  supports (schedule, checkpoints and resume, warm starts,
  ``--grad_accum``, ``--eval_every``, ``--transfer_flow_dtype``,
  ``--remat``, ``--image_summary_every``); one JSON line per logged step.
  ``--multihost`` joins the process group the launcher's environment
  names (torchrun's, or the JAX package's manual names) and trains with
  DDP: NCCL on the card, gloo on the CPU.
* ``test``: single-pair inference, f32 by default or
  ``--compute_dtype bfloat16`` -> ``.flo`` / flow PNG, and the same JSON
  line on stdout; ``--spatial_tiles N`` runs the pair as N
  halo-overlapped bands, spread over the visible devices of
  ``--device``'s platform in groups (one batch on one card).
* ``eval``: dataset AEE (Sintel, KITTI, FlyingChairs, FlyingThings3D,
  ChairsSDHom, TFRecords or synthetic), the JAX package's flags and JSON
  line; ``--save_outputs`` also writes each predicted flow.
* ``make-tfrecords``: raw FlyingChairs -> reference-layout TFRecords.
* ``convert``: a TF1 checkpoint (a V2 bundle, read with no TensorFlow by
  ``tools/tf1_bundle.py``) -> JAX-layout ``.npz`` weights, checked
  against the model's parameter shapes, then the semantic canary on the
  bundled sample pair on ``--device`` (``--no_canary`` skips it); one
  JSON line.
* ``export``: a port checkpoint or run directory -> JAX-layout ``.npz``
  weights, or with ``--aot`` a ``.flowpak`` serving artifact
  (``tools/aot.py``; ``--shapes`` for a multi-shape bundle,
  ``--spatial_tiles`` for a single-pair graph over halo-overlapped
  bands, ``--data_parallel N`` for N replicas that split each batch,
  ``--platforms cuda,cpu`` for one graph per platform in one artifact),
  bf16 with half-res stack warps by default, as in the JAX package.
* ``serve``: a ``.flowpak`` on an image pair, with no model code loaded,
  on ``--device`` (default: the card when the artifact has a CUDA
  graph); a ``--data_parallel N`` artifact on the first N devices of
  that platform (N replicas on the CPU; fewer cards than N raise).
* ``bench``: frame pairs/s of a model forward (``tools/bench.py``): the
  median of gated samples, CUDA-event times on a card, one JSON line.
* ``profile``: ``iters`` forwards under ``torch.profiler``
  (``tools/profiler.py``): a Chrome trace, and the time per kernel and
  per layer scope; the last line is ``{"trace_dir": ...}``.
* ``info``: per-scope parameter counts; ``--flops`` counts the forward's
  FLOPs with ``torch.utils.flop_counter`` (``tools/benchlib.py``).

The model subcommands (``train``, ``test``, ``eval``, ``bench``,
``profile``, and ``convert``'s canary) take the JAX package's
approximation knobs, each a build argument of the model
(``ModelSpec.build_for``; a model that does not read a knob runs
unchanged):

* ``--warp_res {1,2,4}`` (or ``--half_res_warp`` = 2): the stacked
  models' stack warps on that grid;
* ``--fusion_res 2``: FlowNet2's fusion net on a half-resolution input;
* ``--f32_features default``: the f32 path's feature layers in TF32 (the
  JAX package's DEFAULT precision; ``highest``, the default, is exact);
* ``FLOWNET2_TPU_BF16_INTERCONV=1`` in the environment (the JAX
  package's switch, read here and passed on as ``bf16_interconv``): the
  interconvs of FlowNetSD and FlowNet2 follow the bf16 compute dtype.
  ``export --aot`` bakes it in too, and records it in ``meta.json``.

The device is explicit (``--device``, default ``cuda``; ``cuda`` without a
card raises; on ``cpu`` the bench and the profiler report CPU times).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
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
    from flownet2_tf_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed,
        shutdown_distributed,
    )

    # before the Trainer: it wraps its model in DDP when in a group
    maybe_initialize_distributed(args.multihost, device=args.device)
    try:
        return _train(args)
    finally:
        shutdown_distributed()


def _train(args):
    from flownet2_tf_tpu_torch.data.dataset_configs import get_dataset_config
    from flownet2_tf_tpu_torch.data.loader import (
        BatchLoader,
        SyntheticFlowDataset,
        load_batch,
    )
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

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
        image_summary_every=args.image_summary_every,
        remat=args.remat,
        grad_accum=args.grad_accum,
        eval_every=args.eval_every,
        transfer_flow_dtype=args.transfer_flow_dtype,
        device=args.device,
        **_knobs(args),
    )
    trainer = Trainer(cfg)
    eval_loader = None
    if args.synthetic:
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
        if args.eval_every:
            eval_ds = SyntheticFlowDataset(
                size=max(16, batch_size * 2), height=args.synthetic_height,
                width=args.synthetic_width, seed=args.seed + 9999,
            )
            eval_loader = BatchLoader(eval_ds, batch_size=batch_size,
                                      shuffle=False)
    else:
        dataset_config = copy.deepcopy(get_dataset_config(args.dataset))
        paths = dataset_config.setdefault("PATHS", {})
        if args.batch_size:
            dataset_config["BATCH_SIZE"] = args.batch_size
        if args.data_root:
            dataset_config["RAW_ROOT"] = args.data_root
        if args.tfrecords_train:
            paths["train"] = args.tfrecords_train
        if args.tfrecords_val:
            paths["validate"] = args.tfrecords_val
        if args.image_height:
            dataset_config["IMAGE_HEIGHT"] = args.image_height
        if args.image_width:
            dataset_config["IMAGE_WIDTH"] = args.image_width
        if args.crop_height:
            dataset_config["PREPROCESS"]["crop_height"] = args.crop_height
        if args.crop_width:
            dataset_config["PREPROCESS"]["crop_width"] = args.crop_width
        loader, preprocess = load_batch(dataset_config, "train")
        if args.eval_every:
            try:
                eval_loader, _ = load_batch(dataset_config, "validate")
            except (FileNotFoundError, ValueError) as e:
                # ValueError: a raw layout with no validate split (sintel)
                print(f"warning: no validate split ({e}); skipping eval",
                      flush=True)
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
        spatial_tiles=args.spatial_tiles,
        spatial_overlap=args.spatial_overlap,
        **_knobs(args),
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


def cmd_eval(args):
    from flownet2_tf_tpu_torch.training.infer import evaluate_dataset
    from flownet2_tf_tpu_torch.training.warmstart import load_params_tree

    dataset = _make_eval_dataset(args)
    params = load_params_tree(args.ckpt)
    if args.save_outputs:
        aee, n = _eval_saving_outputs(args, dataset, params)
    else:
        aee = evaluate_dataset(
            args.model, params, dataset,
            compute_dtype=args.compute_dtype, limit=args.limit,
            verbose=args.verbose, batch_size=args.eval_batch,
            device=args.device, **_knobs(args),
        )
        n = min(len(dataset), args.limit or len(dataset))
    print(json.dumps({
        "model": args.model, "dataset": args.dataset,
        "pairs": n,
        "aee": aee,
        **({"outputs": args.save_outputs} if args.save_outputs else {}),
    }))
    return 0


def _eval_saving_outputs(args, dataset, params):
    """One pass that fetches each predicted flow (host-side masked AEE,
    ``sqrt(sum d^2) * valid`` with no eps) and writes
    <dir>/NNNNNN_flow.{flo,png}, plus a KITTI 16-bit PNG
    (NNNNNN_flow_kitti.png) when the GT carries a validity channel.
    Slower than the on-device AEE path: full flow fields cross to the
    host. ``--eval_batch`` batches consecutive same-shape pairs."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.models.common import compute_dtype_of
    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils import flowlib

    cd = compute_dtype_of(args.compute_dtype)
    device = infer.resolve_device(args.device)
    model = infer.inference_model(args.model, params, device, cd,
                                  **_knobs(args))
    os.makedirs(args.save_outputs, exist_ok=True)
    n = min(len(dataset), args.limit or len(dataset))
    batch = max(1, int(args.eval_batch))
    aee_sum = 0.0
    i = 0
    pending = None  # item already fetched past a shape-bucket boundary
    while i < n:
        items = [dataset[i] if pending is None else pending]
        pending = None
        shape = items[0]["image_a"].shape
        while len(items) < batch and i + len(items) < n:
            nxt = dataset[i + len(items)]
            if nxt["image_a"].shape != shape:
                pending = nxt  # carry over; don't decode it twice
                break
            items.append(nxt)
        a, b = (torch.from_numpy(np.stack([it[k] for it in items]).astype(
                    np.float32, copy=False)).to(device)
                for k in ("image_a", "image_b"))
        flows = infer.forward_flow(model, a, b, cd).cpu().numpy()
        for j, item in enumerate(items):
            flow = flows[j]
            gt = np.asarray(item["flow"], np.float32)
            if gt.shape[-1] == 3:  # KITTI [u, v, valid]
                valid = gt[..., 2]
                gt = gt[..., :2]
            else:
                valid = np.ones(gt.shape[:2], np.float32)
            epe = np.sqrt(((flow - gt) ** 2).sum(-1)) * valid
            aee = float(epe.sum()) / max(float(valid.sum()), 1.0)
            aee_sum += aee
            stem = os.path.join(args.save_outputs, f"{i + j:06d}_flow")
            flowlib.write_flow(flow, stem + ".flo")
            flowlib.write_flow_png(flow, stem + ".png")
            if item["flow"].shape[-1] == 3:
                # KITTI-benchmark submission format
                flowlib.write_kitti_png_flow(flow, stem + "_kitti.png")
            if args.verbose:
                print(f"  [{i + j + 1}/{n}] AEE {aee:.4f} -> {stem}")
        i += len(items)
    return aee_sum / max(n, 1), n


def _make_eval_dataset(args):
    from flownet2_tf_tpu_torch.data import loader as L

    if args.tfrecords:
        if not (args.image_height and args.image_width):
            raise SystemExit(
                "--tfrecords eval needs --image_height/--image_width"
            )
        return L.TFRecordFlowDataset(
            args.tfrecords, args.image_height, args.image_width
        )
    name = args.dataset.lower()
    if name == "synthetic":
        return L.SyntheticFlowDataset(
            size=args.limit or 8, height=128, width=128, seed=0
        )
    if name == "sintel":
        return L.SintelDataset(args.data_root, render_pass=args.render_pass)
    if name == "kitti":
        return L.KittiDataset(args.data_root)
    if name in ("chairs", "flying_chairs"):
        return L.FlyingChairsRawDataset(args.data_root)
    if name in ("things", "flying_things_3d"):
        return L.FlyingThings3DDataset(args.data_root)
    if name in ("sdhom", "chairs_sdhom"):
        return L.ChairsSDHomDataset(args.data_root)
    raise SystemExit(f"unknown eval dataset {args.dataset!r}")


def cmd_bench(args):
    from flownet2_tf_tpu_torch.tools import bench as bench_mod

    result = bench_mod.run_bench(
        model=args.model,
        height=args.height,
        width=args.width,
        batch=args.batch,
        iters=args.iters,
        compute_dtype=args.compute_dtype,
        device=args.device,
        **_knobs(args, warp_default=None),
    )
    print(json.dumps(result))
    return 0


def cmd_profile(args):
    from flownet2_tf_tpu_torch.tools import profiler

    trace_dir = profiler.trace_model(
        model_name=args.model,
        height=args.height,
        width=args.width,
        batch=args.batch,
        iters=args.iters,
        compute_dtype=args.compute_dtype,
        trace_dir=args.trace_dir,
        warp_mode=args.warp_mode,
        device=args.device,
        **_knobs(args, warp_default=None),
    )
    profiler.print_summary(trace_dir, top=args.top)
    print(json.dumps({"trace_dir": trace_dir}))
    return 0


def cmd_make_tfrecords(args):
    from flownet2_tf_tpu_torch.tools.make_tfrecords import (
        convert_flying_chairs,
    )

    n_train, n_val = convert_flying_chairs(
        args.data_root,
        args.out,
        out_val=args.out_val,
        val_count=args.val_count,
        seed=args.seed,
    )
    print(json.dumps({"train": n_train, "val": n_val, "out": args.out}))
    return 0


def cmd_convert(args):
    """TF1 checkpoint -> .npz, then the semantic canary on the sample
    pair on ``--device``."""
    from flownet2_tf_tpu_torch.tools.convert_tf1_checkpoint import (
        convert,
        semantic_canary,
    )
    from flownet2_tf_tpu_torch.training.infer import resolve_device

    device = resolve_device(args.device)
    n = convert(args.tf_checkpoint, args.model, args.out)
    out = {"converted_variables": n, "out": args.out}
    if not args.no_canary:
        # names and shapes alone would load a semantically mismatched
        # checkpoint cleanly: run the converted model on the bundled
        # sample pair and require a sane flow
        out["canary"] = semantic_canary(
            args.out, args.model, sample_dir=args.sample_dir,
            device=device, **_knobs(args))
    print(json.dumps(out))
    return 0


def parse_export_shapes(args):
    """Validate/parse ``export --aot --shapes`` BEFORE the checkpoint
    load, so usage errors are instant. Returns [(h, w, b), ...] or None.
    """
    if not getattr(args, "shapes", None):
        return None
    if args.data_parallel or args.spatial_tiles:
        raise SystemExit(
            "--shapes bundles are single-chip; --data_parallel/"
            "--spatial_tiles only apply to single-shape exports"
        )
    shapes = []
    for spec in args.shapes.split(","):
        parts = spec.lower().split("x")
        usage = (
            f"--shapes: malformed entry {spec!r}; expected "
            "HxW or HxWxB with positive integers "
            "(e.g. 448x1024,384x1280x4)"
        )
        if len(parts) not in (2, 3):
            raise SystemExit(usage)
        try:
            dims = [int(p) for p in parts]
        except ValueError:
            raise SystemExit(usage) from None
        if any(d <= 0 for d in dims):
            raise SystemExit(usage)
        h, w = dims[0], dims[1]
        b = dims[2] if len(dims) == 3 else 1
        shapes.append((h, w, b))
    return shapes


def cmd_export(args):
    """Port checkpoint or run dir -> JAX-layout .npz weights, or --aot
    .flowpak."""
    import numpy as np

    from flownet2_tf_tpu_torch.training import warmstart

    platforms = args.platforms.split(",") if args.platforms else None
    shapes = None
    if args.aot:
        from flownet2_tf_tpu_torch.tools import aot

        shapes = parse_export_shapes(args)
        try:
            aot.check_tiling(args.batch, args.data_parallel,
                             args.spatial_tiles, args.spatial_overlap)
        except ValueError as e:
            raise SystemExit(f"export --aot: {e}") from None
    tree = warmstart.load_params_tree(args.ckpt)
    if args.aot:
        if shapes is not None:
            meta = aot.export_serving_bundle(
                args.model, tree, shapes, args.out,
                compute_dtype=args.compute_dtype,
                warp_mode=args.warp_mode, platforms=platforms,
                device=args.device, bf16_interconv=args.bf16_interconv,
            )
        else:
            meta = aot.export_serving(
                args.model, tree, args.height, args.width, args.out,
                batch=args.batch, compute_dtype=args.compute_dtype,
                warp_mode=args.warp_mode, platforms=platforms,
                data_parallel=args.data_parallel,
                spatial_tiles=args.spatial_tiles,
                spatial_overlap=args.spatial_overlap, device=args.device,
                bf16_interconv=args.bf16_interconv,
            )
        print(json.dumps({"out": args.out, **meta}))
        return 0
    flat = warmstart.flatten(tree)
    np.savez(args.out, **flat)
    print(json.dumps({"leaves": len(flat), "out": args.out}))
    return 0


def cmd_info(args):
    """Model card: per-scope parameter counts (+ FLOPs/pair with
    --flops, counted by torch.utils.flop_counter on the meta device: no
    data, no card)."""
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.tools import benchlib

    spec = get_model(args.model)
    model = spec.build("meta")
    by_scope = {}
    for name, p in model.named_parameters():
        scope = name.split(".")[0]
        by_scope[scope] = by_scope.get(scope, 0) + p.numel()
    out = {
        "model": args.model,
        "name": spec.name,
        "params_total": sum(by_scope.values()),
        "params_by_scope": dict(sorted(by_scope.items())),
    }
    if args.flops:
        flops = benchlib.count_flops(args.model, args.batch, args.height,
                                     args.width, "bfloat16")
        out["gflops_per_batch"] = round(flops / 1e9, 3)
        out["gflops_per_pair"] = round(flops / 1e9 / args.batch, 3)
        out["flops_counted"] = benchlib.FLOPS_COUNTED
        out["at"] = f"{args.batch}x{args.height}x{args.width} bf16"
    print(json.dumps(out, indent=1))
    return 0


def cmd_serve(args):
    """Run a .flowpak artifact on an image pair: no model code on the
    serving path; the graph lives in the artifact (tools/aot.py)."""
    from flownet2_tf_tpu_torch.tools.aot import load_serving
    from flownet2_tf_tpu_torch.utils.flowlib import write_flow_outputs
    from flownet2_tf_tpu_torch.utils.image_io import load_image_pair

    model = load_serving(args.artifact, device=args.device)
    a, b = load_image_pair(args.input_a, args.input_b)
    flow = model.infer_pair(a, b)
    write_flow_outputs(flow, args.out, args.input_a,
                       save_flo=not args.no_flo,
                       save_image=not args.no_image)
    print(json.dumps({
        "artifact": args.artifact,
        **{k: model.meta[k] for k in ("model", "compute_dtype",
                                      "warp_mode")},
        "flow_shape": list(flow.shape),
        "mean_magnitude": float(
            ((flow[..., 0] ** 2 + flow[..., 1] ** 2) ** 0.5).mean()
        ),
        "out_dir": args.out,
    }))
    return 0


def build_parser():
    parser = argparse.ArgumentParser(
        prog="flownet2_tf_tpu_torch",
        description="FlowNet 2.0 on PyTorch/CUDA (port of flownet2_tf_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_model_arg(p)
    p.add_argument("--dataset", default="chairs")
    p.add_argument("--data_root", default=None)
    p.add_argument("--tfrecords_train", default=None,
                   help="override the dataset config's train TFRecords")
    p.add_argument("--tfrecords_val", default=None)
    p.add_argument("--image_height", type=int, default=None,
                   help="override dataset config IMAGE_HEIGHT")
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--crop_height", type=int, default=None,
                   help="override augmentation crop (multiple of 64)")
    p.add_argument("--crop_width", type=int, default=None)
    p.add_argument("--schedule", default="long",
                   help="long (S_long), fine (S_fine), short")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--checkpoint_every", type=int, default=2500)
    p.add_argument("--image_summary_every", type=int, default=0,
                   help="write TensorBoard image summaries every N steps")
    p.add_argument("--eval_every", type=int, default=0,
                   help="evaluate validation EPE every N steps")
    p.add_argument("--multihost", action="store_true",
                   help="call torch.distributed.init_process_group() at "
                        "startup (from torchrun's RANK/WORLD_SIZE/"
                        "MASTER_ADDR/MASTER_PORT, or COORDINATOR_ADDRESS/"
                        "NUM_PROCESSES/PROCESS_ID) and train with DDP")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the forward pass (activation-memory "
                        "savings for stacked models at large crops)")
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
                   help="train on the procedural dataset (no downloads)")
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
    p.add_argument("--spatial_tiles", type=int, default=0,
                   help=">1: halo-banded spatially tiled inference, the "
                        "bands spread over the visible devices of "
                        "--device's platform, one batch on one card "
                        "(parallel/spatial.py)")
    p.add_argument("--spatial_overlap", type=int, default=128,
                   help="halo rows per band side (multiple of 32)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("eval", help="dataset AEE evaluation")
    _add_model_arg(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", default="sintel")
    p.add_argument("--data_root", default=None)
    p.add_argument("--tfrecords", default=None,
                   help="evaluate a TFRecord file instead of a raw layout")
    p.add_argument("--image_height", type=int, default=None)
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--render_pass", default="clean",
                   choices=["clean", "final"])
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--eval_batch", type=int, default=1,
                   help="batch pairs within a %%64 shape bucket (metric "
                        "unchanged)")
    p.add_argument("--save_outputs", default=None,
                   help="also write each predicted flow to this dir "
                        "(.flo + .png, + KITTI 16-bit PNG for masked "
                        "GT); fetches full flows: slower than the "
                        "on-device AEE path")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["bfloat16", "float32"])
    _add_device_arg(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench", help="throughput benchmark")
    _add_model_arg(p)
    p.add_argument("--height", type=int, default=448)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "profile", help="trace + per-kernel and per-layer time summary")
    _add_model_arg(p)
    p.add_argument("--height", type=int, default=448)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--trace_dir", default=None,
                   help="default: flownet2_trace in the temporary directory")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--warp_mode", default=None, choices=["full", "half"],
                   help="'half' profiles the serving preset (half-res "
                        "stack warps); 'full' pins exact warps; default "
                        "follows --warp_res (exact if unset)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "make-tfrecords", aliases=["make_tfrecords"],
        help="raw FlyingChairs -> reference-layout TFRecords",
    )
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--out_val", default=None)
    p.add_argument("--val_count", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_make_tfrecords)

    p = sub.add_parser("convert", help="TF1 checkpoint -> .npz")
    _add_model_arg(p)
    p.add_argument("--tf_checkpoint", required=True,
                   help="a TF1 V2 checkpoint prefix (flownet-2.ckpt-0), or "
                        "a directory whose 'checkpoint' file names it")
    p.add_argument("--out", required=True)
    p.add_argument(
        "--sample_dir", default="data/samples",
        help="sample-pair dir for the post-conversion semantic canary",
    )
    p.add_argument(
        "--no_canary", action="store_true",
        help="skip the semantic sanity run on the sample pair",
    )
    _add_device_arg(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser(
        "export",
        help="port checkpoint -> JAX-layout .npz weights, or (--aot) a "
             ".flowpak serving artifact",
    )
    p.add_argument("--ckpt", required=True,
                   help="a .npz or a port run directory (its newest "
                        "checkpoint)")
    p.add_argument("--out", required=True)
    p.add_argument(
        "--aot", action="store_true",
        help="export a serving artifact (torch.export graph + weights in "
             "one zip) instead of raw weights; shape-specialized to "
             "--height x --width",
    )
    p.add_argument("--model", default="2",
                   help="model name (AOT export only): s, c, cs, css, "
                        "sd, 2")
    p.add_argument("--height", type=int, default=448)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument(
        "--shapes", default=None,
        help="comma list of HxW or HxWxB entries (e.g. "
             "448x1024,384x1280x4): export ONE bundle .flowpak holding "
             "a graph per shape with shared weights; the loader "
             "dispatches per call on the input shape. Overrides "
             "--height/--width/--batch",
    )
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument(
        "--warp_mode", default="half",
        choices=["half", "quarter", "full"],
        help="half = the serving preset (stack warps on a 2x-coarser "
             "grid, an approximation); quarter = coarser still; full = "
             "exact warps (the parity path)",
    )
    p.add_argument(
        "--platforms", default=None,
        help="comma list of cuda and cpu (e.g. cuda,cpu): one graph per "
             "platform in one artifact, each traced on a device of its "
             "type, one copy of the weights; default: the --device's "
             "alone. cuda needs a card here",
    )
    p.add_argument("--data_parallel", type=int, default=0,
                   help="N > 1 (N dividing --batch): one replica's graph "
                        "(batch / N) that the loader runs on N devices, "
                        "each call's batch split over them "
                        "(load_serving; serve: the first N devices of the "
                        "platform)")
    p.add_argument("--spatial_tiles", type=int, default=0,
                   help="N > 1 (batch 1): freeze halo-banded spatial tiling "
                        "into the graph, the N bands run as one batch on "
                        "the export device, and add one band's graph that "
                        "load_serving(devices=) runs one band per device "
                        "(parallel/spatial.py)")
    p.add_argument("--spatial_overlap", type=int, default=128,
                   help="halo rows per band side (multiple of 32)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "info", help="model card: parameter counts, optional FLOPs"
    )
    p.add_argument("--model", default="2")
    p.add_argument("--flops", action="store_true",
                   help="also count FLOPs/pair (convs, deconvs and the "
                        "correlation, on the meta device; the JAX "
                        "package's XLA-only hbm_gb_xla_opsum_bound is not "
                        "reported)")
    p.add_argument("--height", type=int, default=448)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "serve", help="run a .flowpak serving artifact on an image pair"
    )
    p.add_argument("--artifact", required=True, help=".flowpak path")
    p.add_argument("--input_a", required=True)
    p.add_argument("--input_b", required=True)
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--no_image", action="store_true")
    p.add_argument("--no_flo", action="store_true")
    p.add_argument("--device", default=None,
                   help="the platform whose graph to serve (cuda, cuda:N "
                        "or cpu); default: cuda when the artifact has a "
                        "cuda graph, else its one platform. cuda without "
                        "a GPU raises: no other platform's graph stands in")
    p.set_defaults(fn=cmd_serve)
    return parser


def _add_model_arg(p):
    p.add_argument(
        "--model", default="s",
        help="model name: s, c, cs, css, sd, 2 (or flownet_* aliases)",
    )
    p.add_argument(
        "--half_res_warp", action="store_true",
        help="run stack warps at half resolution (an approximation); "
             "= --warp_res 2",
    )
    p.add_argument(
        "--warp_res", default=None, type=int, choices=[1, 2, 4],
        help="stack-warp grid factor: 1 exact, 2 half (= "
             "--half_res_warp), 4 quarter; overrides --half_res_warp; "
             "models without stack warps run unchanged",
    )
    p.add_argument(
        "--f32_features", default=None, choices=["highest", "default"],
        help="precision of the f32 path's feature convs and deconvs: "
             "highest (the default, the parity setting: full f32); "
             "default runs them in TF32 on the card (flow heads, "
             "upsamplers and interconvs stay full f32; exact f32 on the "
             "CPU, which has no TF32; the backward stays full f32)",
    )
    p.add_argument(
        "--fusion_res", default=None, type=int, choices=[1, 2],
        help="FlowNet2 fusion-net grid factor: 1 exact (the default); 2 "
             "runs the fusion net on a half-resolution input (pooled "
             "images, half-res branch flows, warps and errors) and "
             "resizes only its final flow back up, an approximation; "
             "other models run unchanged",
    )


def _warp_res(args, default=1):
    """The stack-warp grid factor the warp flags ask for, ``default``
    when neither is given (``--warp_res`` wins over ``--half_res_warp``;
    the bench and the profiler take None: their own default)."""
    if args.warp_res:
        return args.warp_res
    return 2 if args.half_res_warp else default


def _knobs(args, warp_default=1):
    """The model knobs a model subcommand was given, as the keyword
    arguments of the port's entry points (``warp_res`` with
    ``warp_default`` when no warp flag is given)."""
    return {"warp_res": _warp_res(args, warp_default),
            "fusion_res": args.fusion_res or 1,
            "bf16_interconv": args.bf16_interconv,
            "f32_features": args.f32_features or "highest"}



def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1, cpu (no fallback: "
                        "cuda without a GPU raises)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the JAX package's switch, read in this one place and passed on as
    # the bf16_interconv argument
    args.bf16_interconv = (
        os.environ.get("FLOWNET2_TPU_BF16_INTERCONV", "0") == "1")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
