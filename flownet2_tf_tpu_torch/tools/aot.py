"""Serving export: trace a model forward once, ship one artifact.

Port of ``flownet2_tf_tpu/tools/aot.py``. The forward ``fn(params,
image_a, image_b) -> flow`` is traced by :func:`torch.export.export`
ahead of time, with the weights as inputs (``torch.func.functional_call``),
and written with the weights into one ``.flowpak`` zip:

    exported.pt2   torch.export.save of fn (the graph only, no weights);
                   ``exported_{i}.pt2`` per entry of a bundle; in a
                   multi-platform artifact one graph per platform,
                   ``exported-{platform}.pt2`` (``exported_{i}-cuda.pt2``)
    params.npz     flat weight arrays, the JAX package's layout and
                   ``warmstart.flatten`` naming; bf16 leaves stored as
                   uint16 bit patterns: the JAX artifact's params.npz,
                   key for key and bit for bit; one copy for all platforms
    meta.json      the JAX artifact's keys: model, shapes, compute dtype,
                   warp mode, platforms (the device types the graphs were
                   traced on, in the order given: ``["cuda", "cpu"]``),
                   data_parallel, spatial_tiles, fusion_res, bf16-leaf
                   manifest; ``bf16_interconv: true`` when the interconvs
                   were baked in bf16

Each ``.pt2`` also holds ``layouts.json``, the kind of each weight
(``conv``, ``deconv`` or ``bias``), which says how the loader turns the
JAX layout into the graph's (HWIO -> OIHW; deconvs also flipped, ROADMAP
trap C2).

:func:`load_serving` restores the artifact without importing any
``flownet2_tf_tpu_torch.models`` module: the graph lives in the artifact.
It needs the correlation op's registration
(``ops/cuda/correlation_kernel.py``), whose CUDA kernel the graph calls
once per forward. Serving choices are baked in at export: bf16 weights
pre-cast (``models/common.py::cast_params_for_inference``), the stack
warps' grid (``warp_mode`` half -> ``warp_res`` 2, quarter -> 4, full ->
1), FlowNet2's fusion grid (``fusion_res``) and the bf16 interconvs
(``bf16_interconv``), each recorded in ``meta.json``. TF32 is process
state, not a graph node, so every call runs inside ``f32_policy`` (TF32
off), as the eager models do, and an artifact always serves the exact f32
features (``export`` takes no ``f32_features``, as in the JAX package).

A torch graph bakes its device in at trace time (the warps' reads differ
on CUDA and on the CPU, trap C10; ``arange``/``zeros`` carry a device),
so where the JAX package lowers one StableHLO for every platform, a
multi-platform artifact (``platforms=["cuda", "cpu"]``) holds one graph
per platform, each traced on a device of its type, and one shared
``params.npz``. :func:`load_serving` deserializes only the chosen
platform's graphs. The CUDA graph calls the hand-written correlation
kernel, the CPU graph the op's plain CPU version.

Exports are shape-specialized: H and W multiples of 64, one static
(batch, H, W) per graph; a bundle holds several graphs and one copy of
the weights. ``spatial_tiles=N`` freezes halo-banded tiling into a
single-pair graph (``parallel/tiles.py``: ``extract_tiles``, the model
on the N bands as one batch, ``stitch_tiles``), run on the export device,
and also writes ``band[-{platform}].pt2``, the model on one band (batch
1, the band's padded rows), which :func:`load_serving` runs one band per
device when given ``devices``, as the JAX package's artifact places one
band per chip.

Several devices: where the JAX package shards one program over a mesh,
the port runs one graph per device. ``data_parallel=N`` traces the
per-replica graph (batch ``batch // N``) on the export device;
:func:`load_serving` deserializes it once per device, moves it there
(``torch.export.passes.move_to_device_pass``: the devices baked into its
nodes, trap C10), puts a copy of the weights on each device, and every
call splits the batch into N contiguous shards, enqueues each replica's
forward before it reads any result back, and gathers the flows in order
(``parallel/mesh.py::scatter_gather``). The devices are
``parallel/mesh.py::serving_devices``: ``cuda:0`` ... ``cuda:{N-1}``
(fewer visible cards raise), N replicas on the CPU, or an explicit list
(repeats allowed). Replicas that share a device share its graph and
weights. Nothing model-side is traced again at load.
"""

from __future__ import annotations

import io
import json
import os
import warnings
import zipfile

import numpy as np
import torch
from torch import nn

# the op registration the graphs call; imports no model code
from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel  # noqa: F401
from flownet2_tf_tpu_torch.parallel import tiles
from flownet2_tf_tpu_torch.parallel.mesh import (
    scatter_gather,
    serving_devices,
)
from flownet2_tf_tpu_torch.utils.precision import f32_policy

FORMAT_VERSION = 1
BUNDLE_FORMAT_VERSION = 2

WARP_RES = {"full": 1, "half": 2, "quarter": 4}
PLATFORMS = ("cuda", "cpu")
LAYOUTS_FILE = "layouts.json"

# JAX layout -> the graph's, per layer kind: the two transforms of
# models/common.py::Conv.from_jax and Deconv.from_jax (trap C2)
_FROM_JAX = {
    "conv": lambda w: w.transpose(3, 2, 0, 1),
    "deconv": lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1),
    "bias": lambda w: w,
}


def warp_res_of(warp_mode: str) -> int:
    """``'full'`` -> 1, ``'half'`` -> 2, ``'quarter'`` -> 4; raises on any
    other mode."""
    try:
        return WARP_RES[warp_mode]
    except KeyError:
        raise ValueError(
            f"warp_mode must be 'half', 'quarter' or 'full': {warp_mode!r}"
        ) from None


def check_tiling(batch=1, data_parallel=0, spatial_tiles=0,
                 spatial_overlap=128):
    """ValueError for a multi-device export the JAX package refuses too:
    ``data_parallel`` with ``spatial_tiles``, ``data_parallel`` N at a
    batch that N does not divide, ``spatial_tiles`` at a batch other than
    1 or with an overlap that is not a multiple of 32."""
    dp = int(data_parallel or 0)
    if dp > 1 and int(spatial_tiles or 0) > 1:
        raise ValueError("data_parallel and spatial_tiles are exclusive")
    if dp > 1 and batch % dp:
        raise ValueError(
            f"data_parallel={dp} needs batch % {dp} == 0: got {batch}")
    if int(spatial_tiles or 0) > 1:
        if batch != 1:
            raise ValueError("spatial_tiles serving is single-pair "
                             f"(batch=1); got batch={batch}")
        if int(spatial_overlap) % 32:
            raise ValueError("overlap must be a multiple of 32")


def _check_shape(height, width):
    if height % 64 or width % 64:
        raise ValueError(
            f"serving export shapes must be multiples of 64 (six stride-2 "
            f"stages): got {height}x{width}. Pad to the next multiple and "
            "crop the flow on the host."
        )


class _SpatialServingForward(nn.Module):
    """``fn(params, image_a, image_b) -> flow`` of one pair through
    ``n_tiles`` halo-overlapped bands, run as one batch of ``forward``
    (a :class:`_ServingForward`), cores stitched back."""

    def __init__(self, forward, n_tiles, overlap):
        super().__init__()
        self.inner = forward
        self.n_tiles, self.overlap = int(n_tiles), int(overlap)

    def forward(self, params, image_a, image_b):
        tiles_a, core, offsets, h = tiles.extract_tiles(
            image_a, self.n_tiles, self.overlap)
        tiles_b, _, _, _ = tiles.extract_tiles(image_b, self.n_tiles,
                                               self.overlap)
        return tiles.stitch_tiles(self.inner(params, tiles_a, tiles_b),
                                  core, offsets, h)


class _ServingForward(nn.Module):
    """``fn(params, image_a, image_b) -> flow`` over a built model.

    The model is held outside the module tree, so that the export lifts
    none of its parameters: the weights are the ``params`` input, bound
    by ``functional_call``, and the artifact stores them once."""

    def __init__(self, model, compute_dtype):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.compute_dtype = compute_dtype

    def forward(self, params, image_a, image_b):
        preds = torch.func.functional_call(
            self.model, params,
            ({"input_a": image_a, "input_b": image_b}, self.compute_dtype))
        return preds["flow"]


def _serving_forward(model_name, tree, compute_dtype, warp_mode, device,
                     fusion_res=1, bf16_interconv=False):
    """(forward module, params by name, layouts): the model built with
    ``warp_mode``'s grid and the knobs on ``device``, filled from the
    JAX-layout ``tree``, the layers that follow the compute dtype
    pre-cast for bf16. A model ignores the knobs it does not read (as in
    the JAX package, whose knobs such a model never reads)."""
    from flownet2_tf_tpu_torch.models.common import (
        cast_params_for_inference,
        compute_dtype_of,
    )
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.training.warmstart import load_jax_params

    cd = compute_dtype_of(compute_dtype)
    model = get_model(model_name).build_for(
        device, warp_res=warp_res_of(warp_mode), fusion_res=fusion_res,
        bf16_interconv=bf16_interconv)
    load_jax_params(model, tree)
    if cd == torch.bfloat16:
        cast_params_for_inference(model, cd)
    params = {k: p.detach() for k, p in model.named_parameters()}
    return _ServingForward(model, cd), params, _layouts(model)


def _knob_meta(model_name, compute_dtype, fusion_res, bf16_interconv):
    """(``fusion_res`` the model runs, ``{"bf16_interconv": True}`` when
    the interconvs were baked in bf16, else ``{}``) for ``meta.json``:
    an approximation baked into an artifact is named there."""
    from flownet2_tf_tpu_torch.models.registry import get_model

    spec = get_model(model_name)
    baked = (bool(bf16_interconv) and spec.interconvs
             and compute_dtype == "bfloat16")
    return (spec.fusion_res_for(fusion_res),
            {"bf16_interconv": True} if baked else {})


def _layouts(model):
    """{JAX key: 'conv' | 'deconv' | 'bias'} of every weight of ``model``."""
    from flownet2_tf_tpu_torch.models.common import Deconv
    from flownet2_tf_tpu_torch.training.warmstart import _layers

    out = {}
    for scope, layer in _layers(model):
        out[f"{scope}/weights"] = (
            "deconv" if isinstance(layer, Deconv) else "conv")
        out[f"{scope}/biases"] = "bias"
    return out


def _numpy(t):
    """A CPU copy of ``t``; bf16 as its uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _encode_params(model):
    """npz-encode ``model``'s weights in the JAX layout (``to_jax`` per
    layer, on the stored dtype). numpy has no bfloat16, so bf16 leaves go
    in as uint16 bit patterns with a manifest, as the JAX package's
    ``_encode_params`` stores them. Returns (npz bytes, bf16 leaf names).
    """
    from flownet2_tf_tpu_torch.training.warmstart import _layers

    flat, bf16_leaves = {}, []
    for scope, layer in _layers(model):
        for leaf, p in (("weights", layer.weights), ("biases", layer.biases)):
            key = f"{scope}/{leaf}"
            arr = _numpy(p)
            if leaf == "weights":
                arr = layer.to_jax(arr)
            flat[key] = np.ascontiguousarray(arr)
            if p.dtype == torch.bfloat16:
                bf16_leaves.append(key)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue(), sorted(bf16_leaves)


def _export_one(forward, params, layouts, height, width, batch, device):
    """Trace ``forward`` at (batch, height, width) into ``.pt2`` bytes."""
    # two tensors: one object passed twice would be traced as one input
    image_a, image_b = (torch.zeros((batch, height, width, 3),
                                    device=device) for _ in range(2))
    with torch.no_grad():
        exported = torch.export.export(forward, (params, image_a, image_b))
    exported.example_inputs = None  # the weights are stored once, apart
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={LAYOUTS_FILE: json.dumps(layouts)})
    return buf.getvalue()


def _export_devices(device, platforms):
    """The devices to trace the graphs on, one per platform: ``device``
    alone when ``platforms`` is None, else each of ``platforms`` (``cuda``
    or ``cpu``, in the order given; ``device`` itself where its type is
    the platform, so ``cuda:1`` keeps its index). Raises before anything
    is built when a platform is unknown or named twice, or when its
    device is absent: a graph is traced on its platform's device, and no
    partial artifact is written."""
    from flownet2_tf_tpu_torch.training.infer import resolve_device

    if platforms is None:
        return [resolve_device(device)]
    device = torch.device(device)
    platforms = [str(p) for p in platforms]
    unknown = [p for p in platforms if p not in PLATFORMS]
    if not platforms or unknown or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms {platforms}: each of {PLATFORMS} at "
                         "most once")
    devices = [device if device.type == p else torch.device(p)
               for p in platforms]
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError(
            f"platforms {platforms}: the cuda graph is traced on a card, "
            "and torch.cuda.is_available() is False here; export "
            "--platforms cpu on this machine, or export on one with a card")
    return devices


def _graph_name(stem, platform, platforms):
    """``{stem}.pt2`` in a one-platform artifact (the files of a
    single-device export), ``{stem}-{platform}.pt2`` in a multi-platform
    one."""
    if len(platforms) == 1:
        return f"{stem}.pt2"
    return f"{stem}-{platform}.pt2"


def _write(out_path, graphs, params_bytes, meta):
    # stored, not deflated: float weights are near-incompressible, and
    # deflating FlowNet2's 650 MB costs seconds per export and per load
    with zipfile.ZipFile(os.fspath(out_path), "w", zipfile.ZIP_STORED) as z:
        for name, data in graphs:
            z.writestr(name, data)
        z.writestr("params.npz", params_bytes)
        z.writestr("meta.json", json.dumps(meta, indent=1))


def _export_graphs(model_name, tree, compute_dtype, warp_mode, devices,
                   entries, **knobs):
    """[(file name, .pt2 bytes)] of every platform's graphs, and the
    encoded weights (taken once: every platform's are the same tree).
    ``entries``: [(stem, (height, width, batch), wrap)], ``wrap`` turning
    the serving forward into the one to trace (or None)."""
    platforms = [d.type for d in devices]
    graphs, encoded = [], None
    for device in devices:
        forward, tensors, layouts = _serving_forward(
            model_name, tree, compute_dtype, warp_mode, device, **knobs)
        if encoded is None:
            encoded = _encode_params(forward.model)
        for stem, (h, w, b), wrap in entries:
            graphs.append((_graph_name(stem, device.type, platforms),
                           _export_one(wrap(forward) if wrap else forward,
                                       tensors, layouts, h, w, b, device)))
    return graphs, encoded


def export_serving(model_name, params, height, width, out_path, batch=1,
                   compute_dtype="bfloat16", warp_mode="half",
                   platforms=None, data_parallel=0, spatial_tiles=0,
                   spatial_overlap=128, fusion_res=1, device="cuda",
                   bf16_interconv=False):
    """Export one shape-specialized serving forward to ``out_path``
    (.flowpak), from a JAX-layout parameter tree.

    ``warp_mode='half'`` bakes the half-res stack-warp serving preset;
    ``'full'`` keeps exact warps (the parity path). ``fusion_res=2``
    bakes FlowNet2's half-res fusion, ``bf16_interconv`` its bf16
    interconvs under the bf16 policy; ``meta.json`` records both.
    ``platforms``: None traces one graph on ``device``; a list of
    ``cuda``/``cpu`` traces one graph per platform into one artifact
    (``_export_devices``). ``data_parallel=N`` (N > 1, N dividing
    ``batch``) traces the forward of one replica, batch ``batch // N``,
    which :func:`load_serving` runs on N devices. ``spatial_tiles=N``
    (N > 1, batch 1, exclusive with ``data_parallel``) freezes
    halo-banded tiling into the graph, the N bands run as one batch on
    the export device, and adds the graph of one band, which
    :func:`load_serving` runs one band per device (the JAX package places
    one per chip). Returns the metadata.
    """
    check_tiling(batch, data_parallel, spatial_tiles, spatial_overlap)
    _check_shape(height, width)
    dp, sp = int(data_parallel or 0), int(spatial_tiles or 0)
    devices = _export_devices(device, platforms)
    entries = [("exported", (height, width, batch // max(dp, 1)), None)]
    if sp > 1:
        def wrap(forward):
            return _SpatialServingForward(forward, sp, spatial_overlap)

        entries = [("exported", (height, width, batch), wrap),
                   ("band", (tiles.band_height(height, sp, spatial_overlap),
                             width, 1), None)]
    graphs, (params_bytes, bf16_leaves) = _export_graphs(
        model_name, params, compute_dtype, warp_mode, devices, entries,
        fusion_res=fusion_res, bf16_interconv=bf16_interconv)
    fusion_k, interconv_meta = _knob_meta(model_name, compute_dtype,
                                          fusion_res, bf16_interconv)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": model_name,
        "batch": batch,
        "height": height,
        "width": width,
        "compute_dtype": compute_dtype,
        "warp_mode": warp_mode,
        "platforms": [d.type for d in devices],
        "data_parallel": dp,
        "spatial_tiles": sp,
        "spatial_overlap": int(spatial_overlap) if sp else 0,
        "fusion_res": fusion_k,
        **interconv_meta,
        "bf16_leaves": bf16_leaves,
    }
    _write(out_path, graphs, params_bytes, meta)
    return meta


def export_serving_bundle(model_name, params, shapes, out_path,
                          compute_dtype="bfloat16", warp_mode="half",
                          platforms=None, device="cuda",
                          bf16_interconv=False):
    """Export SEVERAL shape-specialized forwards into one ``.flowpak``.

    ``shapes``: iterable of (height, width, batch). All entries share one
    copy of the weights; ``load_serving`` dispatches per call on the
    input shape. ``platforms``, ``device`` and ``bf16_interconv``: as in
    :func:`export_serving` (a bundle runs the exact fusion, as in the JAX
    package).
    """
    shapes = [tuple(int(v) for v in s) for s in shapes]
    if not shapes:
        raise ValueError("export_serving_bundle needs at least one shape")
    if len(set(shapes)) != len(shapes):
        raise ValueError(f"duplicate shapes in bundle: {shapes}")
    for h, w, _ in shapes:
        _check_shape(h, w)
    devices = _export_devices(device, platforms)
    graphs, (params_bytes, bf16_leaves) = _export_graphs(
        model_name, params, compute_dtype, warp_mode, devices,
        [(f"exported_{i}", shape, None) for i, shape in enumerate(shapes)],
        bf16_interconv=bf16_interconv)
    _, interconv_meta = _knob_meta(model_name, compute_dtype, 1,
                                   bf16_interconv)
    meta = {
        "format_version": BUNDLE_FORMAT_VERSION,
        "model": model_name,
        "entries": [
            {"height": h, "width": w, "batch": b} for h, w, b in shapes
        ],
        "compute_dtype": compute_dtype,
        "warp_mode": warp_mode,
        "platforms": [d.type for d in devices],
        **interconv_meta,
        "bf16_leaves": bf16_leaves,
    }
    _write(out_path, graphs, params_bytes, meta)
    return meta


class ServingModel:
    """A loaded .flowpak: call with (N, H, W, 3) float32 pairs in [0, 1].

    numpy inputs give a numpy flow; torch tensors give a tensor on the
    artifact's device (no host copy), the first device of a
    multi-device one. Imports no model code: the graph lives in the
    artifact.

    ``replicas``: [(graph, weights, device)] of a data-parallel artifact
    (one per replica, each call's batch split over them in order) or of
    a spatial artifact's band graph (one band per device); None runs
    ``program`` on ``device``.
    """

    def __init__(self, program, params, meta, device=None, replicas=None):
        self._program = program
        self._params = params
        self.meta = meta
        # the device whose graph this is (one of meta["platforms"])
        self.device = torch.device(device or meta["platforms"][0])
        self._replicas = replicas
        self.devices = ([d for _, _, d in replicas] if replicas
                        else [self.device])

    def _forward(self, a, b, out_device):
        if not self._replicas:
            return self._program(self._params, a, b)
        fns = [lambda x, y, g=g, w=w: g(w, x, y)
               for g, w, _ in self._replicas]
        if self.meta.get("data_parallel", 0) > 1:
            return scatter_gather(fns, self.devices, (a, b), out_device)
        # one band per device, cut and stitched where the pair lies
        n, overlap = self.meta["spatial_tiles"], self.meta["spatial_overlap"]
        tiles_a, core, offsets, h = tiles.extract_tiles(a, n, overlap)
        tiles_b, _, _, _ = tiles.extract_tiles(b, n, overlap)
        return tiles.stitch_tiles(
            scatter_gather(fns, self.devices, (tiles_a, tiles_b),
                           out_device), core, offsets, h)

    def __call__(self, image_a, image_b):
        expect = (self.meta["batch"], self.meta["height"],
                  self.meta["width"], 3)
        if tuple(image_a.shape) != expect or tuple(image_b.shape) != expect:
            raise ValueError(
                f"artifact is specialized to inputs {expect}; got "
                f"{tuple(image_a.shape)} / {tuple(image_b.shape)}. Export one "
                "artifact per serving resolution (shapes are static by "
                "design)."
            )
        as_numpy = not isinstance(image_a, torch.Tensor)
        # several devices: the pair stays where it is (numpy on the host)
        # and its shards go to the replicas
        home = self.device if not self._replicas else (
            torch.device("cpu") if as_numpy else None)
        a, b = (torch.as_tensor(
                    np.ascontiguousarray(x, np.float32) if as_numpy else x,
                    dtype=torch.float32, device=home)
                for x in (image_a, image_b))
        # f32_policy's flags follow the export's policy (process state,
        # not graph nodes)
        cd = (torch.bfloat16 if self.meta["compute_dtype"] == "bfloat16"
              else torch.float32)
        with torch.no_grad(), f32_policy(cd):
            flow = self._forward(a, b, home if as_numpy else self.devices[0])
        return flow.cpu().numpy() if as_numpy else flow

    def infer_pair(self, image_a, image_b):
        """Serve one unbatched (H, W, 3) pair; H/W may be SMALLER than
        the artifact resolution: inputs are edge-padded up on the host
        and the flow cropped back. Larger inputs raise.

        On a batch>1 artifact the pair is broadcast to the full batch;
        where that costs redundant forwards on one device (more than one
        pair per replica), the first such call warns. A data-parallel
        artifact with one pair per replica stays silent, as in the JAX
        package. Batch callers should call the model with full batches.
        """
        a = np.asarray(image_a, np.float32)
        b = np.asarray(image_b, np.float32)
        if a.ndim != 3 or a.shape != b.shape:
            raise ValueError(f"expected matching (H, W, 3) pairs: "
                             f"{a.shape} / {b.shape}")
        h, w = a.shape[:2]
        eh, ew = self.meta["height"], self.meta["width"]
        if h > eh or w > ew:
            raise ValueError(
                f"input {h}x{w} exceeds the artifact resolution "
                f"{eh}x{ew}; export a larger artifact."
            )
        pad = ((0, eh - h), (0, ew - w), (0, 0))
        a = np.pad(a, pad, mode="edge")
        b = np.pad(b, pad, mode="edge")
        batch = self.meta["batch"]
        if batch == 1:
            return self(a[None], b[None])[0, :h, :w]
        per_replica = batch // max(self.meta.get("data_parallel", 0), 1)
        if per_replica > 1 and not getattr(self, "_warned_broadcast", False):
            self._warned_broadcast = True
            warnings.warn(
                f"infer_pair on a batch={batch} artifact broadcasts the "
                f"pair to the full batch ({batch - 1} redundant forwards "
                f"per call); export a batch=1 artifact for single-pair "
                f"serving, or call the model with full batches.",
                stacklevel=2,
            )
        a = np.broadcast_to(a, (batch,) + a.shape)
        b = np.broadcast_to(b, (batch,) + b.shape)
        return self(a, b)[0, :h, :w]


class BundleServingModel:
    """A multi-shape .flowpak: per-call dispatch on the input shape.

    Entries share one weight copy; ``infer_pair`` picks the smallest
    batch-1 entry that fits, pads up, and crops back.
    """

    def __init__(self, models, meta):
        self._models = models  # {(batch, height, width): ServingModel}
        self.meta = meta

    @property
    def shapes(self):
        return sorted(self._models)

    def __call__(self, image_a, image_b):
        shape = tuple(image_a.shape)
        key = shape[:3] if len(shape) == 4 else None
        if key not in self._models:
            raise ValueError(
                f"no bundle entry for inputs {shape}; available "
                f"(batch, height, width): {self.shapes}"
            )
        return self._models[key](image_a, image_b)

    def infer_pair(self, image_a, image_b):
        a = np.asarray(image_a, np.float32)
        if a.ndim != 3:
            raise ValueError(f"expected one (H, W, 3) pair: {a.shape}")
        h, w = a.shape[:2]
        fits = [
            (eh * ew, b, eh, ew)
            for (b, eh, ew) in self._models
            if b == 1 and eh >= h and ew >= w
        ]
        if not fits:
            raise ValueError(
                f"no batch-1 bundle entry fits a {h}x{w} pair; available "
                f"(batch, height, width): {self.shapes}"
            )
        _, b, eh, ew = min(fits)
        return self._models[(b, eh, ew)].infer_pair(image_a, image_b)


def _host_params(npz_bytes, bf16_leaves, layouts):
    """params.npz -> {graph input name: CPU tensor} in the graph's
    layout (bf16 leaves from their bit patterns)."""
    bf16 = set(bf16_leaves)
    params = {}
    with np.load(io.BytesIO(npz_bytes)) as npz:
        for key in npz.files:
            arr = np.ascontiguousarray(_FROM_JAX[layouts[key]](npz[key]))
            params[key.replace("/", ".")] = (
                torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                if key in bf16 else torch.from_numpy(arr))
    return params


def graph_device(program):
    """The device a ``torch.export`` program was traced on: that of its
    first tensor input."""
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if node.op == "placeholder" and isinstance(val, torch.Tensor):
            return val.device
    raise ValueError("the program has no tensor input")


def move_graph(program, device):
    """``program`` moved in place from the device it was traced on to
    ``device`` (``torch.export.passes.move_to_device_pass``: the devices
    baked into its nodes, such as ``arange``'s and ``zeros``', and their
    metadata); returns it."""
    from torch.export.passes import move_to_device_pass

    source, device = graph_device(program), torch.device(device)
    if source == device:
        return program
    return move_to_device_pass(program, {str(source): str(device)})


def _load_program(data, device=None):
    """(module, layouts) of a ``.pt2``'s bytes, moved to ``device`` when
    given."""
    layouts = {LAYOUTS_FILE: ""}
    program = torch.export.load(io.BytesIO(data), extra_files=layouts)
    if device is not None:
        program = move_graph(program, device)
    return program.module(), json.loads(layouts[LAYOUTS_FILE])


def _serving_device(path, platforms, device):
    """The device to serve on: ``device``, else ``cuda`` when the artifact
    holds a CUDA graph (the port runs on the card unless asked for the
    CPU), else its one platform. Raises for a platform the artifact does
    not hold, and for CUDA on a host without a card: no platform's graph
    stands in for another's."""
    if device is None:
        device = "cuda" if "cuda" in platforms else platforms[0]
    device = torch.device(device)
    if device.type not in platforms:
        raise ValueError(
            f"{path} holds graphs for the platforms {platforms}, none for "
            f"{device.type}: serve it on one of those, or export it again "
            f"with --platforms naming {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        hint = ("serve its cpu graph with device='cpu' (cli serve --device "
                "cpu)" if "cpu" in platforms else
                "export it again with --platforms cpu (or --device cpu) to "
                "serve on the CPU")
        raise RuntimeError(
            f"{path} was exported for cuda, but torch.cuda.is_available() "
            f"is False: {hint}")
    return device


def _replica_devices(path, meta, device, devices):
    """(graph stem, devices) of a multi-device load, or None for one
    device: a data-parallel artifact's replicas (``devices``, else the
    default devices of ``device``'s platform), or a spatial artifact's
    bands when ``devices`` is given."""
    dp, sp = meta.get("data_parallel", 0), meta.get("spatial_tiles", 0)
    if dp > 1:
        return "exported", serving_devices(device.type, dp, devices,
                                           kind="data_parallel")
    if devices is None:
        return None
    if sp > 1:
        return "band", serving_devices(device.type, sp, devices,
                                       kind="spatial_tiles")
    raise ValueError(
        f"{path}: devices= serves the replicas of a data_parallel artifact "
        "or the bands of a spatial_tiles one; this artifact runs on one "
        "device (pass device=)")


def load_serving(path, device=None, devices=None):
    """Load a .flowpak written by :func:`export_serving` (single shape) or
    :func:`export_serving_bundle` (shape-dispatching bundle), reading only
    the graphs of ``device``'s platform (default: ``cuda`` when the
    artifact has it; the platform of ``devices`` when given). A CUDA
    graph needs a card here: there is no fallback to another platform's
    graph.

    A ``data_parallel`` N artifact serves N replicas on ``devices`` (N of
    them, repeats allowed), by default on the first N devices of the
    platform (``parallel/mesh.py::serving_devices``: fewer cards raise).
    A ``spatial_tiles`` N artifact runs its one graph on ``device``, or
    with ``devices`` (N of them) one band per device."""
    if device is None and devices is not None:
        device = devices[0]
    with zipfile.ZipFile(os.fspath(path)) as z:
        meta = json.loads(z.read("meta.json"))
        version = meta.get("format_version")
        if version not in (FORMAT_VERSION, BUNDLE_FORMAT_VERSION):
            raise ValueError(f"unsupported .flowpak version: {meta}")
        held = z.namelist()
        if "exported.bin" in held or "exported_0.bin" in held:
            raise ValueError(
                f"{path}: a jax.export artifact of the JAX package; the "
                "torch port loads its own exports (exported*.pt2)")
        platforms = meta["platforms"]
        device = _serving_device(path, platforms, device)
        # a bundle's entries are single-device, as in the JAX package
        replicas = _replica_devices(
            path, meta if version == FORMAT_VERSION else {}, device, devices)
        stems = (["exported"] if version == FORMAT_VERSION else
                 [f"exported_{i}" for i in range(len(meta["entries"]))])
        if replicas is not None:
            stems = [replicas[0]]
        names = [_graph_name(s, device.type, platforms) for s in stems]
        missing = [n for n in names if n not in held]
        if missing:
            raise ValueError(
                f"{path}: meta.json names the platforms {platforms}, but "
                f"the artifact lacks {missing}; it holds the graphs "
                f"{sorted(n for n in held if n.endswith('.pt2'))}")
        graphs = [z.read(name) for name in names]
        npz_bytes = z.read("params.npz")
    if replicas is not None:
        # one graph and one copy of the weights per distinct device
        placed, host = {}, None
        for d in replicas[1]:
            if d not in placed:
                program, layouts = _load_program(graphs[0], d)
                if host is None:
                    host = _host_params(npz_bytes, meta["bf16_leaves"],
                                        layouts)
                placed[d] = (program, {k: t.to(d) for k, t in host.items()})
        return ServingModel(None, None, meta, replicas[1][0],
                            [(*placed[d], d) for d in replicas[1]])
    loaded = [_load_program(data) for data in graphs]
    params = {k: t.to(device) for k, t in _host_params(
        npz_bytes, meta["bf16_leaves"], loaded[0][1]).items()}
    if version == FORMAT_VERSION:
        return ServingModel(loaded[0][0], params, meta, device)
    models = {}
    for (program, _), entry in zip(loaded, meta["entries"]):
        models[(entry["batch"], entry["height"], entry["width"])] = (
            ServingModel(program, params, dict(meta, **entry), device))
    return BundleServingModel(models, meta)
