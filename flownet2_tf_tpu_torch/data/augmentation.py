"""Training augmentation on the device, in plain torch.

Port of ``flownet2_tf_tpu/data/augmentation.py``: Caffe-style coefficient
sampling, the 2x3 affine composition, bilinear resampling through the
port's ``ops/sampling.py::bilinear_gather``, the ground-truth flow
re-expressed under the two correlated transforms

    flow'(p) = T_b^{-1}( T_a(p) + flow(T_a(p)) ) - p

(T_a, T_b map crop coordinates to input coordinates), the chromatic-eigen
chain and the photometric chain. The ``image_a`` spec samples the base
transform; the ``image_b`` spec samples the incremental A->B jitter,
composed coefficient-wise. Spec schema: ``data/dataset_configs.py``.

Random draws come from a ``torch.Generator`` on the tensors' device; the
trainer seeds one per step from ``(seed + 17, step)``, so the draws are
stateless across a resume, like the JAX package's ``fold_in``. The bits
differ from ``jax.random``; fed the same coefficients and noise, the
geometry and photometry match the JAX functions.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from flownet2_tf_tpu_torch.models.common import f32_policy
from flownet2_tf_tpu_torch.ops.sampling import bilinear_gather

Spec = Dict[str, Any]


# ---------------------------------------------------------------------------
# Coefficient sampling
# ---------------------------------------------------------------------------

def _sample_coeff(gen, spec: Spec | None, batch: int, n: int = 1):
    """Sample (batch, n) coefficients per the Caffe rand_type schema.

    Returns the pre-exp neutral value 0 when the transform is absent or
    loses its bernoulli draw; callers apply ``exp`` afterwards.
    """
    device = gen.device
    if spec is None:
        return torch.zeros((batch, n), device=device), False
    mean = float(spec.get("mean", 0.0))
    spread = float(spec.get("spread", 0.0))
    prob = float(spec.get("prob", 1.0))
    rand_type = spec.get("rand_type", "uniform_bernoulli")
    if rand_type == "uniform_bernoulli":
        u = torch.rand((batch, n), generator=gen, device=device)
        val = (mean - spread) + u * (2.0 * spread)
    elif rand_type == "gaussian_bernoulli":
        val = mean + spread * torch.randn((batch, n), generator=gen,
                                          device=device)
    else:
        raise ValueError(f"unknown rand_type {rand_type!r}")
    if prob < 1.0:
        keep = torch.rand((batch, 1), generator=gen, device=device) < prob
        val = torch.where(keep, val, torch.zeros_like(val))
    return val, bool(spec.get("exp", False))


def sample_spatial_coeffs(gen, spec: Spec, batch: int):
    """-> dict of per-example spatial coefficients (post-exp)."""
    out = {}
    val, is_exp = _sample_coeff(gen, spec.get("translate"), batch, 2)
    out["translate"] = torch.exp(val) if is_exp else val
    val, is_exp = _sample_coeff(gen, spec.get("rotate"), batch, 1)
    out["rotate"] = (torch.exp(val) if is_exp else val)[:, 0]
    # zoom/squeeze are multiplicative: neutral = 1 (exp(0) or 1+0)
    val, is_exp = _sample_coeff(gen, spec.get("zoom"), batch, 1)
    out["zoom"] = (torch.exp(val) if is_exp else 1.0 + val)[:, 0]
    val, is_exp = _sample_coeff(gen, spec.get("squeeze"), batch, 1)
    out["squeeze"] = (torch.exp(val) if is_exp else 1.0 + val)[:, 0]
    return out


def compose_spatial(base, delta):
    """Compose incremental B coefficients onto the base A coefficients."""
    return {
        "translate": base["translate"] + delta["translate"],
        "rotate": base["rotate"] + delta["rotate"],
        "zoom": base["zoom"] * delta["zoom"],
        "squeeze": base["squeeze"] * delta["squeeze"],
    }


# ---------------------------------------------------------------------------
# Affine machinery (output/crop coords -> input coords)
# ---------------------------------------------------------------------------

def coeffs_to_affine(coeffs, in_hw, out_hw):
    """Build (B, 2, 3) matrices: q = M @ (p - c_out) + c_in + t.

    Zoom > 1 magnifies; squeeze scales x by sqrt(squeeze) and y by
    1/sqrt(squeeze); rotation about the crop center; translation in
    fractions of the input size.
    """
    in_h, in_w = in_hw
    out_h, out_w = out_hw
    angle = coeffs["rotate"]
    zoom_x = coeffs["zoom"] * torch.sqrt(coeffs["squeeze"])
    zoom_y = coeffs["zoom"] / torch.sqrt(coeffs["squeeze"])
    cos, sin = torch.cos(angle), torch.sin(angle)
    m00 = cos / zoom_x
    m01 = -sin / zoom_y
    m10 = sin / zoom_x
    m11 = cos / zoom_y
    tx = coeffs["translate"][:, 0] * in_w
    ty = coeffs["translate"][:, 1] * in_h
    c_in_x = (in_w - 1) / 2.0
    c_in_y = (in_h - 1) / 2.0
    c_out_x = (out_w - 1) / 2.0
    c_out_y = (out_h - 1) / 2.0
    bx = c_in_x + tx - (m00 * c_out_x + m01 * c_out_y)
    by = c_in_y + ty - (m10 * c_out_x + m11 * c_out_y)
    row_x = torch.stack([m00, m01, bx], dim=-1)
    row_y = torch.stack([m10, m11, by], dim=-1)
    return torch.stack([row_x, row_y], dim=1)


def invert_affine(theta):
    """Invert (B, 2, 3) affines: [M | t] -> [M^-1 | -M^-1 t]."""
    m = theta[:, :, :2]
    t = theta[:, :, 2]
    det = m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0]
    inv00 = m[:, 1, 1] / det
    inv01 = -m[:, 0, 1] / det
    inv10 = -m[:, 1, 0] / det
    inv11 = m[:, 0, 0] / det
    itx = -(inv00 * t[:, 0] + inv01 * t[:, 1])
    ity = -(inv10 * t[:, 0] + inv11 * t[:, 1])
    row_x = torch.stack([inv00, inv01, itx], dim=-1)
    row_y = torch.stack([inv10, inv11, ity], dim=-1)
    return torch.stack([row_x, row_y], dim=1)


def _apply_affine(theta, px, py):
    """theta (B, 2, 3) applied to coordinate planes -> (qx, qy), (B, h, w)."""
    th = theta[:, :, :, None, None]
    qx = th[:, 0, 0] * px + th[:, 0, 1] * py + th[:, 0, 2]
    qy = th[:, 1, 0] * px + th[:, 1, 1] * py + th[:, 1, 2]
    return qx, qy


def _output_grid(theta, out_hw):
    out_h, out_w = out_hw
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=theta.device),
        torch.arange(out_w, dtype=torch.float32, device=theta.device),
        indexing="ij",
    )
    return _apply_affine(theta, xs, ys)


def affine_sample(image, theta, out_hw):
    """Warp NHWC image by per-example affines into (B, out_h, out_w, C)."""
    qx, qy = _output_grid(theta, out_hw)
    return bilinear_gather(image, qx, qy)


def transform_flow(flow, theta_a, theta_b, out_hw):
    """Re-express GT flow under transforms A and B (FlowAugmentation):
    ``flow'(p) = T_b^{-1}(T_a(p) + flow(T_a(p))) - p``, the original flow
    sampled bilinearly at T_a(p)."""
    qx, qy = _output_grid(theta_a, out_hw)
    f = bilinear_gather(flow, qx, qy)
    px2, py2 = _apply_affine(invert_affine(theta_b), qx + f[..., 0],
                             qy + f[..., 1])
    out_h, out_w = out_hw
    xs = torch.arange(out_w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(out_h, dtype=torch.float32, device=flow.device)
    return torch.stack([px2 - xs[None, None, :], py2 - ys[None, :, None]],
                       dim=-1)


# ---------------------------------------------------------------------------
# Photometric chain
# ---------------------------------------------------------------------------

def sample_photometric_coeffs(gen, spec: Spec, batch: int):
    out = {}
    val, is_exp = _sample_coeff(gen, spec.get("noise"), batch, 1)
    out["noise"] = torch.abs(torch.exp(val) if is_exp else val)[:, 0]
    val, is_exp = _sample_coeff(gen, spec.get("brightness"), batch, 1)
    out["brightness"] = (torch.exp(val) if is_exp else val)[:, 0]
    for name in ("gamma", "contrast"):
        val, is_exp = _sample_coeff(gen, spec.get(name), batch, 1)
        out[name] = (torch.exp(val) if is_exp else 1.0 + val)[:, 0]
    val, is_exp = _sample_coeff(gen, spec.get("color"), batch, 3)
    out["color"] = torch.exp(val) if is_exp else 1.0 + val  # (B, 3)
    return out


# Chromatic-eigen basis (Caffe FlowNet data_augmentation layer): row 0 is
# the luminance direction, rows 1-2 span chroma.
_EIGEN = ((0.51, 0.56, 0.65),
          (0.79, 0.01, -0.62),
          (0.35, -0.83, 0.44))

CHROMATIC_EIGEN_KEYS = (
    "lmult_pow", "lmult_mult", "lmult_add",
    "sat_pow", "sat_mult", "sat_add",
    "col_pow", "col_mult", "col_add",
    "ladd_pow", "ladd_mult", "ladd_add",
)


def sample_chromatic_eigen_coeffs(gen, spec: Spec, batch: int):
    """Sample the Caffe chromatic-eigen parameter set (None if absent)."""
    if not any(k in spec for k in CHROMATIC_EIGEN_KEYS):
        return None
    out = {}
    for name in CHROMATIC_EIGEN_KEYS:
        n = 3 if name.startswith("col_") else 1
        val, is_exp = _sample_coeff(gen, spec.get(name), batch, n)
        if name.endswith("_pow") or name.endswith("_mult"):
            coeff = torch.exp(val) if is_exp else 1.0 + val
        else:  # _add: additive, neutral 0
            coeff = torch.exp(val) - 1.0 if is_exp else val
        out[name] = coeff if n == 3 else coeff[:, 0]
    return out


def apply_chromatic_eigen(image, coeffs):
    """Luminance/saturation/color transform in the eigen color basis:
    e = E rgb; per-eigen-channel color pow/mult/add; luminance through
    the lmult then the ladd chain; chroma magnitude (saturation)
    pow/mult/add; back through E^-1, clipped to [0, 1]."""
    eigen = torch.tensor(_EIGEN, dtype=torch.float32, device=image.device)

    def bc(x):  # (B,) or (B, 3) -> broadcastable
        return x[:, None, None, None] if x.ndim == 1 else x[:, None, None, :]

    eps = 1e-6
    with f32_policy():
        e = torch.einsum("nhwc,dc->nhwd", image, eigen)
    e = (torch.sign(e) * torch.abs(e) ** bc(coeffs["col_pow"])
         * bc(coeffs["col_mult"]) + bc(coeffs["col_add"]))

    lum = e[..., :1]
    chroma = e[..., 1:]
    sat = torch.sqrt(torch.sum(torch.square(chroma), dim=-1, keepdim=True)
                     + eps)
    for prefix in ("lmult", "ladd"):
        lum = (torch.sign(lum) * torch.abs(lum) ** bc(coeffs[f"{prefix}_pow"])
               * bc(coeffs[f"{prefix}_mult"]) + bc(coeffs[f"{prefix}_add"]))
    new_sat = (sat ** bc(coeffs["sat_pow"]) * bc(coeffs["sat_mult"])
               + bc(coeffs["sat_add"]))
    chroma = chroma * (new_sat / sat)

    e = torch.cat([lum, chroma], dim=-1)
    with f32_policy():
        rgb = torch.einsum("nhwd,cd->nhwc", e, torch.linalg.inv(eigen))
    return torch.clamp(rgb, 0.0, 1.0)


def apply_photometric(image, coeffs, noise):
    """color multiplier -> gamma -> brightness -> contrast -> noise,
    clamped to [0, 1]. ``noise``: standard normal, ``image``'s shape."""
    img = image * coeffs["color"][:, None, None, :]
    img = torch.clamp(img, 0.0, 1.0) ** coeffs["gamma"][:, None, None, None]
    img = img + coeffs["brightness"][:, None, None, None]
    img = (img - 0.5) * coeffs["contrast"][:, None, None, None] + 0.5
    img = img + noise * coeffs["noise"][:, None, None, None]
    return torch.clamp(img, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Top-level entry points
# ---------------------------------------------------------------------------

def augment_batch(gen, image_a, image_b, flow, preprocess):
    """Full training augmentation of an NHWC f32 batch on its device.

    ``gen``: a ``torch.Generator`` on that device. ``preprocess``: the
    dataset config's PREPROCESS dict. Returns (aug_a, aug_b, aug_flow) at
    (crop_height, crop_width).
    """
    crop_hw = (int(preprocess["crop_height"]), int(preprocess["crop_width"]))
    spec_a = preprocess.get("image_a", {})
    spec_b = preprocess.get("image_b", {})
    batch = image_a.shape[0]
    in_hw = tuple(image_a.shape[1:3])

    coeff_a = sample_spatial_coeffs(gen, spec_a, batch)
    coeff_b = compose_spatial(coeff_a,
                              sample_spatial_coeffs(gen, spec_b, batch))
    theta_a = coeffs_to_affine(coeff_a, in_hw, crop_hw)
    theta_b = coeffs_to_affine(coeff_b, in_hw, crop_hw)

    aug_a = affine_sample(image_a, theta_a, crop_hw)
    aug_b = affine_sample(image_b, theta_b, crop_hw)
    aug_flow = transform_flow(flow, theta_a, theta_b, crop_hw)

    # chromatic-eigen chain (pair-correlated: same coeffs for A and B)
    ce = sample_chromatic_eigen_coeffs(gen, spec_a, batch)
    if ce is not None:
        aug_a = apply_chromatic_eigen(aug_a, ce)
        aug_b = apply_chromatic_eigen(aug_b, ce)

    photo_a = sample_photometric_coeffs(gen, spec_a, batch)
    photo_delta = sample_photometric_coeffs(gen, spec_b, batch)
    photo_b = {
        "noise": photo_a["noise"],
        "brightness": photo_a["brightness"] + photo_delta["brightness"],
        "gamma": photo_a["gamma"] * photo_delta["gamma"],
        "contrast": photo_a["contrast"] * photo_delta["contrast"],
        "color": photo_a["color"] * photo_delta["color"],
    }
    noise_a = torch.randn(aug_a.shape, generator=gen, device=gen.device)
    noise_b = torch.randn(aug_b.shape, generator=gen, device=gen.device)
    aug_a = apply_photometric(aug_a, photo_a, noise_a)
    aug_b = apply_photometric(aug_b, photo_b, noise_b)
    return aug_a, aug_b, aug_flow


def center_crop_batch(image_a, image_b, flow, preprocess):
    """Eval-mode deterministic center crop (no augmentation)."""
    ch = int(preprocess["crop_height"])
    cw = int(preprocess["crop_width"])
    h, w = image_a.shape[1:3]
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    sl = (slice(None), slice(y0, y0 + ch), slice(x0, x0 + cw))
    return image_a[sl], image_b[sl], flow[sl]
