"""The correlation backward's decomposition, against the JAX package, on the CPU.

The port's backward kernels compute da and db with one body,
``out[p, c] = (1/C) sum_k G[p, k] * S[p + delta_k, c]`` (plain version:
``ops/correlation.py::_correlation_da_form``): da with ``(G, S) = (g, b)``
and db with ``(g', a)``, where ``g'[q, k] = g[q + delta_k, D*D-1-k]`` is
the mirror-shifted gradient (plain version: ``_mirror_shift_grad``). These
tests hold that decomposition against the JAX package's backward
(``jax.vjp`` of ``correlation_pallas`` in interpret mode, whose ``_bwd``
differentiates the jnp oracle, and of the oracle itself), and check the
numerical basis of the bf16 kernel: g split into two bf16 halves hi + lo
reproduces ``_bwd``'s bf16 gradients, one bf16 rounding of g does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from flownet2_tf_tpu.ops.correlation import _correlation_oracle  # noqa: E402
from flownet2_tf_tpu.ops.pallas.correlation_kernel import correlation_pallas  # noqa: E402
from flownet2_tf_tpu_torch.ops import correlation as tcorr  # noqa: E402

T = torch.from_numpy

CASES = [
    # tests/test_torch_train.py::CORR_CASES (tests/test_pallas_kernels.py)
    ((1, 16, 16, 128), 4, 2),
    ((2, 8, 24, 128), 4, 2),
    ((1, 12, 16, 256), 6, 2),
    ((1, 8, 16, 128), 3, 1),
    ((1, 8, 12, 64), 4, 2),
    # s2 = 3, and an odd W
    ((1, 9, 12, 32), 6, 3),
    ((2, 7, 13, 16), 4, 2),
]


def _inputs(rng, shape, d, s2):
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    dd = (2 * (d // s2) + 1) ** 2
    g = rng.randn(*shape[:3], dd).astype(np.float32)
    return a, b, g


def _vjp(fn, a, b, g):
    _, vjp = jax.vjp(fn, a, b)
    return vjp(g)


def _decomposed(g, a, b, r, s2):
    """(da, db) through the kernels' common body."""
    return (tcorr._correlation_da_form(g, b, r, s2),
            tcorr._correlation_da_form(tcorr._mirror_shift_grad(g, r, s2),
                                       a, r, s2))


@pytest.mark.parametrize("shape,d,s2", CASES)
def test_da_form_and_mirror_shift_match_jax_backward(rng, shape, d, s2):
    a, b, g = _inputs(rng, shape, d, s2)
    kw = dict(kernel_size=1, max_displacement=d, stride_1=1, stride_2=s2,
              pad=d)
    want = _vjp(lambda x, y: _correlation_oracle(x, y, 1, d, 1, s2, d),
                a, b, g)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = _vjp(lambda x, y: correlation_pallas(x, y, **kw),
                           a, b, g)
    got = _decomposed(T(g), T(a), T(b), d // s2, s2)
    for t, j, p in zip(got, want, want_pallas):
        assert t.dtype == torch.float32 and t.shape == a.shape
        # f32 sums of D**2 products in another order
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t.numpy(), np.asarray(p), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape,d,s2", [((2, 5, 7, 3), 4, 2),
                                         ((1, 6, 9, 2), 3, 1),
                                         ((1, 7, 8, 2), 6, 3)])
def test_mirror_shift_matches_its_definition(rng, shape, d, s2):
    """g'[n, y, x, k] = g[n, y + dy_k, x + dx_k, D*D-1-k], zero outside."""
    r = d // s2
    dd = 2 * r + 1
    n, h, w, _ = shape
    g = rng.randn(n, h, w, dd * dd).astype(np.float32)
    want = np.zeros_like(g)
    for y in range(h):
        for x in range(w):
            for k in range(dd * dd):
                qy = y + (k // dd - r) * s2
                qx = x + (k % dd - r) * s2
                if 0 <= qy < h and 0 <= qx < w:
                    want[:, y, x, k] = g[:, qy, qx, dd * dd - 1 - k]
    got = tcorr._mirror_shift_grad(T(g), r, s2)
    assert torch.equal(got, T(want))


def _bf16_pair(rng, shape):
    """Values rounded to bf16, as a JAX bf16 array and a torch one."""
    x = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("shape,d,s2", [((1, 8, 16, 128), 4, 2),
                                         ((1, 8, 12, 32), 20, 2)])
def test_bf16_split_of_g_matches_jax_bwd(rng, shape, d, s2):
    """The bf16 kernel multiplies bf16 features by g split as hi = bf16(g)
    and lo = bf16(g - hi), every product exact in f32, and rounds the f32
    sum to bf16 once: within one bf16 step of _bwd's bf16 gradients
    (rtol 2**-7, the tolerance the card tests hold the kernel to). One
    bf16 rounding of g instead misses them."""
    ja, ta = _bf16_pair(rng, shape)
    jb, tb = _bf16_pair(rng, shape)
    r = d // s2
    g = rng.randn(*shape[:3], (2 * r + 1) ** 2).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _vjp(lambda x, y: correlation_pallas(x, y, 1, d, 1, s2, d),
                    ja, jb, g)
    tol = dict(rtol=2.0 ** -7, atol=1e-5)

    def through(G, S, split):
        hi = G.bfloat16().float()
        out = tcorr._correlation_da_form(hi, S, r, s2)
        if split:
            lo = (G - hi).bfloat16().float()
            out = out + tcorr._correlation_da_form(lo, S, r, s2)
        return out.bfloat16()

    G = T(g)
    for (Gx, S), j in zip(((G, tb), (tcorr._mirror_shift_grad(G, r, s2), ta)),
                          want):
        assert j.dtype == jnp.bfloat16
        ref = np.asarray(j.astype(jnp.float32))
        split = through(Gx, S, split=True)
        np.testing.assert_allclose(split.float().numpy(), ref, **tol)
        single = through(Gx, S, split=False).float().numpy()
        assert not np.allclose(single, ref, **tol)
