"""The port's compact bilinear pooling (hawkeye_tpu_torch/ops/cbp.py)
against the JAX package's (hawkeye_tpu/ops/cbp.py) on the CPU, float32:
the sketch and irDFT matrices bit-equal, and the descriptor of C = 32,
d = 64, 4x4 maps, B = 3 within 1e-5 of its largest value, its input
gradient within 1e-4 of the largest, for the Gram and the per-position
forms, the irDFT and irfft inverses, with and without signed sqrt and L2.
The ops run in float32 and TF32 plays no part on the CPU."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.ops import cbp as jcbp
from hawkeye_tpu_torch.ops import cbp

C, D, B = 32, 64, 3


@pytest.mark.parametrize("in_dim,out_dim,seeds", [(32, 64, (1, 3)),
                                                  (512, 6000, (5, 7))])
def test_sketch_matrix_bit_equal(in_dim, out_dim, seeds):
    got = cbp.make_sketch_matrix(in_dim, out_dim, *seeds)
    want = jcbp.make_sketch_matrix(in_dim, out_dim, *seeds)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [64, 6000])
def test_irdft_half_bit_equal(d):
    for got, want in zip(cbp.make_irdft_half(d), jcbp.make_irdft_half(d)):
        assert got.dtype == want.dtype == np.float32 and got.shape == (d // 2 + 1,) * 2
        np.testing.assert_array_equal(got, want)


def test_sketch_spectrum_matches_jax_host_spectrum():
    s = cbp.make_sketch_matrix(C, D, 1, 3)
    real, imag = cbp.sketch_spectrum(s)
    ref = jcbp._spectrum(s)
    np.testing.assert_array_equal(real, ref.real)
    np.testing.assert_array_equal(imag, ref.imag)


def _inputs():
    rs = np.random.RandomState(0)
    x = np.maximum(rs.randn(B, 4, 4, C), 0).astype(np.float32)
    s1 = cbp.make_sketch_matrix(C, D, 1, 3)
    s2 = cbp.make_sketch_matrix(C, D, 5, 7)
    g = rs.randn(B, D).astype(np.float32)  # cotangent of the descriptor
    return x, s1, s2, g


@pytest.mark.parametrize("via_gram", [True, False], ids=["gram", "per_position"])
@pytest.mark.parametrize("inverse", ["irdft", "irfft"])
@pytest.mark.parametrize("normalise", [True, False], ids=["ssqrt_l2", "raw"])
def test_compact_bilinear_pool_matches_jax(via_gram, inverse, normalise):
    x, s1, s2, g = _inputs()
    kw = dict(signed_sqrt=normalise, l2_normalize=normalise, via_gram=via_gram)
    j_irdft = tuple(jnp.asarray(m) for m in jcbp.make_irdft_half(D))
    p_irdft = tuple(torch.from_numpy(m) for m in cbp.make_irdft_half(D))

    def jfn(xx):
        v = jcbp.compact_bilinear_pool(
            xx, s1, s2, irdft=j_irdft if inverse == "irdft" else None, **kw)
        return (v * g).sum(), v

    (_, want), want_dx = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    spec = [tuple(torch.from_numpy(a) for a in cbp.sketch_spectrum(s))
            for s in (s1, s2)]
    got = cbp.compact_bilinear_pool(
        xt, *spec, out_dim=D, irdft=p_irdft if inverse == "irdft" else None, **kw)
    (got * torch.from_numpy(g)).sum().backward()

    want, want_dx = np.asarray(want), np.asarray(want_dx)
    assert got.shape == (B, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=1e-4 * np.abs(want_dx).max())


def test_gram_and_per_position_forms_agree():
    x, s1, s2, _ = _inputs()
    spec = [tuple(torch.from_numpy(a) for a in cbp.sketch_spectrum(s))
            for s in (s1, s2)]
    xt = torch.from_numpy(x)
    a = cbp.compact_bilinear_pool(xt, *spec, via_gram=True)
    b = cbp.compact_bilinear_pool(xt, *spec, via_gram=False)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    # unit rows after the L2 normalisation
    torch.testing.assert_close(torch.linalg.vector_norm(a, dim=-1),
                               torch.ones(B), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_head_computes_in_the_spectra_dtype(dtype):
    """float32 spectra make a float32 head whatever the features' dtype; the
    float64 spectra and irDFT matrices of a reference make a float64 one,
    which the float32 head meets within 1e-5 of the largest value."""
    x, s1, s2, _ = _inputs()
    xt = torch.from_numpy(x)
    spec = [tuple(torch.from_numpy(a) for a in cbp.sketch_spectrum(s))
            for s in (s1, s2)]
    irdft = tuple(torch.from_numpy(m) for m in cbp.make_irdft_half(D))
    want = cbp.compact_bilinear_pool(xt, *spec, irdft=irdft)
    if dtype == torch.float64:
        spec = [tuple(a.double() for a in s) for s in spec]
        irdft = tuple(m.double() for m in irdft)
    got = cbp.compact_bilinear_pool(xt.to(dtype), *spec, irdft=irdft)
    assert got.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
    if dtype != torch.bfloat16:
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
