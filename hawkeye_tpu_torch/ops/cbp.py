"""Compact bilinear pooling (count sketch + FFT), plain PyTorch.

Counterpart of ``hawkeye_tpu/ops/cbp.py`` (reference
``model/methods/CBCNN.py:38-164``): two fixed count sketches project the
C-dim features to d dims; their outer product is taken implicitly in the
Fourier domain, ``irfft(rfft(Psi1 x) * rfft(Psi2 x))``, sum-pooled over
positions, then signed square root and L2 normalisation.

The same design as the JAX package:

* the sketches are dense ``[C, d]`` matrices and their rfft (``[C, K]``,
  ``K = d // 2 + 1``) is computed once on the host with ``np.fft.rfft``
  (``sketch_spectrum``), so the projection and the forward transform are
  one matmul per branch and part; no FFT runs per step;
* the spatial sum-pool comes before the inverse transform (it is linear),
  so one length-d inverse per image remains;
* the Gram form (default): the pooled spectrum is ``s1[:, f]^T M s2[:, f]``
  with ``M = sum_p x_p x_p^T``, one float32 ``[B, C, C]`` Gram, then
  ``einsum("ck,bcd->kbd")`` for the real and imaginary parts and a
  per-frequency reduction over ``d``. ``via_gram=False`` is the per-position
  form, kept as the parity oracle;
* the inverse: ``make_irdft_half``'s two ``[K, K]`` matrices when ``irdft``
  is given (``_irdft_apply``), else ``torch.fft.irfft``.

This head is plain XLA in the JAX package, not a Pallas kernel, so it stays
``torch.bmm``/``einsum`` here. Everything runs in float32; with TF32 off (the
Trainer's ``set_tf32(False)``) a float32 matmul is the counterpart of JAX's
``Precision.HIGHEST`` in ``_irdft_apply``. The irDFT matrices must stay
float32: a bfloat16 cast breaks the tolerance. The head computes in the
spectra's dtype: float64 spectra and matrices make a float64 reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .bilinear import l2_rows


def make_sketch_matrix(in_dim: int, out_dim: int, seed_h: int, seed_s: int,
                       dtype=np.float32):
    """Dense count-sketch matrix [in_dim, out_dim]: one +-1 per row at a
    hashed column (fixed seeds give a fixed sketch, reference seeds
    1/3/5/7). A copy of the JAX package's numpy function, bit for bit."""
    rng_h = np.random.RandomState(seed_h)
    rng_s = np.random.RandomState(seed_s)
    h = rng_h.randint(0, out_dim, size=in_dim)
    s = rng_s.randint(0, 2, size=in_dim) * 2 - 1
    m = np.zeros((in_dim, out_dim), dtype)
    m[np.arange(in_dim), h] = s.astype(dtype)
    return m


def make_irdft_half(d: int):
    """Half-spectrum inverse-rDFT matrices ``(C, S)`` [K, K] for an even d.

    ``P = sr @ C``, ``Q = si @ S``; ``v[0:K] = P + Q`` and
    ``v[d - t] = P[t] - Q[t]`` for ``t = 1..K-2``, with
    ``C[f, t] = w_f cos(2 pi f t / d) / d``, ``S[f, t] = -w_f sin(...) / d``,
    ``w_f = 2`` except ``w_0 = w_{K-1} = 1``. float32 numpy arrays, as the
    JAX package builds them."""
    assert d % 2 == 0, "irdft matmul path assumes even length"
    k = d // 2 + 1
    f = np.arange(k, dtype=np.float64)[:, None]
    t = np.arange(k, dtype=np.float64)[None, :]
    w = np.full((k, 1), 2.0)
    w[0, 0] = 1.0
    w[-1, 0] = 1.0
    ang = 2.0 * np.pi * f * t / d
    cos_m = (np.cos(ang) * w / d).astype(np.float32)
    sin_m = (-np.sin(ang) * w / d).astype(np.float32)
    return cos_m, sin_m


def sketch_spectrum(sketch: np.ndarray):
    """Host rfft of a fixed sketch matrix: (real, imag), float32 [C, K]."""
    f = np.fft.rfft(sketch.astype(np.float32), axis=-1)
    return f.real.astype(np.float32), f.imag.astype(np.float32)


def _irdft_apply(sr, si, irdft):
    cos_m, sin_m = irdft
    k = sr.shape[-1]
    p = sr @ cos_m  # [B, K]
    q = si @ sin_m
    front = p + q  # v[0 .. K-1]
    back = (p - q)[:, 1:k - 1].flip(-1)  # v[K .. d-1], reversed symmetry
    return torch.cat([front, back], dim=-1)


def compact_bilinear_pool(features, spectrum1, spectrum2, *, out_dim=None,
                          signed_sqrt=True, l2_normalize=True, eps=1e-10,
                          via_gram=True, irdft=None):
    """[B, H, W, C] -> [B, d] compact bilinear descriptor in the spectra's
    dtype: float32, or float64 for a reference.

    ``spectrum1``/``spectrum2``: ``(real, imag)`` tensors [C, K], the
    rfft of the two sketches (``sketch_spectrum``), on the features' device.
    ``out_dim`` is d (default ``2 * (K - 1)``); ``irdft`` the two
    ``make_irdft_half`` matrices, else the inverse is ``torch.fft.irfft``.
    """
    b, h, w, c = features.shape
    s1r, s1i = spectrum1
    s2r, s2i = spectrum2
    d = out_dim or 2 * (s1r.shape[1] - 1)
    x = features.reshape(b, h * w, c).to(s1r.dtype)
    if via_gram:
        gram = torch.bmm(x.transpose(1, 2), x)  # [B, C, C]
        # W[k, b, d] = sum_c s2[c, k] M[b, c, d]; M is symmetric, so the
        # s2-side product serves both factors
        wr = torch.einsum("ck,bcd->kbd", s2r, gram)  # [K, B, C]
        wi = torch.einsum("ck,bcd->kbd", s2i, gram)
        # V[f] = s1[:, f]^T (M s2[:, f]): a reduction over d per frequency
        sr = torch.einsum("kbd,dk->bk", wr, s1r) - torch.einsum(
            "kbd,dk->bk", wi, s1i)  # [B, K]
        si = torch.einsum("kbd,dk->bk", wi, s1r) + torch.einsum(
            "kbd,dk->bk", wr, s1i)
    else:
        f1r, f1i = x @ s1r, x @ s1i  # [B, HW, K]
        f2r, f2i = x @ s2r, x @ s2i
        # per-position complex product, sum-pooled over positions
        sr = (f1r * f2r - f1i * f2i).sum(dim=1)  # [B, K]
        si = (f1r * f2i + f1i * f2r).sum(dim=1)
    if irdft is not None:
        v = _irdft_apply(sr, si, irdft)  # [B, d]
    else:
        v = torch.fft.irfft(torch.complex(sr, si), n=d, dim=-1)
    if signed_sqrt:
        v = torch.sign(v) * torch.sqrt(torch.abs(v) + eps)
    if l2_normalize:
        v = l2_rows(v)
    return v
