"""Batched FFT phase cross-correlation with upsampled-DFT subpixel refinement.

Accelerator implementation of the published phase-correlation algorithm
(Guizar-Sicairos et al. 2008, "Efficient subpixel image registration
algorithms") that scikit-image implements and the reference calls as
``phase_cross_correlation(a, b, upsample_factor=10)`` with default
("phase") normalization (stitcher.py:510,523).

Design notes:
- The coarse peak comes from jnp.fft FFTs (cuFFT on the GPU).
- The subpixel refinement is two matrix multiplies per axis (the matrix
  DFT evaluated only on an upsampled patch around the coarse peak),
  vmap-batched over many tile pairs at once. They run at HIGHEST
  precision: a float32 product may otherwise run in TF32 on the GPU,
  whose ~3 significant digits would move the refined peak.
- Everything is jit-compatible with static shapes; `upsample_factor` is
  a static argument.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _fftfreq(n: int, d: float) -> jnp.ndarray:
    """np.fft.fftfreq as a jnp constant (static n)."""
    val = 1.0 / (n * d)
    m = (n - 1) // 2 + 1
    p1 = jnp.arange(0, m, dtype=jnp.float32)
    p2 = jnp.arange(-(n // 2), 0, dtype=jnp.float32)
    return jnp.concatenate([p1, p2]) * val


HIGHEST = jax.lax.Precision.HIGHEST


def _upsampled_patch(product: jnp.ndarray, ups_size: int, upsample_factor: int,
                     offsets: jnp.ndarray, precision=HIGHEST) -> jnp.ndarray:
    """|upsampled cross-correlation| patch around the coarse peak."""
    # Evaluate conj(product) on the patch, then conjugate back: equivalent
    # to evaluating the inverse DFT at upsampled positions.
    data = jnp.conj(product)
    # axis 1 (x) first, then axis 0 (y) — each tensordot brings the
    # transformed axis to the front, so after two passes order is (y, x).
    n1 = data.shape[1]
    freqs1 = _fftfreq(n1, float(upsample_factor))
    k1 = (jnp.arange(ups_size, dtype=jnp.float32)[:, None] - offsets[1]) * freqs1[None, :]
    kernel1 = jnp.exp((-2j * jnp.pi) * k1.astype(jnp.complex64))
    data = jnp.tensordot(kernel1, data, axes=((1,), (1,)),
                         precision=precision)  # (ups, H)
    n0 = data.shape[1]
    freqs0 = _fftfreq(n0, float(upsample_factor))
    k0 = (jnp.arange(ups_size, dtype=jnp.float32)[:, None] - offsets[0]) * freqs0[None, :]
    kernel0 = jnp.exp((-2j * jnp.pi) * k0.astype(jnp.complex64))
    data = jnp.tensordot(kernel0, data, axes=((1,), (1,)),
                         precision=precision)  # (ups_y, ups_x)
    return jnp.conj(data)


def _pcc_core(reference: jnp.ndarray, moving: jnp.ndarray,
              upsample_factor: int, precision=HIGHEST):
    """(shifts, peak) from ONE set of FFTs.

    The conf variant must not re-trace a second FFT pipeline for the
    shift — FFTs lower to backend custom calls on some backends, where
    XLA CSE cannot deduplicate them, doubling registration cost."""
    a = reference.astype(jnp.float32)
    b = moving.astype(jnp.float32)
    h, w = a.shape
    fa = jnp.fft.fft2(a)
    fb = jnp.fft.fft2(b)
    product = fa * jnp.conj(fb)
    # "phase" normalization: whiten to unit magnitude with eps guard.
    eps = 100.0 * jnp.finfo(jnp.float32).eps
    product = product / jnp.maximum(jnp.abs(product), eps)
    corr = jnp.fft.ifft2(product)
    mag = jnp.abs(corr)
    # normalized correlation peak: 1.0 for a perfect circular shift,
    # ~1/sqrt(HW) for unrelated content
    peak = jnp.max(mag)
    flat_idx = jnp.argmax(mag)
    my = (flat_idx // w).astype(jnp.float32)
    mx = (flat_idx % w).astype(jnp.float32)
    mid_y = float(math.floor(h / 2))
    mid_x = float(math.floor(w / 2))
    sy = jnp.where(my > mid_y, my - h, my)
    sx = jnp.where(mx > mid_x, mx - w, mx)
    shifts = jnp.stack([sy, sx])

    if upsample_factor <= 1:
        return shifts, peak

    uf = float(upsample_factor)
    shifts = jnp.round(shifts * uf) / uf
    ups_size = int(math.ceil(uf * 1.5))
    dftshift = float(math.trunc(ups_size / 2.0))
    offsets = dftshift - shifts * uf
    patch = _upsampled_patch(product, ups_size, upsample_factor, offsets,
                             precision)
    pmag = jnp.abs(patch)
    pidx = jnp.argmax(pmag)
    py = (pidx // ups_size).astype(jnp.float32) - dftshift
    px = (pidx % ups_size).astype(jnp.float32) - dftshift
    return shifts + jnp.stack([py, px]) / uf, peak


@functools.partial(jax.jit, static_argnames=('upsample_factor',))
def phase_cross_correlation(reference: jnp.ndarray, moving: jnp.ndarray,
                            upsample_factor: int = 10) -> jnp.ndarray:
    """Subpixel shift (dy, dx) registering ``moving`` to ``reference``.

    Matches the published algorithm the reference relies on: coarse
    integer peak from the phase-normalized cross-power spectrum, then
    an ``upsample_factor``-times refined peak from a local matrix DFT.
    Positive shift means ``moving`` is displaced by that amount relative
    to ``reference`` (same sign convention as scikit-image).
    """
    return _pcc_core(reference, moving, upsample_factor)[0]


# Batched variant: (N, H, W) pairs -> (N, 2) shifts.
phase_cross_correlation_batch = jax.jit(
    jax.vmap(phase_cross_correlation, in_axes=(0, 0, None)),
    static_argnames=('upsample_factor',))


@functools.partial(jax.jit, static_argnames=('upsample_factor',))
def phase_cross_correlation_conf(reference: jnp.ndarray, moving: jnp.ndarray,
                                 upsample_factor: int = 10):
    """Like :func:`phase_cross_correlation`, also returning a confidence.

    Confidence = the normalized correlation peak height (the whitened
    cross-power spectrum's inverse transform peaks at 1.0 for a perfect
    circular shift and near 1/sqrt(HW) for unrelated content); used to
    weight pairwise constraints in the global position solve. Shares
    one set of FFTs with the shift (see _pcc_core).
    """
    return _pcc_core(reference, moving, upsample_factor)


phase_cross_correlation_conf_batch = jax.jit(
    jax.vmap(phase_cross_correlation_conf, in_axes=(0, 0, None)),
    static_argnames=('upsample_factor',))


def phase_cross_correlation_conf_np(reference: np.ndarray,
                                    moving: np.ndarray,
                                    upsample_factor: int = 10):
    """Host twin of :func:`phase_cross_correlation_conf`:
    (shift, normalized correlation peak). Shares one set of FFTs."""
    shift, peak = _pcc_np(reference, moving, upsample_factor)
    return shift, peak


def phase_cross_correlation_np(reference: np.ndarray, moving: np.ndarray,
                               upsample_factor: int = 10) -> np.ndarray:
    """Host (SciPy FFT, float64) twin of :func:`phase_cross_correlation`.

    Used for one-shot measurements (the reference's center-pair scope)
    and small pair batches; the batched all-pairs path runs the jitted
    device version. Same algorithm, same results within 0.1 px (tested).
    """
    return _pcc_np(reference, moving, upsample_factor)[0]


def _pcc_np(reference: np.ndarray, moving: np.ndarray,
            upsample_factor: int) -> tuple:
    from scipy import fft as sfft
    a = np.asarray(reference, np.float64)
    b = np.asarray(moving, np.float64)
    h, w = a.shape
    product = sfft.fft2(a) * np.conj(sfft.fft2(b))
    eps = 100 * np.finfo(np.float64).eps
    product /= np.maximum(np.abs(product), eps)
    corr = sfft.ifft2(product)
    my, mx = np.unravel_index(np.argmax(np.abs(corr)), corr.shape)
    shifts = np.array([my, mx], np.float64)
    mids = np.array([np.fix(h / 2), np.fix(w / 2)])
    shifts[shifts > mids] -= np.array([h, w])[shifts > mids]
    peak = float(np.max(np.abs(corr)))
    if upsample_factor <= 1:
        return shifts, peak
    uf = float(upsample_factor)
    shifts = np.round(shifts * uf) / uf
    ups_size = int(math.ceil(uf * 1.5))
    dftshift = float(math.trunc(ups_size / 2.0))
    offsets = dftshift - shifts * uf
    # matrix-DFT patch, axis x then axis y (same as the device kernel)
    data = np.conj(product)
    for axis, off in ((1, offsets[1]), (0, offsets[0])):
        n = data.shape[1]
        freqs = np.fft.fftfreq(n, uf)
        kernel = np.exp(-2j * np.pi * (np.arange(ups_size)[:, None] - off)
                        * freqs[None, :])
        data = np.tensordot(kernel, data, axes=((1,), (1,)))
    patch = np.conj(data)
    py, px = np.unravel_index(np.argmax(np.abs(patch)), patch.shape)
    return shifts + (np.array([py, px], np.float64) - dftshift) / uf, peak


@functools.partial(jax.jit, static_argnames=('dtype_max',))
def normalize_to_dtype_range(img: jnp.ndarray, dtype_max: float) -> jnp.ndarray:
    """Min-max normalize then scale to the dtype range (float result).

    Parity with reference stitcher.py:613-617 up to the final integer
    cast: the reference casts back to uint16 before correlating; we keep
    floats (the cast only quantizes — validated ≤0.1 px in tests).
    """
    lo = jnp.min(img)
    hi = jnp.max(img)
    return (img.astype(jnp.float32) - lo) / jnp.maximum(hi - lo, 1e-12) * dtype_max


def normalize_to_dtype_range_np(img: np.ndarray, dtype_max: float) -> np.ndarray:
    """Host twin of :func:`normalize_to_dtype_range`."""
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / max(hi - lo, 1e-12) * dtype_max


def horizontal_shift_from_pcc(shift: jnp.ndarray, strip_w: int) -> Tuple[int, int]:
    """h_shift = (round(sy), round(sx - strip_w)) (reference stitcher.py:511)."""
    sy, sx = float(shift[0]), float(shift[1])
    return round(sy), round(sx - strip_w)


def vertical_shift_from_pcc(shift: jnp.ndarray, strip_h: int) -> Tuple[int, int]:
    """v_shift = (round(sy - strip_h), round(sx)) (reference stitcher.py:524)."""
    sy, sx = float(shift[0]), float(shift[1])
    return round(sy - strip_h), round(sx)
