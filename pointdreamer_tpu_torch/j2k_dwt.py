"""JPEG 2000 dequantisation and inverse wavelet transforms (ITU-T T.800
Annexes E and F), in numpy as OpenJPEG 2.5 computes them.

- dequantisation: a reversible band's value is OpenJPEG's half-bit value
  halved towards zero; an irreversible band's is that value times half
  its step size in float32, the step (1 + mantissa / 2^11) *
  2^(precision - exponent) rounded once to float32 (OpenJPEG's decoder
  folds the band gain into the 9/7 synthesis's 2 / K);
- inverse 5/3: integer lifting with symmetric extension, a lone sample
  at an odd coordinate halved (C division, towards zero);
- inverse 9/7: float32 lifting in OpenJPEG's order: the low samples
  times K and the high ones times 2 / K (its 1.625732422f), then the
  four steps with -delta, -gamma, -beta and -alpha, each sample plus
  (left + right) * constant, rounded after every operation (no fused
  multiply-add); a signal of one sample is left as it is.

Each level runs on rows first, then on columns; the parity of each
resolution's x0 and y0 says whether a signal starts with a low or a
high sample.
"""
from __future__ import annotations

import numpy as np

_F = np.float32
_K = _F(1.230174105)
_TWO_INV_K = _F(1.625732422)
_STEPS97 = (_F(-0.443506852), _F(-0.882911075), _F(0.052980118),
            _F(1.586134342))


def step_size(expn: int, mant: int, prec: int) -> np.float32:
    """Half of an irreversible band's step size, as OpenJPEG scales its
    decoded values."""
    delta = _F((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))
    return _F(0.5) * delta


def dequantize(values: np.ndarray, reversible: bool,
               half_step: np.float32) -> np.ndarray:
    if reversible:
        v = values.astype(np.int64)
        return np.where(v < 0, -((-v) >> 1), v >> 1)
    return values.astype(np.float32) * half_step


def _interleave(low: np.ndarray, high: np.ndarray, odd: bool) -> np.ndarray:
    n = low.shape[-1] + high.shape[-1]
    out = np.empty(low.shape[:-1] + (n,), low.dtype)
    out[..., int(odd)::2] = low
    out[..., 1 - int(odd)::2] = high
    return out


def _neighbours(n: int, parity: int):
    idx = np.arange(parity, n, 2)
    left = idx - 1
    right = idx + 1
    left[left < 0] = 1
    right[right >= n] = n - 2
    return idx, left, right


def _synth53(x: np.ndarray, odd: bool) -> np.ndarray:
    """One 5/3 synthesis along the last axis of interleaved `x`."""
    n = x.shape[-1]
    if n == 1:
        if odd:
            v = x
            return np.where(v < 0, -((-v) // 2), v // 2)
        return x
    x = x.copy()
    lo, hi = int(odd), 1 - int(odd)
    idx, left, right = _neighbours(n, lo)
    x[..., idx] -= (x[..., left] + x[..., right] + 2) >> 2
    idx, left, right = _neighbours(n, hi)
    x[..., idx] += (x[..., left] + x[..., right]) >> 1
    return x


def _synth97(x: np.ndarray, odd: bool) -> np.ndarray:
    n = x.shape[-1]
    if n == 1:
        return x
    x = x.copy()
    lo, hi = int(odd), 1 - int(odd)
    x[..., lo::2] *= _K
    x[..., hi::2] *= _TWO_INV_K
    for k, c in enumerate(_STEPS97):
        idx, left, right = _neighbours(n, lo if k % 2 == 0 else hi)
        x[..., idx] = x[..., idx] + (x[..., left] + x[..., right]) * c
    return x


def inverse(ll: np.ndarray, hl: np.ndarray, lh: np.ndarray,
            hh: np.ndarray, x0: int, y0: int, reversible: bool
            ) -> np.ndarray:
    """One level: the sub-bands of a resolution whose origin is (x0, y0)
    to its samples, rows first."""
    synth = _synth53 if reversible else _synth97
    xodd, yodd = bool(x0 & 1), bool(y0 & 1)
    rh, rw = ll.shape[0] + lh.shape[0], ll.shape[1] + hl.shape[1]
    if rh == 0 or rw == 0:
        return np.zeros((rh, rw), ll.dtype)
    top = synth(_interleave(ll, hl, xodd), xodd)
    bottom = synth(_interleave(lh, hh, xodd), xodd)
    return synth(_interleave(top.T, bottom.T, yodd), yodd).T
