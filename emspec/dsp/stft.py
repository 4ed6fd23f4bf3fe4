"""Batched short-time Fourier transform (L2).

"Natural" mode of the reference (settings.png button) is the plain
``|X_h|^2`` power spectrogram of this module [NS configs[0]: "2048-pt Hann
STFT magnitude spectrogram + dB mapping"].

Realization (SURVEY.md §2.2): the three reassignment windows are applied
as one broadcast multiply (fused by XLA) and a **single batched**
``jnp.fft.rfft`` runs over a ``(3, ..., frames, n)`` stack — XLA's FFT
(cuFFT on the GPU) does the transform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from emspec.dsp.frame import frame_signal
from emspec.dsp.windows import hann, window_triple


def stft(x: jnp.ndarray, n: int, hop: int) -> jnp.ndarray:
    """(..., samples) → complex STFT (..., frames, n//2+1) with Hann window."""
    frames = frame_signal(x, n, hop)
    w = jnp.asarray(hann(n, frames.dtype))
    return jnp.fft.rfft(frames * w, axis=-1)


def power_spectrogram(x: jnp.ndarray, n: int, hop: int) -> jnp.ndarray:
    """Natural-mode power spectrogram |X_h|^2, shape (..., frames, n//2+1)."""
    X = stft(x, n, hop)
    return (X.real * X.real + X.imag * X.imag).astype(jnp.float32)


def stft_triple(x: jnp.ndarray, n: int, hop: int,
                method: str = "stencil") -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The three auxiliary-window STFTs needed by reassignment.

    Returns ``(X_h, X_th, X_dh)`` each of shape (..., frames, n//2+1).

    method="direct": one rfft over a stacked (3, ..., frames, n) batch —
    the straightforward formulation (SURVEY.md §2.2 "Batched rFFT").

    method="stencil" (default): only **2** rffts (raw frame + t·h frame);
    ``X_h`` and ``X_dh`` follow *exactly* (modulation theorem, exact on
    the DFT grid for the periodic Hann) from 3-point stencils on the raw
    spectrum:

        X_h(k)  = ½X(k) − ¼X(k−1) − ¼X(k+1)
        X_dh(k) = −i·(π/2N)·(X(k−1) − X(k+1))

    33% less FFT work — the dominant stage of the hot path.  Differences
    vs "direct" are float32 rounding only (parity-tested).  rfft (unlike
    a packed complex FFT) is bitwise batch-shape-stable, which preserves
    the streaming ≡ batch bit-exactness guarantee.
    """
    frames = frame_signal(x, n, hop)                       # (..., t, n)
    if method == "direct":
        X = jnp.fft.rfft(windowed_triple(frames), axis=-1)  # (3, ..., t, k)
        return X[0], X[1], X[2]
    return stft_triple_stencil(frames)


def windowed_triple(frames: jnp.ndarray) -> jnp.ndarray:
    """Frames (..., n) → (3, ..., n) under the windows (h, t·h, dh/dt):
    the direct method's one broadcast multiply (XLA fuses it into a
    single pass over the frames)."""
    n = frames.shape[-1]
    w3 = jnp.asarray(window_triple(n, frames.dtype))       # (3, n)
    return frames[None, ...] * w3.reshape((3,) + (1,) * (frames.ndim - 1)
                                          + (n,))


def stencil_from_raw(X: jnp.ndarray, X_th: jnp.ndarray, n: int):
    """(raw spectrum, t·h spectrum) → (X_h, X_th, X_dh) via the exact
    periodic-Hann stencils; neighbors at k = −1 and N/2+1 come from
    Hermitian symmetry of the real input."""
    Xm1 = jnp.concatenate([jnp.conj(X[..., 1:2]), X[..., :-1]], axis=-1)
    Xp1 = jnp.concatenate([X[..., 1:], jnp.conj(X[..., -2:-1])], axis=-1)
    X_h = 0.5 * X - 0.25 * (Xm1 + Xp1)
    X_dh = _mul_neg_i(0.5 * jnp.pi / n, Xm1 - Xp1)
    return X_h, X_th, X_dh


def _mul_neg_i(c: float, z: jnp.ndarray) -> jnp.ndarray:
    """(−i·c)·z for real c, in real arithmetic: re = c·z.im, im = −c·z.re.

    Mathematically identical to ``(-1j * c) * z`` but one real multiply
    cheaper, and it never materializes a complex constant."""
    c = jnp.asarray(c, z.real.dtype)
    return jax.lax.complex(c * z.imag, -c * z.real)


def stft_triple_stencil(frames: jnp.ndarray, fft_impl: str = "xla"
                        ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Stencil-method reassignment spectra from pre-cut frames (..., n) —
    see :func:`stft_triple`.  Works on any leading shape (the frame axis
    is optional: streaming passes single windows).

    fft_impl="xla": two batched rffts (bitwise batch-shape-stable).
    fft_impl="fourstep": ONE complex four-step matmul FFT with the raw
    and t·h frames packed as real/imag (emspec.dsp.fourstep);
    float32-rounding-level differences vs "xla".
    """
    n = frames.shape[-1]
    X, X_th = stft_raw_pair(frames, fft_impl)
    return stencil_from_raw(X, X_th, n)


def stft_raw_pair(frames: jnp.ndarray, fft_impl: str = "xla"
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(raw spectrum X, t·h spectrum X_th) of pre-cut frames — the shared
    front half of the stencil method (see stft_triple_stencil for the
    engine semantics)."""
    from emspec.dsp.windows import time_weighted_hann

    n = frames.shape[-1]
    th = jnp.asarray(time_weighted_hann(n, frames.dtype))
    if fft_impl == "fourstep":
        from emspec.dsp.fourstep import packed_pair_fft
        return packed_pair_fft(frames, frames * th)
    stack = jnp.stack([frames, frames * th])               # (2, ..., n)
    F = jnp.fft.rfft(stack, axis=-1)                       # (2, ..., k)
    return F[0], F[1]
