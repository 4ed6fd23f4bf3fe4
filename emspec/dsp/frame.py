"""Frame extraction: slice a signal into overlapping analysis frames (L2).

Convention (shared with the float64 oracle in ``tests/oracle.py``):
frame ``t`` covers samples ``[t*hop, t*hop + n)`` and its *center* — the
time the resulting spectrogram column represents — is sample
``t*hop + n/2``.  The reassignment time correction Δt is measured from
that center (see ``emspec.dsp.windows``).

Reference behavior evidence: the "FFT Size" dropdown and "Scroll Speed"
slider (reference README.md:43-44) couple frame length and hop to the
display column rate; the north star calls these "ring-buffer hops"
[NS configs[3]].
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def num_frames(num_samples: int, n: int, hop: int) -> int:
    """Frames that fit fully inside ``num_samples`` (no padding)."""
    if num_samples < n:
        return 0
    return (num_samples - n) // hop + 1


def frame_signal(x: jnp.ndarray, n: int, hop: int) -> jnp.ndarray:
    """(..., samples) → (..., frames, n) overlapping frames (device, jit-safe).

    NOT a gather: frame starts are multiples of ``hop``, so reshaping the
    signal to (rows, hop) makes frame ``t`` exactly rows ``t..t+m-1``
    concatenated (m = ⌈n/hop⌉).  The result is built from m contiguous
    slice copies, bitwise identical to the equivalent (t, n) index
    gather.
    """
    t = num_frames(x.shape[-1], n, hop)
    if t <= 0:
        return jnp.zeros(x.shape[:-1] + (0, n), x.dtype)
    m = -(-n // hop)                                # frame length in blocks
    need = (t + m - 1) * hop                        # whole hop blocks
    pad = need - x.shape[-1]
    if pad > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    x2 = x[..., :need].reshape(x.shape[:-1] + (t + m - 1, hop))
    blocks = [x2[..., j:j + t, :] for j in range(m)]   # each (..., t, hop)
    return jnp.concatenate(blocks, axis=-1)[..., :n]


def frame_signal_np(x: np.ndarray, n: int, hop: int) -> np.ndarray:
    """Host-side zero-copy framing via stride tricks (for the ingest path)."""
    t = num_frames(x.shape[-1], n, hop)
    if t <= 0:
        return np.zeros(x.shape[:-1] + (0, n), x.dtype)
    s = x.strides[-1]
    return np.lib.stride_tricks.as_strided(
        x,
        shape=x.shape[:-1] + (t, n),
        strides=x.strides[:-1] + (hop * s, s),
        writeable=False,
    )
