"""Time-frequency reassignment — "Enhanced" mode (L2, the product's core).

Reference evidence: README.md:11 ("Reassignment Method — Advanced frequency
analysis for sharper spectral detail"), the "Enhanced" button in
assets/settings.png, and the thread-like sharpened partials visible in
assets/spectrogram.png.  Math per the Auger–Flandrin operators (Fulop &
Fitz, *A Unified Theory of Time-Frequency Reassignment*, PAPERS.md):

With ``X_h``, ``X_th``, ``X_dh`` the STFTs under the Hann window, the
time-weighted window ``(n - N/2)·h[n]`` and the analytic derivative
window ``dh/dn`` (see ``emspec.dsp.windows``):

* time correction  ``Δt = Re(X_th · conj(X_h)) / |X_h|²``  [samples from
  frame center] — an impulse at offset u₀ inside the frame yields exactly
  Δt = u₀;
* frequency correction ``Δω = −Im(X_dh · conj(X_h)) / |X_h|²`` [rad/sample]
  — a pure tone at ω₀ yields ω̂ = ω_k + Δω = ω₀.

Each bin's power ``|X_h|²`` is scatter-added into the *reassigned* cell
``(round(t + Δt/hop), round(k + Δω·N/2π))`` of the (frames, bins) grid.

The scatter is a data-dependent scatter-add (SURVEY.md §3.2 "hottest
kernel"): flatten (t_bin·K + f_bin) ids and ``segment_sum`` them
(``emspec.dsp.histogram``) — sort-free and fully jittable, parity-tested
against the float64 oracle (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from emspec.dsp.stft import stft_triple

# Power below this (absolute, on |X_h|^2 of float32 frames in [-1,1]) is
# dropped rather than reassigned: corrections of near-silent bins are pure
# noise (SURVEY.md §2.2 "bins with |X_h|²≈0 are dropped").
DEFAULT_POWER_FLOOR = 1e-12


def reassignment_corrections(
    X_h: jnp.ndarray, X_th: jnp.ndarray, X_dh: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """→ (power |X_h|², Δt samples, Δω rad/sample), all float32, elementwise."""
    re_h, im_h = X_h.real, X_h.imag
    power = re_h * re_h + im_h * im_h
    inv = 1.0 / jnp.maximum(power, 1e-30)
    # Re(a · conj(b)) = a.re*b.re + a.im*b.im ; Im(a · conj(b)) = a.im*b.re - a.re*b.im
    dt = (X_th.real * re_h + X_th.imag * im_h) * inv
    dw = -(X_dh.imag * re_h - X_dh.real * im_h) * inv
    return power.astype(jnp.float32), dt.astype(jnp.float32), dw.astype(jnp.float32)


def reassigned_bins(
    power: jnp.ndarray, dt: jnp.ndarray, dw: jnp.ndarray,
    n: int, hop: int, num_frames: int,
    power_floor: float = DEFAULT_POWER_FLOOR,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Quantize corrections to integer (t_bin, f_bin) targets.

    Inputs are (..., frames, K).  Returns (t_bin, f_bin, masked_power) where
    out-of-range / sub-floor cells carry zero power and clamped indices.
    """
    k_count = n // 2 + 1
    t_idx = jnp.arange(num_frames, dtype=jnp.int32)[:, None]        # (t, 1)
    k_idx = jnp.arange(k_count, dtype=jnp.float32)[None, :]          # (1, k)
    # frame centers are hop samples apart → Δt in samples / hop = Δ columns.
    # The column offset is rounded *relative* (δ then + t) so batch,
    # streaming, and the float64 oracle quantize identically at any t.
    t_bin = t_idx + jnp.round(dt / float(hop)).astype(jnp.int32)
    f_hat = k_idx + dw * (float(n) / (2.0 * jnp.pi))                 # in bin units
    f_bin = jnp.round(f_hat).astype(jnp.int32)
    valid = (
        (power > power_floor)
        & (t_bin >= 0) & (t_bin < num_frames)
        & (f_bin >= 0) & (f_bin < k_count)
        # a correction beyond the window half-support N/2 is a numerical
        # artifact (Δt is a first moment over [−N/2, N/2] — DESIGN.md §3)
        & (jnp.abs(dt) <= float(n) / 2.0)
    )
    t_bin = jnp.clip(t_bin, 0, num_frames - 1)
    f_bin = jnp.clip(f_bin, 0, k_count - 1)
    return t_bin, f_bin, jnp.where(valid, power, 0.0)


def scatter_segment_sum(
    t_bin: jnp.ndarray, f_bin: jnp.ndarray, power: jnp.ndarray,
    num_frames: int, k_count: int,
) -> jnp.ndarray:
    """Scatter-add via flattened-id segment_sum (correctness baseline).

    Leading dims (e.g. channels) are vmapped; the last two dims (t, k) are
    flattened into segment ids.
    """
    def one(tb, fb, p):
        ids = (tb * k_count + fb).reshape(-1)
        out = jax.ops.segment_sum(
            p.reshape(-1), ids,
            num_segments=num_frames * k_count,
            indices_are_sorted=False, unique_indices=False,
        )
        return out.reshape(num_frames, k_count)

    lead = t_bin.shape[:-2]
    if lead:
        flat = (-1,) + t_bin.shape[-2:]
        out = jax.vmap(one)(t_bin.reshape(flat), f_bin.reshape(flat), power.reshape(flat))
        return out.reshape(lead + (num_frames, k_count))
    return one(t_bin, f_bin, power)


def reassigned_spectrogram(
    x: jnp.ndarray, n: int, hop: int,
    power_floor: float = DEFAULT_POWER_FLOOR,
) -> jnp.ndarray:
    """(..., samples) → reassigned power spectrogram (..., frames, n//2+1).

    End-to-end Enhanced-mode analysis [NS configs[1]]: auxiliary-window
    STFTs → phase-derivative corrections → quantize → scatter-add.
    """
    X_h, X_th, X_dh = stft_triple(x, n, hop)
    t = X_h.shape[-2]
    power, dt, dw = reassignment_corrections(X_h, X_th, X_dh)
    t_bin, f_bin, p = reassigned_bins(power, dt, dw, n, hop, t, power_floor)
    return scatter_segment_sum(t_bin, f_bin, p, t, n // 2 + 1)
