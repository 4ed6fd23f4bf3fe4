"""Offline raster assembly (L4): spectrogram values → display RGBA image.

The waterfall orientation matches the reference display
(assets/spectrogram.png: time runs horizontally, frequency vertically
with bass at the bottom, Inferno colormap).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from emspec.config import MODE_ENHANCED, Settings
from emspec.dsp.reassign import reassigned_spectrogram
from emspec.dsp.stft import power_spectrogram
from emspec.post.chain import PostParams, PostState, postprocess_batch
from emspec.post.colormap import apply_lut, lut


def analyze(x: jnp.ndarray, s: Settings) -> jnp.ndarray:
    """(samples,) → linear power spectrogram (frames, bins) per mode.

    Enhanced = reassignment remap [NS configs[1]]; Natural = plain |X_h|^2
    [NS configs[0]] (reference: settings.png Enhanced/Natural buttons).
    """
    n, hop = s.fft_size, s.hop if s.hop > 0 else s.fft_size // 4
    if s.mode == MODE_ENHANCED:
        return reassigned_spectrogram(x, n, hop)
    return power_spectrogram(x, n, hop)


def postprocess(power_tk: jnp.ndarray, freqs_hz: np.ndarray, s: Settings) -> jnp.ndarray:
    """Batch post chain (bit-identical state evolution to the streaming
    driver — SURVEY.md §4.4; see emspec.post.chain.postprocess_batch)."""
    p = PostParams.from_settings(s, freqs_hz)
    state = PostState.init(power_tk.shape[:-2] + (power_tk.shape[-1],))
    cols_first = (jnp.swapaxes(power_tk, 0, -2)
                  if power_tk.ndim > 2 else power_tk)
    vis, _ = postprocess_batch(cols_first, state, p, s.agc_global)
    return vis


@functools.lru_cache(maxsize=8)
def _render_graph(s: Settings):
    """Jitted analysis→post→LUT graph for one Settings bundle.  Cached on
    the (hashable, frozen) Settings so repeated renders — a directory of
    files, parameter sweeps — reuse the compiled executable; jax.jit then
    keys on the input length."""
    n = s.fft_size
    freqs = np.arange(n // 2 + 1) * (s.sample_rate / n)

    def graph(xj):
        power = analyze(xj, s)
        vis = postprocess(power, freqs, s)
        return vis, apply_lut(vis, jnp.asarray(lut(s.colormap)))

    return jax.jit(graph)


def render_image(x, s: Settings) -> np.ndarray:
    """(samples,) float32 audio → (bins, frames, 4) uint8 RGBA image.

    Single-bank offline path (linear frequency axis); the multi-res
    log-frequency display path lives in ``emspec.pipeline``.

    The whole analysis→post→LUT graph runs under ONE jit: eagerly, every
    op would be a separate dispatch and XLA would fuse nothing.
    """
    _, rgba = _render_graph(s)(jnp.asarray(x, jnp.float32))
    img = np.asarray(rgba)                  # (frames, bins, 4)
    return img.transpose(1, 0, 2)[::-1]     # freq vertical, bass at bottom


def render_vis(x, s: Settings) -> np.ndarray:
    """(samples,) audio → (bins, frames) float32 pre-LUT display values
    in [0, 1], bins ascending in frequency — the same quantity the PNG
    shows before the colormap, through the identical compiled graph
    (``emspec export``'s linear-axis payload).

    Deliberately shares ``_render_graph`` (paying one discarded LUT pass
    per offline export) instead of compiling a vis-only program: a
    separately-fused XLA graph could differ from the render's vis at
    f32 ulp level, breaking the pixel-exact apply_lut(vis) == PNG
    contract tests pin."""
    vis, _ = _render_graph(s)(jnp.asarray(x, jnp.float32))
    return np.asarray(vis).T                # (bins, frames)
