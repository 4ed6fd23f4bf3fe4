"""Colormap LUTs: display value in [0,1] → RGBA (L3→L4 boundary).

Reference evidence: README.md:15 ("Multiple color schemes"), README.md:45,
and the "Inferno" dropdown with gradient swatch in assets/settings.png;
assets/spectrogram.png is rendered in Inferno.  Ships the matplotlib-family
maps matching the swatch (inferno/magma/viridis/plasma/turbo) + grayscale.

The LUT is *data*, not structure: swapping colormaps never recompiles the
pipeline — the (256, 4) uint8 table is just another device argument
(SURVEY.md §3.3).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from emspec.post._cmap_data import rgb_table

LUT_SIZE = 256


@functools.lru_cache(maxsize=None)
def lut(name: str) -> np.ndarray:
    """(256, 4) uint8 RGBA lookup table for the named colormap."""
    if name == "grayscale":
        g = np.arange(LUT_SIZE, dtype=np.uint8)
        rgb = np.stack([g, g, g], axis=1)
    else:
        rgb = rgb_table(name)
    alpha = np.full((LUT_SIZE, 1), 255, dtype=np.uint8)
    out = np.concatenate([rgb, alpha], axis=1)
    out.setflags(write=False)
    return out


def apply_lut(values: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """values in [0,1] (...,) + (256,4) uint8 table → (..., 4) uint8 RGBA
    [NS: "colormap LUT"].

    Nearest lookup as a plain gather from the 1 KB table, which XLA
    fuses with the preceding post chain."""
    idx = jnp.clip(
        jnp.round(values * (LUT_SIZE - 1)).astype(jnp.int32), 0, LUT_SIZE - 1
    )
    return table[idx]
