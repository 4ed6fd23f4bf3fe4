"""Offline: audio in → display-ready RGBA raster out (the product
boundary, SURVEY.md §1).  Settings is the public API — every reference
panel control is a field."""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import numpy as np

from emspec import Settings, render
from emspec.io import synth
from emspec.render.png import write_png

x = synth.chirp(100.0, 8000.0, 2.0) + synth.multitone([440.0, 880.0], 2.0,
                                                      amplitude=0.3)
img = render(x, Settings(mode="enhanced", multires=True, gain=5.0,
                         colormap="inferno"))
print("raster:", img.shape, img.dtype)       # (rows, t, 4) uint8
out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else None
if out:
    write_png(out, img)
    print("wrote", out)
