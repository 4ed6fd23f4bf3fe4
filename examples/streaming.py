"""Real-time path: push chunks, get finalized display columns back.
Streaming output is bit-identical to the batch render of the same
signal (the framework's core invariant)."""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import numpy as np

from emspec import Settings, Stream
from emspec.io import synth

s = Settings(mode="enhanced", multires=False, fft_size=2048)
stream = Stream(s)
x = synth.tone(440.0, 1.0)
cols = []
for i in range(0, len(x), 1024):             # arbitrary chunking
    cols += stream.push(x[i:i + 1024])
cols += stream.flush()                        # drain the pending ring
print(f"{len(cols)} columns; first rgba {cols[0].rgba.shape}, "
      f"vis range [{float(np.asarray(cols[0].vis).min()):.3f}, "
      f"{float(np.asarray(cols[0].vis).max()):.3f}]")
