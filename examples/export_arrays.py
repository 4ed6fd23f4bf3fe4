"""Arrays instead of pixels: `emspec export` writes the pre-LUT display
values with their physical axes, so downstream tooling (feature
extraction, pitch tracking, regression tests against other analyzers)
gets numbers carrying the full display contract — dB window, gate, AGC,
smoothing — identical to what the PNG shows (apply_lut(vis) reproduces
the render pixel-exactly; tests/test_cli.py pins it).

Here: export a chirp, then read the npz back and track the peak-energy
frequency over time — a 5-line "pitch tracker" over the display data.
"""
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import numpy as np

from emspec.__main__ import main
from emspec.io import synth
from emspec.io.wav import write_wav

tmp = pathlib.Path(tempfile.mkdtemp(prefix="emspec_export_"))
wav, npz = tmp / "chirp.wav", tmp / "chirp.npz"
write_wav(wav, synth.chirp(200.0, 8000.0, 2.0), 48_000)

# the CLI surface; library-side see emspec.render.raster.render_vis /
# emspec.pipeline.Pipeline.process
assert main(["export", str(wav), str(npz), "--multires"]) == 0

z = np.load(npz, allow_pickle=False)
vis, freq_hz, time_s = z["vis"], z["freq_hz"], z["time_s"]
settings = json.loads(str(z["settings_json"]))
print(f"vis {vis.shape} (rows x columns), "
      f"{freq_hz[0]:.0f}-{freq_hz[-1]:.0f} Hz, {time_s[-1]:.2f} s, "
      f"mode={settings['mode']}")

# peak-energy ridge: for each column, the frequency of the brightest row
ridge = freq_hz[np.argmax(vis, axis=0)]
for frac in (0.1, 0.5, 0.9):
    c = int(frac * (len(time_s) - 1))
    print(f"  t={time_s[c]:5.2f} s  ridge={ridge[c]:7.1f} Hz")

# the chirp rises 200 -> 8000 Hz; the ridge must rise monotonically-ish
mid = len(ridge) // 2
assert ridge[mid:].mean() > ridge[:mid].mean()
print("ridge tracks the chirp: OK")
