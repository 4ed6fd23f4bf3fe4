"""The north-star fidelity contract: magnitude/dB parity within float
tolerance across FFT sizes 512–32768 [NS: "bit-for-bit in magnitude/dB
within float tolerance across FFT sizes 512–32768"], plus the config-4
stress shape (16-channel 96 kHz).

Tolerance is defined as a function of N up front (SURVEY.md §7 hard part
5): float32 rFFT error grows ~sqrt(N)·eps, so the relative-to-peak power
tolerance scales with sqrt(N/512).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from emspec.config import FFT_SIZES, Settings
from emspec.dsp.stft import power_spectrogram
from emspec.dsp.reassign import reassigned_spectrogram
from emspec.io import synth
from emspec.pipeline import Pipeline

import oracle

pytestmark = pytest.mark.slow   # 10-size sweep + virtual-mesh dryruns

SR = 48_000


def _tol(n: int) -> float:
    return 2e-5 * np.sqrt(n / 512.0)


@pytest.mark.parametrize("n", FFT_SIZES)
def test_power_spectrogram_parity_across_sizes(n):
    hop = n // 4
    x = (synth.multitone([440.0, 2000.0, 9000.0], (n + 3 * hop) / SR + 0.01)
         + synth.noise((n + 3 * hop) / SR + 0.01, seed=n, amplitude=0.01))
    want = oracle.power_spectrogram(x, n, hop)
    got = np.asarray(power_spectrogram(jnp.asarray(x), n, hop))
    scale = want.max()
    np.testing.assert_allclose(got / scale, want / scale, atol=_tol(n))
    # and in dB, where the display lives: compare cells within the visible
    # dynamic range (60 dB below peak)
    mask = want / scale > 1e-6
    db_w = 10 * np.log10(want[mask] / scale)
    db_g = 10 * np.log10(np.maximum(got[mask], 1e-30) / scale)
    assert np.max(np.abs(db_w - db_g)) < 0.05   # dB parity


@pytest.mark.parametrize("n", [512, 4096, 32768])
def test_reassigned_energy_parity_across_sizes(n):
    hop = n // 4
    x = synth.multitone([500.0, 5000.0], (n + 2 * hop) / SR + 0.01)
    want = oracle.reassigned_spectrogram(x, n, hop)
    got = np.asarray(reassigned_spectrogram(jnp.asarray(x), n, hop))
    assert got.shape == want.shape
    assert got.sum() == pytest.approx(want.sum(), rel=5e-4)
    from scipy.ndimage import maximum_filter
    scale = want.max()
    np.testing.assert_allclose(maximum_filter(got, 3) / scale,
                               maximum_filter(want, 3) / scale, atol=2e-2)


def test_stress_config_shape_16ch_96k():
    """Config 4 end-to-end at reduced length: 16 channels, 96 kHz,
    32768-pt, full post chain."""
    s = Settings(mode="enhanced", multires=False, fft_size=32768,
                 sample_rate=96_000, channels=16, raster_height=128)
    pipe = Pipeline(s)
    n_samp = pipe.n_max + 2 * pipe.hop
    x = np.stack([synth.tone(200.0 * (c + 1), n_samp / 96_000 + 0.01, 96_000)[:n_samp]
                  for c in range(16)])
    vis, rgba, state = pipe.process(x)
    assert vis.shape == (3, 16, 128)
    assert rgba.shape == (3, 16, 128, 4)
    v = np.asarray(vis)
    assert np.isfinite(v).all() and v.max() > 0
    # each channel's tone lands on its own row
    rows = [v[1, c].argmax() for c in range(16)]
    assert rows == sorted(rows)
    assert len(set(rows)) > 10


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_smoke(n):
    """The driver's multi-chip dry run must pass on the virtual CPU mesh
    at BOTH n=2 and n=8 (SURVEY.md §2.5 channel-sharding seam +
    global-AGC collective; round-3 VERDICT #3c).  Since round 4 the
    dryrun is self-verifying: it numerically compares the sharded batch
    + streaming outputs against a single-device run and asserts
    per-device shard shapes scale as ch/n."""
    import jax
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as g
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    g.dryrun_multichip(n)
