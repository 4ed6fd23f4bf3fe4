"""Multi-resolution merge tests (config 2: 8192/2048/512 → one
log-frequency raster) + log-axis/hover invertibility (SURVEY.md §4.5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from emspec.config import Settings
from emspec.dsp.multires import (
    band_weights, bank_offsets, build_merge_tables, log_freq_axis,
)
from emspec.pipeline import Pipeline
from emspec.io import synth
from emspec.utils.notes import describe_frequency, frequency_to_note, note_to_frequency

import oracle

SR = 48_000
SIZES = (8192, 2048, 512)


def _mini_settings(**kw):
    kw.setdefault("multires", True)
    kw.setdefault("raster_height", 128)
    kw.setdefault("auto_gain", False)
    return Settings(**kw)


# ------------------------------------------------------------- axis/tables
def test_log_axis_matches_oracle_and_inverts():
    rows = 256
    f = log_freq_axis(rows, 20.0, SR / 2, 1.0)
    np.testing.assert_allclose(f, oracle.log_freq_axis(rows, 20.0, SR / 2, 1.0))
    assert f[0] == pytest.approx(20.0)
    assert f[-1] == pytest.approx(SR / 2)
    # invertibility: row → freq → row round-trips (hover readout contract)
    a = np.log2(f[0])
    b = (rows - 1) / (np.log2(f[-1]) - np.log2(f[0]))
    rows_back = (np.log2(f) - a) * b
    np.testing.assert_allclose(rows_back, np.arange(rows), atol=1e-9)


def test_freq_scale_zooms_toward_low_end():
    f1 = log_freq_axis(128, 20.0, SR / 2, 1.0)
    f2 = log_freq_axis(128, 20.0, SR / 2, 2.0)
    assert f2[-1] == pytest.approx(np.sqrt(20.0 * SR / 2), rel=1e-6)
    assert f2[0] == f1[0]


def test_band_weights_partition_of_unity():
    rows = 300
    f = log_freq_axis(rows, 20.0, SR / 2)
    w = band_weights(f, SIZES, 200.0, 2000.0)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-12)
    np.testing.assert_allclose(w, oracle.band_weights(f, SIZES, 200.0, 2000.0))
    # deep bass is pure 8192-bank, treble pure 512-bank
    assert w[0][f < 100].min() == 1.0
    assert w[2][f > 4000].min() == 1.0
    assert w[1][(f > 450) & (f < 900)].min() > 0.99


def test_bank_offsets_center_align():
    assert bank_offsets(SIZES) == ((8192 - 8192) // 2, (8192 - 2048) // 2, (8192 - 512) // 2)


def test_merge_tables_shapes():
    t = build_merge_tables(SIZES, SR, 128, 20.0, 1.0, 200.0, 2000.0)
    assert len(t.i0) == len(t.w0) == len(t.band_w) == 3
    for n, i0, w0 in zip(SIZES, t.i0, t.w0):
        assert i0.shape == w0.shape == (128,)
        assert i0.max() <= n // 2 - 1
        assert 0.0 <= w0.min() and w0.max() <= 1.0


# --------------------------------------------------------------- pipelines
def test_natural_multires_parity():
    s = _mini_settings(mode="natural", multires_sizes=(2048, 1024, 512), hop=256)
    x = synth.multitone([100.0, 700.0, 6000.0], 0.2) + synth.noise(0.2, seed=4, amplitude=0.01)
    pipe = Pipeline(s)
    t_count = pipe.num_columns(len(x))
    power = np.asarray(pipe._natural_power(jnp.asarray(x), t_count, pipe.params()))
    want = oracle.multires_natural(
        x, s.multires_sizes, s.hop_samples, s.raster_height, SR,
        s.freq_min, s.freq_scale, s.crossover_low, s.crossover_high)
    assert power.shape == want.shape
    scale = want.max()
    np.testing.assert_allclose(power / scale, want / scale, atol=3e-5)


@pytest.mark.slow
def test_enhanced_multires_parity():
    s = _mini_settings(mode="enhanced", multires_sizes=(2048, 1024, 512), hop=256)
    x = synth.multitone([150.0, 900.0], 0.15)
    pipe = Pipeline(s)
    t_count = pipe.num_columns(len(x))
    power = np.asarray(pipe._enhanced_power(jnp.asarray(x), t_count, pipe.params()))
    want = oracle.multires_enhanced(
        x, s.multires_sizes, s.hop_samples, s.raster_height, SR,
        s.freq_min, s.freq_scale, s.crossover_low, s.crossover_high)
    assert power.shape == want.shape
    scale = want.max()
    assert power.sum() == pytest.approx(want.sum(), rel=2e-3)
    # quantized scatter: allow neighbor-cell swaps from float32 rounding
    from scipy.ndimage import maximum_filter
    np.testing.assert_allclose(
        maximum_filter(power, 3) / scale, maximum_filter(want, 3) / scale,
        atol=2e-2)


def test_tone_equal_brightness_across_banks():
    """A stationary tone must display ~equally bright whichever bank
    renders it (per-unit 1/N² normalization)."""
    s = _mini_settings(mode="natural", hop=2048, raster_height=256)
    pipe = Pipeline(s)
    peaks = []
    # probe at exact row-center frequencies deep inside each band so the
    # log-row sampling doesn't fall off the tone's mainlobe (row spacing
    # at 8 kHz exceeds the 512-pt bank's bin width); what's under test is
    # the 1/N² bank normalization, with only Hann bin-scalloping (≤1.4 dB
    # per bank) left as noise.
    for target in (60.0, 700.0, 8000.0):
        f = float(pipe.row_freqs[np.abs(pipe.row_freqs - target).argmin()])
        x = synth.tone(f, 0.5, SR)
        t_count = pipe.num_columns(len(x))
        power = np.asarray(pipe._natural_power(jnp.asarray(x), t_count, pipe.params()))
        peaks.append(power[t_count // 2].max())
    peaks = np.asarray(peaks)
    assert peaks.max() / peaks.min() < 2.0   # within 3 dB across banks


@pytest.mark.slow
def test_enhanced_tone_row_is_sharp_and_correct():
    s = _mini_settings(mode="enhanced", raster_height=512, hop=512)
    f_true = 440.0
    x = synth.tone(f_true, 0.6, SR)
    pipe = Pipeline(s)
    t_count = pipe.num_columns(len(x))
    power = np.asarray(pipe._enhanced_power(jnp.asarray(x), t_count, pipe.params()))
    col = power[t_count // 2]
    row_peak = col.argmax()
    f_peak = pipe.row_freqs[row_peak]
    # within half a row of the true frequency
    assert abs(np.log2(f_peak / f_true)) < np.log2(pipe.row_freqs[1] / pipe.row_freqs[0])
    # sharp: ≥90% of column energy within ±2 rows of the peak
    m = col[max(0, row_peak - 2): row_peak + 3].sum()
    assert m > 0.9 * col.sum()


def test_full_process_shapes_and_dtype():
    s = _mini_settings(mode="enhanced", multires_sizes=(2048, 1024, 512), hop=256)
    x = synth.chirp(100.0, 10_000.0, 0.3, SR)
    pipe = Pipeline(s)
    vis, rgba, state = pipe.process(x)
    t = pipe.num_columns(len(x))
    assert vis.shape == (t, s.raster_height)
    assert rgba.shape == (t, s.raster_height, 4)
    assert np.asarray(rgba).dtype == np.uint8
    assert 0.0 <= float(jnp.min(vis)) and float(jnp.max(vis)) <= 1.0


# -------------------------------------------------------------- note names
def test_note_naming():
    assert frequency_to_note(440.0) == ("A", 4, pytest.approx(0.0, abs=1e-9))
    name, octv, cents = frequency_to_note(261.6256)
    assert (name, octv) == ("C", 4)
    assert abs(cents) < 0.01
    assert note_to_frequency("A", 4) == pytest.approx(440.0)
    # cents sign: slightly sharp of A4
    _, _, c = frequency_to_note(442.0)
    assert c > 0
    assert "A4" in describe_frequency(440.0)
