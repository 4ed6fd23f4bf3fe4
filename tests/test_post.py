"""Post-chain parity vs the float64 oracle + LUT/colormap unit tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emspec.config import Settings
from emspec.post.chain import PostParams, PostState, postprocess_column
from emspec.post.colormap import LUT_SIZE, apply_lut, lut

import oracle


def _run_chain(power_tk, freqs, s: Settings):
    """Scan the per-column chain over time (the batch path)."""
    p = PostParams.from_settings(s, freqs)
    state = PostState.init((power_tk.shape[1],))

    def step(st, col):
        out, st = postprocess_column(col, st, p)
        return st, out

    _, out = jax.lax.scan(step, state, jnp.asarray(power_tk, jnp.float32))
    return np.asarray(out)


@pytest.mark.parametrize("agc,smooth,gate", [
    (False, 0.0, -65.0),
    (True, 0.0, -65.0),
    (True, 0.7, -40.0),
    (False, 0.9, -120.0),
])
def test_chain_parity(agc, smooth, gate):
    rng = np.random.default_rng(0)
    t, rows = 40, 128
    freqs = np.geomspace(20.0, 24000.0, rows)
    power = rng.uniform(0, 1e-2, (t, rows)) ** 2
    power[:, 30] = 0.1  # a strong line
    s = Settings(auto_gain=agc, smoothing=smooth, noise_gate_db=gate)
    got = _run_chain(power, freqs, s)
    want = oracle.postprocess(
        power, freqs,
        gain=s.gain, db_range=s.db_range, noise_gate_db=s.noise_gate_db,
        agc_strength=s.agc_strength, agc_enabled=agc,
        smoothing=s.smoothing, brightness=s.brightness,
        low_end_boost=s.low_end_boost, low_end_cutoff=s.low_end_cutoff,
    )
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_silence_plus_gate_is_black():
    """SURVEY.md §4.3: silence + gate ⇒ all-zero raster."""
    t, rows = 8, 64
    freqs = np.geomspace(20.0, 24000.0, rows)
    got = _run_chain(np.zeros((t, rows)), freqs, Settings(auto_gain=False))
    assert got.max() == 0.0


def test_gate_kills_weak_keeps_strong():
    rows = 64
    freqs = np.geomspace(20.0, 24000.0, rows)
    power = np.full((1, rows), 1e-11)      # ≈ -110 dB, below -65 gate
    power[0, 10] = 1.0                     # 0 dB line
    s = Settings(auto_gain=False, smoothing=0.0, low_end_boost=1.0, gain=1.0)
    out = _run_chain(power, freqs, s)
    assert out[0, 10] > 0.8
    assert out[0, 40] == 0.0


def test_agc_pulls_quiet_signal_up():
    rows = 64
    freqs = np.geomspace(20.0, 24000.0, rows)
    power = np.full((200, rows), 1e-9)
    power[:, 20] = 1e-4                    # -40 dB peak
    s_off = Settings(auto_gain=False, low_end_boost=1.0, gain=1.0, noise_gate_db=-200.0)
    s_on = s_off.replace(auto_gain=True, agc_strength=1.0)
    off = _run_chain(power, freqs, s_off)[-1, 20]
    on = _run_chain(power, freqs, s_on)[-1, 20]
    assert on > off  # AGC brightens the quiet signal over time


def test_smoothing_is_ema():
    rows = 4
    freqs = np.geomspace(100.0, 10000.0, rows)
    power = np.zeros((3, rows))
    power[0] = 1.0   # bright first column, then silence
    s = Settings(auto_gain=False, smoothing=0.5, gain=1.0,
                 low_end_boost=1.0, noise_gate_db=-300.0, brightness=0.5)
    out = _run_chain(power, freqs, s)
    assert out[1, 0] == pytest.approx(out[0, 0] * 0.5, rel=1e-3)
    assert out[2, 0] == pytest.approx(out[0, 0] * 0.25, rel=1e-3)


# ------------------------------------------------------------- colormaps
def test_lut_shapes_and_endpoints():
    for name in ("inferno", "magma", "viridis", "plasma", "turbo", "grayscale"):
        t = lut(name)
        assert t.shape == (LUT_SIZE, 4)
        assert t.dtype == np.uint8
        assert (t[:, 3] == 255).all()
    g = lut("grayscale")
    assert tuple(g[0, :3]) == (0, 0, 0)
    assert tuple(g[-1, :3]) == (255, 255, 255)
    inf = lut("inferno")
    assert inf[0, :3].sum() < 20        # inferno starts near black
    assert inf[-1, 0] > 200             # and ends bright yellow-ish


def test_apply_lut():
    table = jnp.asarray(lut("grayscale"))
    vals = jnp.asarray([0.0, 0.5, 1.0, 1.5, -0.2])
    rgba = np.asarray(apply_lut(vals, table))
    assert rgba.shape == (5, 4)
    assert rgba[0, 0] == 0
    assert rgba[1, 0] == round(0.5 * 255)
    assert rgba[2, 0] == 255
    assert rgba[3, 0] == 255   # clipped high
    assert rgba[4, 0] == 0     # clipped low


@pytest.mark.slow
def test_associative_post_matches_sequential_within_tolerance():
    """The associative EMA scans (postprocess_batch associative=True,
    the GPU's choice at display-scale t) must agree with the sequential
    bit-exact path to reassociation rounding: ~log2(t)*eps relative, an
    order under the display's 1/255 quantum.  (On CPU the default stays
    sequential; this forces the associative branch for coverage.)"""
    from emspec.post.chain import postprocess_batch

    rng = np.random.default_rng(7)
    t, rows = 700, 96
    power = jnp.asarray(rng.random((t, rows)).astype(np.float32) * 1e-2)
    s = Settings(mode="enhanced", smoothing=0.7, auto_gain=True)
    p = PostParams.from_settings(s, np.linspace(30, 20000, rows))
    st = PostState.init((rows,))
    vis_seq, st_seq = postprocess_batch(power, st, p, associative=False)
    vis_asc, st_asc = postprocess_batch(power, st, p, associative=True)
    np.testing.assert_allclose(np.asarray(vis_asc), np.asarray(vis_seq),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_asc.smooth),
                               np.asarray(st_seq.smooth), atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_asc.agc_ref),
                               np.asarray(st_seq.agc_ref), atol=2e-4)


def test_batch_default_is_sequential_on_cpu():
    """The CPU default must stay on the bit-exact sequential path."""
    from emspec.post.chain import postprocess_batch

    rng = np.random.default_rng(8)
    power = jnp.asarray(rng.random((64, 48)).astype(np.float32) * 1e-3)
    s = Settings(mode="enhanced", smoothing=0.4)
    p = PostParams.from_settings(s, np.linspace(30, 20000, 48))
    st = PostState.init((48,))
    vis_default, _ = postprocess_batch(power, st, p)
    vis_seq, _ = postprocess_batch(power, st, p, associative=False)
    assert np.array_equal(np.asarray(vis_default), np.asarray(vis_seq))


def test_empty_time_axis_associative_path():
    """t = 0 (audio shorter than one frame) through the ASSOCIATIVE branch
    must behave like the length-0 lax.scan: empty vis, carry unchanged
    (ys[-1] once raised IndexError)."""
    from emspec.post.chain import postprocess_batch

    rows = 32
    power = jnp.zeros((0, rows), jnp.float32)
    s = Settings(mode="enhanced", smoothing=0.5, auto_gain=True)
    p = PostParams.from_settings(s, np.linspace(30, 20000, rows))
    st = PostState.init((rows,))
    for assoc in (True, False, None):
        vis, st_out = postprocess_batch(power, st, p, associative=assoc)
        assert vis.shape == (0, rows)
        np.testing.assert_array_equal(np.asarray(st_out.smooth),
                                      np.asarray(st.smooth))
        np.testing.assert_array_equal(np.asarray(st_out.agc_ref),
                                      np.asarray(st.agc_ref))


def test_apply_lut_display_raster_equals_numpy_gather():
    """A whole display raster (1437 columns × 512 rows, the multires 4 s
    shape) through apply_lut equals the plain numpy table gather."""
    rng = np.random.default_rng(11)
    vis = rng.random((1437, 512)).astype(np.float32)
    vis[0, :4] = [0.0, 1.0, -0.5, 2.0]               # clip both ends
    table = lut("inferno")
    got = np.asarray(apply_lut(jnp.asarray(vis), jnp.asarray(table)))
    idx = np.clip(np.round(vis * (LUT_SIZE - 1)), 0, LUT_SIZE - 1)
    np.testing.assert_array_equal(got, table[idx.astype(np.int64)])
