"""Non-finite input robustness (round-5 fix; VERDICT r4 Weak #1).

A single NaN/Inf capture sample must never poison persistent state.
Pre-fix, natural mode fed one NaN sample produced all-NaN columns for
process lifetime: NaN |X|² → NaN ``peak_db`` → NaN AGC reference EMA
(``emspec/post/chain.py`` stage 4), and the EMA never recovers.  The
fix scrubs non-finite power at the single site both natural paths
share (``Pipeline._bank_power``, mirrored in ``tests/oracle.py`` per
the invariants contract).  Enhanced mode was already immune via the
deposit validity mask (``pipeline.py _deposits_banked``); tests here pin that immunity explicitly so a
refactor can't lose the mask.

Real capture drivers and corrupt WAV floats can deliver non-finite
samples, and the reference app runs indefinitely on live system audio
[OBS: README.md:36] — the state must be provably unpoisonable.
"""

import numpy as np
import pytest

from emspec.config import Settings
from emspec.pipeline import Pipeline
from emspec.io import synth
from emspec.stream import stream_signal

SR = 48_000
HOPS = 120
BAD_HOP = 40


def _settings(mode, multires, **kw):
    base = dict(mode=mode, multires=multires, raster_height=128, hop=256,
                sample_rate=SR, smoothing=0.5, auto_gain=True)
    if multires:
        base["multires_sizes"] = (2048, 1024, 512)
        base["fft_size"] = 4096
    else:
        base["fft_size"] = 2048
    base.update(kw)
    return Settings(**base)


def _poisoned_signal(pipe, bad_value, hops=HOPS, bad_hop=BAD_HOP):
    """Noise + tone long enough for `hops` columns, with ONE bad sample
    inside the fresh-audio region of column `bad_hop`."""
    n = pipe.n_max + (hops - 1) * pipe.hop
    x = (synth.noise(n / SR + 0.01, SR, seed=3)[:n] * 0.1
         + synth.multitone([440.0, 2200.0], n / SR + 0.01, SR)[:n] * 0.3)
    x = np.asarray(x, np.float32)
    x[pipe.n_max + bad_hop * pipe.hop + 5] = bad_value
    return x


@pytest.mark.parametrize("mode", ["natural", "enhanced"])
@pytest.mark.parametrize("multires", [False, True])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_one_bad_sample_never_poisons_state(mode, multires, bad):
    """The VERDICT repro: one non-finite sample at hop 40 of 120 — every
    output column must stay finite and the display must recover (the
    last column, 80 hops later, shows signal again)."""
    s = _settings(mode, multires)
    pipe = Pipeline(s)
    x = _poisoned_signal(pipe, bad)
    vis, rgba, state = pipe.process(x)
    v = np.asarray(vis)
    assert np.isfinite(v).all(), f"non-finite vis ({mode}, multires={multires})"
    assert 0.0 <= v.min() and v.max() <= 1.0
    assert np.isfinite(np.asarray(state.agc_ref)).all(), "AGC EMA poisoned"
    assert np.isfinite(np.asarray(state.smooth)).all()
    # recovery: the final column is not stuck black — the tone is visible
    assert v[-1].max() > 0.05, "display never recovered after the bad sample"


@pytest.mark.parametrize("mode", ["natural", "enhanced"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.slow
def test_streaming_equals_batch_with_poisoned_input(mode, bad):
    """The scrub is INSIDE the shared per-bank power / deposit path, so
    streaming ≡ batch must survive poisoned input unchanged."""
    s = _settings(mode, True)
    pipe = Pipeline(s)
    x = _poisoned_signal(pipe, bad, hops=60, bad_hop=20)
    vis_b, rgba_b, _ = pipe.process(x)
    vis_s, rgba_s = stream_signal(x, s, chunk=777)
    np.testing.assert_allclose(vis_s, np.asarray(vis_b), atol=1e-6)
    np.testing.assert_array_equal(rgba_s, np.asarray(rgba_b))


@pytest.mark.parametrize("mode", ["natural", "enhanced"])
def test_recovery_is_exact_once_decayed(mode):
    """With AGC off the only cross-column state is the smoothing EMA,
    whose perturbation decays as αᵗ — 68 hops after the bad sample
    leaves the window, the poisoned run's tail is bit-identical in f32
    to the clean run's.  (With AGC on the reference EMA decays at
    0.99/hop and recovery is asymptotic — covered by the finite +
    visible assertions above.)"""
    s = _settings(mode, False, auto_gain=False)
    pipe = Pipeline(s)
    x_clean = _poisoned_signal(pipe, 0.0)   # same signal, bad sample benign
    x_bad = x_clean.copy()
    x_bad[pipe.n_max + BAD_HOP * pipe.hop + 5] = np.nan
    vis_c, rgba_c, _ = pipe.process(x_clean)
    vis_p, rgba_p, _ = pipe.process(x_bad)
    vis_c, vis_p = np.asarray(vis_c), np.asarray(vis_p)
    assert np.isfinite(vis_p).all()
    # the two runs genuinely diverge while the bad sample is in-window…
    assert not np.array_equal(vis_c, vis_p)
    # …and the tail display is pixel-identical again (α=0.5 ⇒ the EMA
    # perturbation is 2⁻⁶⁸ of a column 68 hops later; black cells keep
    # ~1e-21 denormal residues decaying in both runs, so pin the
    # quantized RGBA bit-exactly and vis to well under 1/255)
    np.testing.assert_array_equal(np.asarray(rgba_c)[-10:],
                                  np.asarray(rgba_p)[-10:])
    np.testing.assert_allclose(vis_c[-10:], vis_p[-10:], atol=1e-9)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_enhanced_deposit_mask_zeroes_nonfinite(bad):
    """Pin enhanced-mode immunity at its mechanism: a frame containing a
    non-finite sample must contribute ZERO to the scatter (the deposit
    validity mask, pipeline.py _deposits_banked) — not merely avoid
    NaN output.  A refactor that drops the mask fails here directly."""
    s = _settings("enhanced", False)
    pipe = Pipeline(s)
    p = pipe.params(s)
    n = pipe.sizes[0]
    rng = np.random.default_rng(7)
    frame = rng.standard_normal((1, n)).astype(np.float32) * 0.1
    frame[0, n // 3] = bad
    import jax.numpy as jnp
    _, _, contrib = pipe._deposits([jnp.asarray(frame)], p)
    c = np.asarray(contrib)
    assert np.isfinite(c).all()
    np.testing.assert_array_equal(c, 0.0)
