"""Four-step matmul FFT tests: accuracy vs float64, pipeline parity
vs the XLA-FFT path, and the documented tolerance-level streaming≡batch
contract for fft_impl="fourstep" (bit-exactness is guaranteed only for
"xla"; see Settings.fft_impl)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emspec.config import Settings
from emspec.dsp.fourstep import (
    _FACTORS, packed_pair_fft, rfft_fourstep, supported,
)
from emspec.pipeline import Pipeline
from emspec.io import synth
from emspec.stream import stream_signal

SR = 48_000


@pytest.mark.parametrize("n", sorted(_FACTORS))
def test_rfft_accuracy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.fft.rfft(x.astype(np.float64))
    got = np.asarray(jax.jit(rfft_fourstep)(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-6


def test_packed_pair_matches_separate():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 4096)).astype(np.float32)
    b = rng.standard_normal((2, 4096)).astype(np.float32)
    A, B = jax.jit(packed_pair_fft)(jnp.asarray(a), jnp.asarray(b))
    wa = np.fft.rfft(a.astype(np.float64))
    wb = np.fft.rfft(b.astype(np.float64))
    assert np.abs(np.asarray(A) - wa).max() / np.abs(wa).max() < 2e-6
    assert np.abs(np.asarray(B) - wb).max() / np.abs(wb).max() < 2e-6


def test_supported_covers_dropdown():
    from emspec.config import FFT_SIZES
    assert all(supported(n) for n in FFT_SIZES)


def _base(**kw):
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (2048, 1024, 512))
    kw.setdefault("raster_height", 128)
    kw.setdefault("hop", 256)
    kw.setdefault("auto_gain", False)
    return Settings(**kw)


@pytest.mark.parametrize("mode", ["natural", "enhanced"])
@pytest.mark.slow
def test_pipeline_fourstep_matches_xla(mode):
    x = synth.chirp(100.0, 8000.0, 0.15) + synth.tone(440.0, 0.15, amplitude=0.3)
    want, _, _ = Pipeline(_base(mode=mode, fft_impl="xla")).process(x)
    got, _, _ = Pipeline(_base(mode=mode, fft_impl="fourstep")).process(x)
    # display values in [0,1]; FFT rounding can flip a quantized scatter
    # cell near a .5 boundary — compare through a 1-cell blur
    from scipy.ndimage import maximum_filter
    w = maximum_filter(np.asarray(want), 3)
    g = maximum_filter(np.asarray(got), 3)
    np.testing.assert_allclose(g, w, atol=5e-3)


@pytest.mark.slow
def test_fourstep_streaming_equals_batch_within_tolerance():
    s = _base(mode="enhanced", fft_impl="fourstep", smoothing=0.4)
    x = synth.chirp(200.0, 4000.0, 0.2, SR)
    pipe = Pipeline(s)
    vis_b, _, _ = pipe.process(x)
    vis_s, _ = stream_signal(x, s, chunk=600)
    # documented contract: fourstep agrees to float32 rounding, not bitwise
    np.testing.assert_allclose(vis_s, np.asarray(vis_b), atol=2e-4)


def test_fourstep_rejects_unsupported_size():
    s = Settings(multires=False, fft_size=512, fft_impl="fourstep",
                 multires_sizes=(512,))
    Pipeline(s.replace(hop=128)).fft_impl  # 512 is supported — fine
    # non-power-of-two bank sizes are rejected at Settings construction
    # (round-2 validation — they'd reach kernels whose tile policies
    # assume powers of two); fourstep's own support check is second line
    with pytest.raises((ValueError, KeyError)):
        _ = Pipeline(_base(multires_sizes=(768,),
                           fft_impl="fourstep")).fft_impl

@pytest.mark.slow
def test_fourstep_streaming_equals_batch_natural():
    """Regression: the natural-mode stream step once ignored fft_impl and
    silently diverged from the batch path under fourstep."""
    s = _base(mode="natural", fft_impl="fourstep", smoothing=0.3)
    x = synth.multitone([300.0, 3000.0], 0.15)
    pipe = Pipeline(s)
    vis_b, _, _ = pipe.process(x)
    vis_s, _ = stream_signal(x, s, chunk=640)
    np.testing.assert_allclose(vis_s, np.asarray(vis_b), atol=2e-4)
