"""STFT framing + spectrogram parity vs the float64 oracle (config 0:
"Mono 48 kHz WAV → 2048-pt Hann STFT magnitude spectrogram")."""

import numpy as np
import jax.numpy as jnp
import pytest

from emspec.dsp.frame import frame_signal, frame_signal_np, num_frames
from emspec.dsp.stft import power_spectrogram, stft_triple
from emspec.io import synth

import oracle


def test_num_frames():
    assert num_frames(2048, 2048, 512) == 1
    assert num_frames(2047, 2048, 512) == 0
    assert num_frames(2048 + 512, 2048, 512) == 2
    assert num_frames(48000, 2048, 512) == (48000 - 2048) // 512 + 1


def test_framing_matches_oracle_and_host():
    x = synth.noise(0.2, seed=3)
    n, hop = 512, 128
    want = oracle.frames_of(x, n, hop)
    got_dev = np.asarray(frame_signal(jnp.asarray(x), n, hop))
    got_host = frame_signal_np(x, n, hop)
    np.testing.assert_allclose(got_dev, want, atol=0)
    np.testing.assert_allclose(got_host, want, atol=0)


@pytest.mark.parametrize("n,hop", [(512, 128), (2048, 512)])
def test_power_spectrogram_parity(n, hop):
    x = synth.multitone([440.0, 1000.0, 5000.0], 0.3) + synth.noise(0.3, seed=1)
    want = oracle.power_spectrogram(x, n, hop)
    got = np.asarray(power_spectrogram(jnp.asarray(x), n, hop))
    assert got.shape == want.shape == (oracle.frames_of(x, n, hop).shape[0], n // 2 + 1)
    # float32 FFT accumulates ~sqrt(N) ulps; compare in relative-to-peak terms
    scale = want.max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


def test_tone_peaks_at_right_bin():
    sr, n, hop = 48_000, 2048, 512
    f = 3000.0
    x = synth.tone(f, 0.2, sr)
    S = np.asarray(power_spectrogram(jnp.asarray(x), n, hop))
    k_peak = S[4].argmax()
    assert abs(k_peak - f * n / sr) <= 1.0


def test_stft_triple_shapes_and_hann_equals_plain():
    x = synth.noise(0.1, seed=7)
    n, hop = 1024, 256
    X_h, X_th, X_dh = stft_triple(jnp.asarray(x), n, hop)
    t = num_frames(len(x), n, hop)
    assert X_h.shape == X_th.shape == X_dh.shape == (t, n // 2 + 1)
    h, _, _ = oracle.windows(n)
    want = oracle.stft(x, n, hop, h)
    np.testing.assert_allclose(np.asarray(X_h), want, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("n,hop", [(512, 128), (4096, 1024)])
def test_stencil_method_matches_direct(n, hop):
    """The 2-rfft stencil formulation (modulation theorem, exact for
    periodic Hann) must match the 3-rfft direct windowed FFTs to float32
    rounding."""
    x = jnp.asarray(synth.multitone([440.0, 3000.0], 0.12)
                    + synth.noise(0.12, seed=5, amplitude=0.01))
    direct = stft_triple(x, n, hop, method="direct")
    stencil = stft_triple(x, n, hop, method="stencil")
    for name, a, b in zip(("X_h", "X_th", "X_dh"), direct, stencil):
        scale = float(jnp.abs(a).max())
        np.testing.assert_allclose(np.asarray(b) / scale,
                                   np.asarray(a) / scale, atol=5e-5,
                                   err_msg=name)


def test_batched_channels():
    x = np.stack([synth.tone(440.0, 0.1), synth.tone(880.0, 0.1)])
    S = np.asarray(power_spectrogram(jnp.asarray(x), 1024, 256))
    assert S.shape[0] == 2
    sr = 48_000
    assert abs(S[0][2].argmax() - 440.0 * 1024 / sr) <= 1.0
    assert abs(S[1][2].argmax() - 880.0 * 1024 / sr) <= 1.0


@pytest.mark.parametrize("shape", [(512,), (6, 512), (2, 5, 1024), (3, 2, 4, 256)],
                         ids=["1-D", "frames", "channels", "lead-dims"])
def test_direct_triple_window_matches_oracle(shape):
    """The direct method's broadcast windowing (one (3, ..., n) stack,
    used by Pipeline for fft_method="direct") equals frames × each
    float64 oracle window."""
    from emspec.dsp.stft import windowed_triple

    rng = np.random.default_rng(len(shape))
    frames = rng.standard_normal(shape).astype(np.float32)
    got = np.asarray(windowed_triple(jnp.asarray(frames)))
    assert got.shape == (3,) + shape
    for k, w in enumerate(oracle.windows(shape[-1])):
        np.testing.assert_allclose(got[k], frames * w, rtol=2e-6,
                                   atol=2e-6 * shape[-1])
