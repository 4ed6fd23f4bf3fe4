"""Cases that need the card: the GPU engine choices and the GPU
streaming ≡ batch contract (DESIGN.md §5), at small shapes.

Marked ``gpu``; the ``gpu`` fixture skips them off the GPU.  Run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` or as the
gpu-tests phase of ``python chip_smoke.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emspec.config import Settings
from emspec.io import synth
from emspec.pipeline import Pipeline

import oracle

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

SR = 48_000


def _settings(**kw):
    kw.setdefault("mode", "enhanced")
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (4096, 1024, 512))
    kw.setdefault("raster_height", 256)
    kw.setdefault("hop", 128)
    return Settings(**kw)


def _signal(seconds):
    return (synth.chirp(80.0, 12_000.0, seconds, SR, amplitude=0.4)
            + synth.multitone([110.0, 440.0, 3000.0], seconds, SR)
            + synth.noise(seconds, SR, amplitude=0.01, seed=3))


def test_gpu_enhanced_multires_matches_oracle(gpu):
    """The GPU path (cuFFT, XLA scatter-add with atomics) stays inside
    DESIGN.md §9 against the float64 oracle."""
    s = _settings()
    x = _signal(0.25)
    pipe = Pipeline(s)
    t = pipe.num_columns(len(x))
    got = jax.jit(pipe._enhanced_power, static_argnums=1)(
        jnp.asarray(x), t, pipe.params())
    want = oracle.multires_enhanced(
        x, s.multires_sizes, s.hop_samples, s.raster_height, SR,
        s.freq_min, s.freq_scale, s.crossover_low, s.crossover_high)
    ok, msg = chip_smoke.compare_power(np.asarray(got), want, pipe.n_max,
                                       scatter=True)
    assert ok, msg


def test_gpu_stream_matches_batch_within_bound(gpu):
    """Streaming ≡ batch on the card within the stated GPU bound."""
    from emspec.stream import stream_signal

    s = _settings(smoothing=0.3)
    x = _signal(0.4)
    vis_s, rgba_s = stream_signal(x, s, chunk=s.hop)
    vis_b, rgba_b, _ = Pipeline(s).process(x)
    ok, msg = chip_smoke.compare_display(vis_s, rgba_s, vis_b, rgba_b)
    assert ok, msg


def test_gpu_post_chain_engine_agrees(gpu):
    """The associative EMA the GPU takes at display-scale t agrees with
    the sequential scan to reassociation rounding."""
    from emspec.post.chain import PostParams, PostState, postprocess_batch

    rng = np.random.default_rng(5)
    t, rows = 1500, 128
    power = jnp.asarray(rng.random((t, rows)).astype(np.float32) * 1e-2)
    p = PostParams.from_settings(Settings(smoothing=0.7),
                                 np.linspace(30, 20000, rows))
    st = PostState.init((rows,))
    seq, _ = postprocess_batch(power, st, p, associative=False)
    asc, _ = postprocess_batch(power, st, p, associative=True)
    np.testing.assert_allclose(np.asarray(asc), np.asarray(seq), atol=2e-5)
