"""Engine choices (emspec.engine): the GPU takes the timed-faster
formulation, every other backend keeps the bit-exact plain path."""

import jax.numpy as jnp
import numpy as np
import pytest

from emspec import engine
from emspec.config import Settings
from emspec.pipeline import Pipeline


@pytest.fixture
def as_gpu(monkeypatch):
    """Decide engine choices as on a GPU backend (the ops still run on
    the CPU)."""
    monkeypatch.setattr(engine, "on_gpu", lambda: True)


def test_cpu_keeps_the_plain_formulations():
    assert not engine.on_gpu()
    assert not engine.associative_ema()


def test_gpu_takes_the_associative_ema(as_gpu):
    assert engine.associative_ema()


def test_gpu_post_chain_default_follows_engine(as_gpu):
    """postprocess_batch(associative=None) takes the engine's choice: on
    the GPU the result is the associative one."""
    from emspec.post.chain import PostParams, PostState, postprocess_batch

    rng = np.random.default_rng(4)
    t, rows = 300, 16
    power = jnp.asarray(rng.random((t, rows)).astype(np.float32) * 1e-2)
    p = PostParams.from_settings(Settings(smoothing=0.6),
                                 np.linspace(30, 20000, rows))
    st = PostState.init((rows,))
    got, _ = postprocess_batch(power, st, p)
    asc, _ = postprocess_batch(power, st, p, associative=True)
    assert np.array_equal(np.asarray(got), np.asarray(asc))


def test_fft_impl_auto_resolves_to_xla():
    for s in (Settings(), Settings(multires=False, fft_size=8192),
              Settings(multires=False, fft_size=32768, channels=4)):
        assert Pipeline(s).fft_impl == "xla"
    assert Pipeline(Settings(multires=False, fft_size=8192,
                             fft_impl="fourstep")).fft_impl == "fourstep"


def test_old_presets_with_removed_scatter_knobs_still_load():
    """Settings.from_dict drops keys it does not know, so presets saved
    with the removed ``scatter``/``scatter_passes`` fields still load."""
    d = Settings(gain=5.0).to_dict()
    d.update(scatter="pallas", scatter_passes=3)
    s = Settings.from_dict(d)
    assert s.gain == 5.0 and not hasattr(s, "scatter")


def test_batch_scatter_of_channels_equals_per_channel_scatter():
    """The flattened segment_sum over (channels, t·rows) gives each
    channel exactly its own single-channel scatter."""
    s = Settings(mode="enhanced", multires=True, multires_sizes=(1024, 512),
                 raster_height=64, hop=256, channels=2)
    pipe = Pipeline(s)
    rng = np.random.default_rng(9)
    t, m = 12, 40
    rows_i = jnp.asarray(rng.integers(0, 64, (2, t, m)), jnp.int32)
    delta = jnp.asarray(rng.integers(-3, 4, (2, t, m)), jnp.int32)
    contrib = jnp.asarray(rng.random((2, t, m)), jnp.float32)
    both = np.asarray(pipe._scatter_segment_sum(rows_i, delta, contrib, t,
                                                (2,)))
    assert both.shape == (2, t, 64)
    for c in range(2):
        one = np.asarray(pipe._scatter_segment_sum(
            rows_i[c], delta[c], contrib[c], t, ()))
        np.testing.assert_array_equal(both[c], one)
