"""Streaming tests: ring buffer, streaming ≡ batch equivalence
(SURVEY.md §4.4 — the test that catches carry/prefetch-ordering bugs),
pause/resume, state save/restore, waterfall, live_state contract."""

import json

import numpy as np
import pytest

from emspec.config import Settings
from emspec.io.ring import RingBuffer
from emspec.io import synth
from emspec.pipeline import Pipeline
from emspec.stream import Stream, stream_signal
from emspec.render.waterfall import Waterfall
from emspec.integrations import live_state

SR = 48_000


def _settings(**kw):
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (2048, 1024, 512))
    kw.setdefault("raster_height", 128)
    kw.setdefault("hop", 256)
    kw.setdefault("smoothing", 0.5)     # make statefulness matter
    kw.setdefault("auto_gain", True)
    return Settings(**kw)


# ------------------------------------------------------------- ring buffer
def test_ring_push_and_window():
    r = RingBuffer(100, 1)
    r.push(np.arange(30, dtype=np.float32))
    r.push(np.arange(30, 60, dtype=np.float32))
    assert r.total_written == 60
    np.testing.assert_array_equal(r.window_at(10, 20)[0], np.arange(10, 30))
    np.testing.assert_array_equal(r.latest(5)[0], np.arange(55, 60))


def test_ring_wraparound_and_overrun():
    r = RingBuffer(64, 1)
    r.push(np.arange(100, dtype=np.float32))
    np.testing.assert_array_equal(r.window_at(90, 10)[0], np.arange(90, 100))
    with pytest.raises(ValueError):
        r.window_at(10, 10)     # overwritten
    with pytest.raises(ValueError):
        r.window_at(95, 10)     # future


def test_ring_multichannel():
    r = RingBuffer(50, 2)
    r.push(np.stack([np.arange(10.0), np.arange(10.0) * 2]))
    w = r.latest(4)
    assert w.shape == (2, 4)
    np.testing.assert_array_equal(w[1], [12, 14, 16, 18])


def test_ring_giant_push_keeps_newest():
    r = RingBuffer(16, 1)
    r.push(np.arange(100, dtype=np.float32))
    np.testing.assert_array_equal(r.latest(16)[0], np.arange(84, 100))


# ----------------------------------------------------- streaming ≡ batch
@pytest.mark.parametrize("mode", ["natural", "enhanced"])
def test_streaming_equals_batch(mode):
    s = _settings(mode=mode)
    x = (synth.chirp(100.0, 8000.0, 0.25, SR)
         + synth.multitone([330.0], 0.25, amplitude=0.3))
    pipe = Pipeline(s)
    vis_b, rgba_b, _ = pipe.process(x)
    vis_s, rgba_s = stream_signal(x, s, chunk=777)  # awkward chunk on purpose
    t = pipe.num_columns(len(x))
    assert vis_s.shape[0] == t
    np.testing.assert_allclose(vis_s, np.asarray(vis_b), atol=1e-6)
    np.testing.assert_array_equal(rgba_s, np.asarray(rgba_b))


@pytest.mark.slow
def test_streaming_equals_batch_multichannel():
    s = _settings(mode="enhanced", channels=2, smoothing=0.3)
    x = np.stack([synth.tone(440.0, 0.15, SR), synth.chirp(200, 4000, 0.15, SR)])
    pipe = Pipeline(s)
    vis_b, _, _ = pipe.process(x)
    vis_s, _ = stream_signal(x, s, chunk=500)
    np.testing.assert_allclose(vis_s, np.asarray(vis_b), atol=1e-6)


def test_stream_incremental_chunks_equal_one_push():
    s = _settings(mode="enhanced", smoothing=0.0)
    x = synth.noise(0.2, seed=9)
    a = stream_signal(x, s, chunk=128)[0]
    b = stream_signal(x, s, chunk=len(x))[0]
    np.testing.assert_allclose(a, b, atol=0)


def test_stream_random_block_sizes_equal_batch():
    """Fuzz the push granularity: an adversarial random block-size
    sequence (1-sample dribbles through multi-hop bursts) must be
    bit-identical to one whole-signal push — the fixed-chunk tests never
    hit e.g. a block boundary INSIDE a hop right after a giant burst."""
    s = _settings(mode="enhanced", smoothing=0.3)
    x = synth.noise(0.25, seed=13)
    rng = np.random.default_rng(17)
    st = Stream(s)
    cols, i = [], 0
    while i < len(x):
        b = int(rng.choice([1, 3, 64, 500, 1024, 4096]))
        cols.extend(st.push(x[i:i + b]))
        i += b
    cols.extend(st.flush())
    cols.sort(key=lambda c: c.index)
    got = np.stack([np.asarray(c.vis) for c in cols])
    want = stream_signal(x, s, chunk=len(x))[0]
    np.testing.assert_allclose(got, want, atol=0)


# --------------------------------------------------------- pause / resume
def test_pause_resume():
    s = _settings(mode="natural")
    st = Stream(s)
    x = synth.tone(440.0, 0.2, SR)
    st.pause()
    cols = st.push(x[:6000])
    assert cols == []                      # paused: no analysis
    st.resume()
    cols = st.push(x[6000:])               # ring kept filling while paused
    assert len(cols) > 0
    indices = [c.index for c in cols]
    assert indices == sorted(indices)
    assert indices[0] == 0                 # nothing was lost


def test_underrun_last_column_repaint():
    """SURVEY.md §5.3: when input starves, the app repaints last_column."""
    s = _settings(mode="natural")
    st = Stream(s)
    assert st.last_column() is None
    cols = st.push(synth.tone(440.0, 0.1, SR))
    assert cols
    last = st.last_column()
    assert last is not None and last.index == cols[-1].index
    assert st.push(np.zeros(4, np.float32)) == []     # starved: no new column
    assert st.last_column() is last                    # but repaintable


def test_global_agc_couples_channels():
    """agc_global=True drives every channel with one shared reference —
    the cross-chip collective surface (SURVEY.md §5.8)."""
    import jax.numpy as jnp
    from emspec.pipeline import Pipeline
    s = _settings(mode="natural", channels=2, agc_global=True)
    x = np.stack([synth.tone(440.0, 0.2, SR),
                  0.001 * synth.tone(2000.0, 0.2, SR)])   # loud + quiet ch
    pipe = Pipeline(s)
    _, _, state = pipe.process(x)
    refs = np.asarray(state.agc_ref)
    assert refs.shape == (2,)
    np.testing.assert_allclose(refs[0], refs[1])          # coupled
    s2 = s.replace(agc_global=False)
    _, _, state2 = Pipeline(s2).process(x)
    refs2 = np.asarray(state2.agc_ref)
    assert abs(refs2[0] - refs2[1]) > 1.0                  # decoupled differ


def test_waterfall_fractional_speed_averages():
    """Scroll speed 0.5 paints the AVERAGE of the two analyzed columns —
    analyzed data is decimated, not discarded (DESIGN.md §9; round-1
    semantics dropped the off-phase column)."""
    import jax.numpy as jnp
    wf = Waterfall(8, 4, scroll_speed=0.5)
    a = jnp.full((4, 4), 100, jnp.uint8)
    b = jnp.full((4, 4), 200, jnp.uint8)
    wf.add_column(a)        # phase 0.5 — accumulates, paints nothing
    wf.add_column(b)        # phase 1.0 — paints mean(a, b) = 150
    img = wf.image()        # (rows, width, 4); newest column rightmost
    np.testing.assert_array_equal(img[:, -1],
                                  np.full((4, 4), 150, np.uint8))


def test_waterfall_fractional_mean_is_pre_lut():
    """Sub-1 scroll-speed averaging runs in vis space: the painted pixel
    is LUT(mean(vis)) — on the palette — not mean(LUT(vis)), which lands
    off-palette through a nonlinear map (DESIGN.md §8 round-3
    correction)."""
    import jax.numpy as jnp

    from emspec.post.colormap import apply_lut, lut

    table = lut("inferno")
    v_a = jnp.full((4,), 0.1, jnp.float32)
    v_b = jnp.full((4,), 0.9, jnp.float32)
    rgba_a = apply_lut(v_a, jnp.asarray(table))
    rgba_b = apply_lut(v_b, jnp.asarray(table))
    wf = Waterfall(8, 4, scroll_speed=0.5, lut_table=table)
    wf.add_column(rgba_a, v_a)     # phase 0.5 — banks vis, paints nothing
    wf.add_column(rgba_b, v_b)     # phase 1.0 — paints LUT(mean vis)
    img = wf.image()
    expect = np.asarray(apply_lut(jnp.full((4,), 0.5, jnp.float32),
                                  jnp.asarray(table)))
    np.testing.assert_array_equal(img[:, -1], expect[::-1])
    # and the old RGBA-space mean is genuinely different through inferno
    rgba_mean = np.round((np.asarray(rgba_a).astype(np.float64)
                          + np.asarray(rgba_b)) / 2).astype(np.uint8)
    assert not np.array_equal(expect, rgba_mean)


def test_waterfall_mixed_vis_rgba_rejected():
    """Banked vis columns followed by an RGBA-only column (or vice versa)
    is a caller bug — rejected loudly rather than silently mis-averaged."""
    import jax.numpy as jnp

    from emspec.post.colormap import lut

    wf = Waterfall(8, 4, scroll_speed=0.25, lut_table=lut("inferno"))
    wf.add_column(jnp.zeros((4, 4), jnp.uint8), jnp.zeros((4,), jnp.float32))
    with pytest.raises(ValueError, match="mixed"):
        wf.add_column(jnp.zeros((4, 4), jnp.uint8))


def test_waterfall_speed_one_bit_identical():
    """At speed 1.0 the painted column is the emitted column exactly (no
    float round-trip)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    col = jnp.asarray(rng.integers(0, 256, (4, 4)).astype(np.uint8))
    wf = Waterfall(4, 4, scroll_speed=1.0)
    wf.add_column(col)
    # newest column is rightmost; image flips rows (bass at bottom)
    np.testing.assert_array_equal(wf.image()[:, -1], np.asarray(col)[::-1])


def test_read_png_roundtrip(tmp_path):
    """read_png decodes exactly what write_png encodes (RGBA and RGB) —
    the dependency-free reader tests and tools use to load our own
    rasters back."""
    from emspec.render.png import read_png, write_png
    rng = np.random.default_rng(7)
    for c in (4, 3):
        img = rng.integers(0, 256, (5, 9, c)).astype(np.uint8)
        p = tmp_path / f"x{c}.png"
        write_png(p, img)
        np.testing.assert_array_equal(read_png(p), img)
    (tmp_path / "bad.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "bad.png")
    (tmp_path / "trunc.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="truncated"):
        read_png(tmp_path / "trunc.png")


def test_tile_images_grid():
    from emspec.render.png import tile_images
    imgs = [np.full((4, 6, 4), i, np.uint8) for i in range(5)]
    out = tile_images(imgs, pad=2)
    # 5 images → 3x2 grid: width 3*6+2*2=22, height 2*4+2=10
    assert out.shape == (10, 22, 4)
    assert out[0, 0, 0] == 0 and out[0, 8, 0] == 1


def test_display_channel_is_continuous():
    """Switching the displayed channel must never recompile (VERDICT #7)."""
    from emspec.config import is_structural_change
    s = Settings(channels=2)
    assert not is_structural_change(s, s.replace(display_channel=1))
    with pytest.raises(ValueError):
        Settings(channels=2, display_channel=5)


def test_staging_overlaps_compute():
    """Double-buffered prefetch contract [NS north_star]: the host→HBM
    copy (device_put) for hop t+1 must be ISSUED before the step for hop
    t dispatches, for every t — a structural ordering, not an async
    accident.  Recorded by instrumenting the staging and step calls."""
    s = _settings(mode="natural")
    st = Stream(s)
    events = []

    real_stage = st._stage_one
    def tagged_stage():
        ok = real_stage()
        if ok:
            events.append(("put", st._next_stage - 1))
        return ok
    st._stage_one = tagged_stage

    real_step = st._step
    def tagged_step(carry, dev, params):
        # the frame being stepped is the one just popped from the queue
        events.append(("step", st._next_stage - len(st._staged) - 1))
        return real_step(carry, dev, params)
    st._step = tagged_step

    st.push(synth.tone(440.0, 0.25, SR))     # many hops in one drain
    put_pos = {f: i for i, (kind, f) in enumerate(events) if kind == "put"}
    steps = [(i, f) for i, (kind, f) in enumerate(events) if kind == "step"]
    assert len(steps) >= 8
    last_staged = max(put_pos)
    # for every step t (except the last available frame), put(t+1) must
    # appear in the event log BEFORE step(t)
    for i, f in steps:
        if f + 1 <= last_staged:
            assert put_pos[f + 1] < i, (
                f"hop {f+1} staged after step {f} dispatched")


def test_overrun_recovery():
    """Producer laps the ring while paused → stream skips ahead instead of
    dying, and counts the dropped frames (SURVEY.md §5.3)."""
    s = _settings(mode="natural")
    st = Stream(s, ring_seconds=0.1)      # tiny ring: 4800 samples
    st.pause()
    st.push(synth.tone(440.0, 1.0, SR))   # 48000 samples >> ring
    st.resume()
    cols = st.push(synth.tone(440.0, 0.05, SR))
    assert len(cols) > 0
    assert st.dropped_frames > 0
    # Column.index stays on absolute audio time: the skipped frames leave
    # a gap, so post-skip indices sit at analyzed-hops + dropped
    assert max(c.index for c in cols) >= st.dropped_frames


def test_overrun_reprime_window_content():
    """After an overrun skip-ahead the device-resident rolling window
    must be RE-PRIMED from the ring — a stale window would emit columns
    whose content silently mixes pre- and post-skip audio.  With a
    stateless post chain, every emitted column must equal the batch
    analysis of its absolute-time window."""
    s = _settings(mode="natural", multires=False, fft_size=1024,
                  smoothing=0.0, auto_gain=False)
    st = Stream(s, ring_seconds=0.1)          # tiny ring: 4800 samples
    n_max, hop = st.pipe.n_max, st.pipe.hop
    rng = np.random.default_rng(7)
    x0 = (rng.standard_normal(SR // 16) * 0.2).astype(np.float32)
    pre = st.push(x0)                         # stream is mid-flight,
    assert len(pre) > 0                       # window already rolling...
    x = (rng.standard_normal(SR) * 0.2).astype(np.float32)   # 1 s >> ring
    st.pause()
    st.push(x)                                # ...then the producer laps
    st.resume()
    x2 = (rng.standard_normal(SR // 10) * 0.2).astype(np.float32)
    cols = st.push(x2)
    assert st.dropped_frames > 0 and len(cols) > 0
    full = np.concatenate([x0, x, x2])
    pipe = Pipeline(s)
    for c in cols[:: max(len(cols) // 6, 1)]:
        start = c.index * hop
        window = full[start:start + n_max]
        if window.shape[0] < n_max:
            continue
        vis_b, _, _ = pipe.process(window)
        np.testing.assert_array_equal(np.asarray(c.vis),
                                      np.asarray(vis_b)[0])


# ------------------------------------------------------ state save/restore
def test_stream_state_roundtrip():
    s = _settings(mode="enhanced", smoothing=0.6)
    x = synth.chirp(100.0, 6000.0, 0.3, SR)
    half = len(x) // 2

    st1 = Stream(s)
    cols_a = st1.push(x[:half])
    saved = st1.state_pytree()

    st2 = Stream(s)
    st2.load_state(saved)
    st2.ring = st1.ring                     # ring is host state, shared here
    cols_b = st2.push(x[half:]) + st2.flush()

    ref_vis, _ = stream_signal(x, s)
    got = {c.index: np.asarray(c.vis) for c in cols_a + cols_b}
    assert sorted(got) == list(range(ref_vis.shape[0]))
    for i in range(ref_vis.shape[0]):
        np.testing.assert_allclose(got[i], ref_vis[i], atol=1e-6)


# ---------------------------------------------------------------- waterfall
def test_waterfall_scrolls():
    import jax.numpy as jnp
    wf = Waterfall(width=8, rows=4, scroll_speed=1.0)
    for i in range(10):
        col = jnp.full((4, 4), i + 1, jnp.uint8)
        wf.add_column(col)
    img = wf.image()
    assert img.shape == (4, 8, 4)
    # last 8 of 10 columns, oldest left
    np.testing.assert_array_equal(img[0, :, 0], np.arange(3, 11))


def test_waterfall_fractional_speed():
    import jax.numpy as jnp
    wf = Waterfall(width=4, rows=2, scroll_speed=0.5)
    for i in range(8):
        wf.add_column(jnp.full((2, 4), i + 1, jnp.uint8))
    img = wf.image()
    # speed 0.5: paints on every 2nd hop → columns 2,4,6,8
    np.testing.assert_array_equal(img[0, :, 0], [2, 4, 6, 8])


# --------------------------------------------------------------- live_state
def test_live_state_contract(tmp_path):
    p = tmp_path / "live_state.json"
    assert live_state.read_state(p) == "restored"   # auto-created
    assert p.exists()

    events = []
    w = live_state.LiveStateWatcher(
        p, on_minimized=lambda: events.append("min"),
        on_restored=lambda: events.append("res"))
    live_state.write_state(p, "minimized")
    assert w.poll() == "minimized"
    live_state.write_state(p, "restored")
    w.poll()
    assert events == ["min", "res"]

    p.write_text("garbage{{{")                       # corrupt → fallback
    assert live_state.read_state(p) == "restored"
    with pytest.raises(ValueError):
        live_state.write_state(p, "fullscreen")


def test_live_state_pauses_stream(tmp_path):
    p = tmp_path / "live_state.json"
    s = _settings(mode="natural")
    st = Stream(s)
    w = live_state.LiveStateWatcher(p, on_minimized=st.pause,
                                    on_restored=st.resume)
    live_state.write_state(p, "minimized")
    w.poll()
    assert st.push(synth.tone(440.0, 0.1, SR)) == []
    live_state.write_state(p, "restored")
    w.poll()
    assert len(st.push(synth.tone(440.0, 0.1, SR))) > 0


@pytest.mark.parametrize("fft_method", ["direct", "stencil"])
@pytest.mark.slow
def test_streaming_equals_batch_direct_method(fft_method):
    """Both FFT formulations must hold the streaming == batch contract
    (regression: the direct path once diverged to a separate kernel with
    no streaming coverage)."""
    s = _settings(mode="enhanced", fft_method=fft_method)
    x = synth.chirp(150.0, 6000.0, 0.15, SR)
    from emspec.pipeline import Pipeline
    vis_b, _, _ = Pipeline(s).process(x)
    vis_s, _ = stream_signal(x, s, chunk=900)
    np.testing.assert_allclose(vis_s, np.asarray(vis_b), atol=1e-6)


def test_push_after_flush_raises():
    """flush() ends the stream (the zero-hops advanced the carry); pushing
    more audio must fail loudly instead of emitting index-shifted columns."""
    s = _settings(mode="enhanced")
    st = Stream(s)
    st.push(synth.tone(440.0, 0.1, SR))
    st.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        st.push(synth.tone(440.0, 0.05, SR))


def test_stream_signal_too_short_is_clear():
    s = _settings(mode="enhanced")
    with pytest.raises(ValueError, match="signal too short"):
        stream_signal(synth.tone(440.0, 0.01, SR), s)


def test_waterfall_rejects_multichannel_column():
    import jax.numpy as jnp
    wf = Waterfall(width=4, rows=8)
    with pytest.raises(ValueError, match="one .rows, 4. column"):
        wf.add_column(jnp.zeros((2, 8, 4), jnp.uint8))


def test_waterfall_unwritten_columns_opaque_black():
    """Slots no column has reached yet must be opaque black — a PNG of a
    part-filled waterfall composites as "no signal", never as the
    viewer's (usually white) background showing through alpha 0."""
    import jax.numpy as jnp
    wf = Waterfall(width=8, rows=4)
    wf.add_column(jnp.full((4, 4), 200, jnp.uint8))
    img = wf.image()
    np.testing.assert_array_equal(img[:, :-1, :3], 0)       # black RGB
    np.testing.assert_array_equal(img[:, :-1, 3], 255)      # opaque
