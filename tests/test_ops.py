"""Operability subsystems: checkpoint/resume to disk, prewarm, hover
readout on the pipeline, tracing utils (SURVEY.md §5 + §7 hard part 3)."""

import time

import numpy as np
import pytest

from emspec.config import Settings
from emspec.io import synth
from emspec.pipeline import Pipeline, get_pipeline, prewarm
from emspec.stream import Stream, stream_signal
from emspec.utils.checkpoint import load_stream, save_stream
from emspec.utils.tracing import StageTimer

SR = 48_000


def _settings(**kw):
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (2048, 1024, 512))
    kw.setdefault("raster_height", 128)
    kw.setdefault("hop", 256)
    kw.setdefault("smoothing", 0.5)
    return Settings(**kw)


# -------------------------------------------------------------- checkpoint
def test_checkpoint_resume_bit_exact(tmp_path):
    """Save mid-stream, resume in a fresh process-level Stream, outputs
    must equal the uninterrupted run exactly (SURVEY.md §5.4)."""
    s = _settings(mode="enhanced")
    x = synth.chirp(100.0, 6000.0, 0.3, SR)
    half = len(x) // 2
    ckpt = tmp_path / "stream.npz"

    st1 = Stream(s)
    cols_a = st1.push(x[:half])
    save_stream(ckpt, st1)

    st2 = Stream(s)
    load_stream(ckpt, st2)
    cols_b = st2.push(x[half:]) + st2.flush()

    ref_vis, _ = stream_signal(x, s)
    got = {c.index: np.asarray(c.vis) for c in cols_a + cols_b}
    assert sorted(got) == list(range(ref_vis.shape[0]))
    for i, want in enumerate(ref_vis):
        np.testing.assert_allclose(got[i], want, atol=1e-6)


def test_checkpoint_migrates_pre_rolling_layout(tmp_path):
    """A snapshot saved BEFORE the rolling-window carry (round 4) holds
    only the inner carry leaves.  load_stream must migrate it — zeroed
    window + re-prime from the replayed ring — and the continuation must
    still equal the uninterrupted run exactly (the re-primed window is
    rebuilt from the very samples the original window held)."""
    s = _settings(mode="enhanced")
    x = synth.chirp(100.0, 6000.0, 0.3, SR)
    half = len(x) // 2
    ckpt = tmp_path / "stream.npz"

    st1 = Stream(s)
    cols_a = st1.push(x[:half])
    save_stream(ckpt, st1)
    # rewrite the npz in the OLD layout: drop the window leaf (carry_0)
    # and renumber the inner leaves down
    z = dict(np.load(ckpt, allow_pickle=False))
    n_carry = sum(1 for k in z if k.startswith("carry_"))
    old = {k: v for k, v in z.items() if not k.startswith("carry_")}
    for i in range(1, n_carry):
        old[f"carry_{i - 1}"] = z[f"carry_{i}"]
    np.savez(ckpt, **old)

    st2 = Stream(s)
    load_stream(ckpt, st2)
    assert st2._window_ready is False          # migration forces re-prime
    cols_b = st2.push(x[half:]) + st2.flush()

    ref_vis, _ = stream_signal(x, s)
    got = {c.index: np.asarray(c.vis) for c in cols_a + cols_b}
    assert sorted(got) == list(range(ref_vis.shape[0]))
    for i, want in enumerate(ref_vis):
        np.testing.assert_allclose(got[i], want, atol=1e-6)


def test_latency_harness_drives_the_production_staging():
    """Regression net: `_latency` once reimplemented Stream feeding and
    silently broke when the staging protocol changed (full windows fed
    as hop blocks + a TypeError on the restructured carry).  Drive it on
    CPU at a tiny size — the point is that the staging/dispatch
    machinery it times is the real Stream protocol."""
    from emspec.bench import harness

    rep = harness._latency(
        _settings(mode="enhanced", multires=False, fft_size=1024), hops=6)
    assert rep["p50_ms"] > 0 and rep["p99_ms"] >= rep["p50_ms"]
    assert rep["pipelined_ms_per_hop"] > 0
    assert rep["hops"] == 6


def test_checkpoint_extensionless_path_roundtrip(tmp_path):
    """save_stream(p)/load_stream(p) must agree on the on-disk name even
    when p has no .npz suffix (np.savez appends one on save)."""
    s = _settings(mode="natural")
    x = synth.tone(440.0, 0.1, SR)
    st1 = Stream(s)
    st1.push(x)
    plain = tmp_path / "ckpt"                 # no suffix
    save_stream(plain, st1)
    assert (tmp_path / "ckpt.npz").exists()
    st2 = Stream(s)
    load_stream(plain, st2)                   # same argument round-trips
    assert st2._t == st1._t


def test_stream_state_pytree_survives_donation():
    """state_pytree snapshots must stay valid after further pushes — the
    live carry's buffers are donated into the next step (ADVICE round 1)."""
    s = _settings(mode="natural")
    st = Stream(s)
    st.push(synth.tone(440.0, 0.15, SR))
    snap = st.state_pytree()
    before = [np.array(a, copy=True) for a in
              __import__("jax").tree_util.tree_leaves(snap["carry"])]
    st.push(synth.tone(880.0, 0.1, SR))       # donates the live carry
    after = __import__("jax").tree_util.tree_leaves(snap["carry"])
    for b, a in zip(before, after):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_checkpoint_rejects_pickle(tmp_path):
    """Checkpoint loading must never execute pickled code."""
    import pickle
    bad = tmp_path / "evil.npz"
    bad.write_bytes(pickle.dumps({"boom": 1}))
    st = Stream(_settings(mode="natural"))
    with pytest.raises(Exception):
        load_stream(bad, st)


# ----------------------------------------------------------------- prewarm
def test_prewarm_compiles_stream_step():
    s = _settings(mode="enhanced")
    fut = prewarm(s, sizes=(512, 1024), background=True)
    fut.result(timeout=300)
    # the warmed executable is the very object Stream uses
    pipe = get_pipeline(s.replace(multires=False, fft_size=1024))
    st = Stream(s.replace(multires=False, fft_size=1024))
    assert st._step is pipe._stream_roll_jit
    t0 = time.perf_counter()
    st.push(synth.tone(440.0, 0.1, SR))
    assert time.perf_counter() - t0 < 5.0  # no fresh compile stall


# ------------------------------------------------------------------- hover
def test_pipeline_hover_readout():
    pipe = Pipeline(_settings(raster_height=256))
    # A4 row round-trips
    row = pipe.row_of_frequency(440.0)
    f = pipe.frequency_at_row(row)
    assert abs(np.log2(f / 440.0)) < np.log2(pipe.row_freqs[1] / pipe.row_freqs[0])
    assert "Hz" in pipe.describe_row(row) and "A4" in pipe.describe_row(row)
    # extremes stay in range
    assert pipe.row_of_frequency(1.0) == 0
    assert pipe.row_of_frequency(1e6) == pipe.rows - 1
    # freq_scale zoom changes the mapping (Freq Scale slider contract)
    zoomed = Pipeline(_settings(raster_height=256, freq_scale=2.0))
    assert zoomed.frequency_at_row(255) < pipe.frequency_at_row(255)


# ----------------------------------------------------------------- tracing
def test_prewarm_set_stays_cached_under_churn():
    """The whole pre-warmed dropdown must stay resident while the app
    churns continuous settings (round-1 Weak #5: lru eviction vs the
    prewarm set was untested)."""
    from emspec.config import FFT_SIZES
    from emspec.pipeline import _cached_pipeline, get_pipeline

    _cached_pipeline.cache_clear()
    base = Settings(multires=False, raster_height=64)
    pipes = {n: get_pipeline(base.replace(fft_size=n)) for n in FFT_SIZES}
    # continuous churn: many distinct slider values must all hit the
    # same cached pipelines (structural projection) and evict nothing
    for g in np.linspace(0.5, 9.5, 40):
        for n in (512, 4096, 32768):
            assert get_pipeline(
                base.replace(fft_size=n, gain=float(g))) is pipes[n]
    info = _cached_pipeline.cache_info()
    assert info.misses == len(FFT_SIZES)
    assert info.currsize == len(FFT_SIZES)


def test_prewarm_reuses_one_worker_thread():
    from emspec.pipeline import _warm_pool
    assert _warm_pool() is _warm_pool()


def test_roofline_estimates():
    """Roofline model sanity: estimates are positive, scale with channel
    count, and enhanced mode costs more than natural."""
    from emspec.bench.roofline import estimate_column_cost, roofline_report
    p1 = Pipeline(Settings(mode="enhanced", multires=False, fft_size=8192))
    p16 = Pipeline(Settings(mode="enhanced", multires=False, fft_size=8192,
                            channels=16))
    pn = Pipeline(Settings(mode="natural", multires=False, fft_size=8192))
    e1 = estimate_column_cost(p1)
    e16 = estimate_column_cost(p16)
    en = estimate_column_cost(pn)
    assert e1["flops_per_col"] > 0 and e1["bytes_per_col"] > 0
    assert abs(e16["flops_per_col"] / e1["flops_per_col"] - 16) < 1e-6
    assert en["flops_per_col"] < e1["flops_per_col"]
    r = roofline_report(p1, 100_000.0, "NVIDIA H100 80GB HBM3")
    assert r["achieved_tflops"] > 0
    assert 0 <= r["pct_f32_peak"] <= 100
    assert 0 <= r["pct_hbm_peak"] <= 100


def test_roofline_unknown_device_raises():
    """A device without published peaks is an error, never a default —
    the CPU included."""
    from emspec.bench.roofline import peaks_for, roofline_report
    with pytest.raises(ValueError, match="no published peaks"):
        peaks_for("Unlisted Accelerator 9000")
    p1 = Pipeline(Settings(mode="enhanced", multires=False, fft_size=1024))
    with pytest.raises(ValueError, match="no published peaks"):
        roofline_report(p1, 1000.0, "cpu")


def test_bench_refuses_without_gpu(capsys):
    """bench.py and the harness's reports fail on a CPU backend instead
    of reporting CPU numbers under the GPU's name."""
    import sys
    from pathlib import Path
    from emspec.bench.harness import device_info, require_gpu
    assert device_info()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench
    assert bench.main() == 1
    assert "no GPU" in capsys.readouterr().err


def test_stage_timer():
    t = StageTimer()
    t.start()
    time.sleep(0.01)
    t.stop("a")
    time.sleep(0.005)
    t.stop("b")
    rep = t.report_us()
    assert rep["a"] >= 9_000 and rep["b"] >= 4_000


def test_trace_context(tmp_path):
    """jax.profiler trace round-trip produces trace artifacts."""
    import jax.numpy as jnp
    from emspec.utils.tracing import trace
    with trace(str(tmp_path)):
        jnp.ones((8, 8)).sum().block_until_ready()
    assert any(tmp_path.rglob("*"))   # profile files written


def test_pipeline_cache_ignores_continuous_fields():
    """Regression: a slider move before a structural switch must still hit
    the prewarmed Pipeline (the cache keys on the structural projection)."""
    base = _settings(mode="enhanced")
    a = get_pipeline(base)
    b = get_pipeline(base.replace(gain=9.0, colormap="viridis",
                                  brightness=0.8, freq_scale=1.5))
    assert a is b
    c = get_pipeline(base.replace(fft_size=1024, multires=False))
    assert c is not a


def test_sustained_display_keeps_up(tmp_path):
    """Product-level north-star check [NS: "sustain 60 fps"]: the whole
    L1→L4 stack (real-time synthetic capture thread → ring → streaming
    step → waterfall, drained at display cadence) must keep up with the
    audio clock at a small CPU-friendly config."""
    from emspec.bench.harness import sustained_display
    from emspec.config import Settings

    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=64, raster_width=128, hop=512)
    rep = sustained_display(s, seconds=1.5, user_dir=tmp_path)
    assert rep["emitted_cols"] > 0
    # generous bound: CI boxes stutter, but a broken producer/drain path
    # (dead thread, ring mis-sizing, paused stream) lands near zero
    assert rep["keepup_ratio"] > 0.5, rep
    assert rep["p99_drain_gap_ms"] < 1000.0, rep


@pytest.mark.slow
def test_soak_plumbing_short(tmp_path):
    """The leak-soak harness (round-3 VERDICT #5) end to end at CPU test
    scale: live shell + churn thread run, counters advance, slopes and
    keep-up fields are finite, and the churn thread reports no HTTP
    errors against the live settings/preset surface."""
    from emspec.bench.soak import soak
    from emspec.config import Settings

    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=64, raster_width=128, hop=512)
    rep = soak(s, seconds=3.0, sample_every=0.5, user_dir=tmp_path)
    assert rep["samples"] >= 4
    assert rep["columns_emitted"] > 0
    assert np.isfinite(rep["rss_slope_mb_per_min"])
    assert rep["churn"]["settings"] > 0
    assert rep["churn"]["presets"] > 0
    assert rep["churn"]["errors"] == 0, rep["churn"]
    assert np.isfinite(rep["keepup_second_half"])


@pytest.mark.slow
def test_soak_nonfinite_injection_plumbing(tmp_path):
    """Round-5 (VERDICT r4 #4): the soak's non-finite injection wraps the
    feeder's own sink (single-producer preserved), corrupted blocks flow
    through the REAL capture -> ring -> stream -> waterfall path, and the
    display keeps emitting non-black columns through them."""
    from emspec.bench.soak import soak
    from emspec.config import Settings

    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=64, raster_width=128, hop=512)
    rep = soak(s, seconds=4.0, sample_every=0.5, user_dir=tmp_path,
               inject_nonfinite=True, inject_every=3)
    assert rep["nonfinite_injected"] > 5
    assert rep["columns_emitted"] > 0
    assert rep["churn"]["errors"] == 0, rep["churn"]
    assert rep["final_frame_nonblack"] is True
    assert np.isfinite(rep["keepup_second_half"])


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    helper returns it and changes no config."""
    import jax
    from emspec.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    """Unset, the cache goes to <checkout>/.emspec/jax_cache — a fixed
    path (never temp, pid or time derived), listed in .gitignore."""
    import jax
    from pathlib import Path
    from emspec.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    root = Path(__file__).resolve().parents[1]
    want = str(root / ".emspec" / "jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)] * 2
    assert ".emspec/" in (root / ".gitignore").read_text().split()


def test_timed_ms_counts_warmed_fenced_calls():
    """The harness's timer: one untimed warm-up call, then ``iters``
    positive samples, each call's result waited for."""
    import jax.numpy as jnp
    from emspec.bench.harness import _timed_ms

    calls = []

    def call():
        calls.append(1)
        return jnp.ones((8, 8)) @ jnp.ones((8, 8))

    ms = _timed_ms(call, 4)
    assert len(ms) == 4 and len(calls) == 5
    assert all(m > 0 for m in ms)


def test_stage_breakdown_refuses_without_gpu():
    from emspec.bench.stages import stage_breakdown
    with pytest.raises(RuntimeError, match="no GPU"):
        stage_breakdown(Settings(mode="enhanced", multires=False,
                                 fft_size=1024), seconds=0.1)


def test_stage_to_device_ships_float32_device_arrays():
    """Every hop block goes to the device as float32 (the staging copy
    the two-slot prefetch overlaps with the previous step)."""
    import jax
    from emspec.stream import _stage_to_device

    dev = _stage_to_device(np.arange(6, dtype=np.float64))
    assert isinstance(dev, jax.Array) and dev.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(dev), np.arange(6))
