"""Performance harness (SURVEY.md §6): the BASELINE.json metrics.

Primary metric: reassigned-spectrogram frames/sec at 8192-pt FFT on one
GPU.  Also measured: every BASELINE.json config (0-4), p50/p99 per-hop
audio-to-raster latency on the streaming path, and the 16-channel 96 kHz
32768-pt stress configuration.  Every call is warmed first and timed to
``block_until_ready``; the throughput and latency reports refuse to run
without a GPU.

The reference publishes no numbers (distribution-only repo —
BASELINE.md); ``vs_baseline`` therefore reports against the north-star
target of 60 display columns/sec sustained [NS: "sustain 60 fps"].
"""

from __future__ import annotations

import time

import numpy as np

TARGET_FPS = 60.0


def _signal(seconds: float, sample_rate: int, channels: int = 1) -> np.ndarray:
    t = np.arange(int(seconds * sample_rate), dtype=np.float64) / sample_rate
    x = 0.4 * np.sin(2 * np.pi * (100.0 * t + 0.5 * 2000.0 * t * t))
    x += 0.2 * np.sin(2 * np.pi * 440.0 * t)
    rng = np.random.default_rng(0)
    x += 0.01 * rng.standard_normal(len(t))
    if channels == 1:
        return x.astype(np.float32)
    return np.stack([np.roll(x, 31 * c) for c in range(channels)]).astype(np.float32)


def device_info() -> dict:
    """The device every number below was taken on, as JAX reports it."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """Fail unless JAX's default device is a GPU: a benchmark number from
    any other backend would be reported under the GPU's name."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {info['platform']} "
            f"({info['kind']}); benchmarks run on the GPU only")
    return info


def _timed_ms(call, iters: int) -> list[float]:
    """Wall-clock ms of ``iters`` calls of ``call()``, each ended by
    ``block_until_ready`` on its result, after one warm-up call (which
    compiles)."""
    import jax

    jax.block_until_ready(call())
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _throughput(settings, seconds: float, iters: int) -> dict:
    """Batch-path columns/sec: warmed calls of the fused jit step, each
    timed to ``block_until_ready``; the median call sets the rate."""
    import jax
    from emspec.bench.roofline import roofline_report
    from emspec.pipeline import Pipeline
    from emspec.post.chain import PostState

    pipe = Pipeline(settings)
    x = _signal(seconds, settings.sample_rate, settings.channels)
    if settings.channels == 1 and x.ndim > 1:
        x = x[0]
    xd = jax.device_put(x)
    t_count = pipe.num_columns(x.shape[-1])
    p = pipe.params()
    lead = (settings.channels,) if settings.channels > 1 else ()
    st = PostState.init(lead + (pipe.rows,))
    ms = _timed_ms(lambda: pipe._batch_jit(xd, p, st, t_count), iters)
    dt = float(np.median(ms)) / 1e3
    cols_per_sec = t_count / dt
    return {
        "columns_per_sec": cols_per_sec,
        "frames_per_sec_total": cols_per_sec * max(settings.channels, 1),
        "t_count": t_count,
        "iters": iters,
        "ms_per_call_median": dt * 1e3,
        "ms_per_call_min": min(ms),
        "ms_per_call_max": max(ms),
        "realtime_factor": cols_per_sec * pipe.hop / settings.sample_rate,
        "roofline": roofline_report(pipe, cols_per_sec,
                                    device_info()["kind"]),
    }


def _latency(settings, hops: int = 200) -> dict:
    """Streaming-path per-hop audio-to-raster latency (hop block staged
    → rolling fused step → emitted RGBA column on the host), driven
    through the Stream's OWN staging machinery (`_stage_one`, which
    primes the device window at hop 0 exactly like production)."""
    from emspec.pipeline import get_pipeline
    from emspec.stream import Stream

    pipe = get_pipeline(settings)
    total_hops = hops + max(hops // 2, 8) + pipe.reach + 8
    seconds = ((pipe.n_max + total_hops * pipe.hop)
               / settings.sample_rate + 0.1)
    st = Stream(settings, ring_seconds=seconds + 1.0)   # whole signal resident
    x = _signal(seconds, settings.sample_rate, settings.channels)
    st.ring.push(x)

    def one_hop():
        staged = st._stage_one()
        assert staged, "latency signal exhausted (total_hops sizing bug)"
        dropped, dev, w_init = st._staged.popleft()
        cols = st._dispatch(dev, dropped, w_init)
        return cols[0] if cols else None

    # warmup: compile + fill the pending ring
    for _ in range(st.reach + 3):
        col = one_hop()
        if col is not None:
            _ = np.asarray(col.rgba)

    # (a) round trip: stage block → step → RGBA column fetched to host
    times = []
    for _ in range(hops):
        t0 = time.perf_counter()
        col = one_hop()
        _ = np.asarray(col.rgba)   # display can only blit a host column
        times.append(time.perf_counter() - t0)
    times = np.asarray(times) * 1e3

    # (b) pipelined: k hops dispatched back to back (the carry serializes
    # them on the device), one fetch at the end
    k = max(hops // 2, 8)
    t0 = time.perf_counter()
    for _ in range(k):
        col = one_hop()
    _ = np.asarray(col.rgba)
    pipelined_ms = (time.perf_counter() - t0) / k * 1e3

    return {"p50_ms": float(np.percentile(times, 50)),
            "p99_ms": float(np.percentile(times, 99)),
            "mean_ms": float(times.mean()),
            "pipelined_ms_per_hop": pipelined_ms,
            "hops": hops}


def write_profiler_trace(settings, outdir: str, hops: int = 40) -> str:
    """Run ``hops`` streaming steps under ``jax.profiler.trace`` and save
    the artifact (xplane + trace.json.gz) to ``outdir``: the device
    timeline of each hop beside the host's dispatch events."""
    import jax
    from emspec.stream import Stream

    st = Stream(settings, ring_seconds=8.0)
    hop, n_max = st.pipe.hop, st.pipe.n_max
    secs = (n_max + (hops + st.reach + 4) * hop) / settings.sample_rate + 0.1
    x = _signal(secs, settings.sample_rate, settings.channels)
    if settings.channels == 1 and x.ndim > 1:
        x = x[0]
    pos = n_max + (st.reach + 2) * hop
    cols = st.push(x[..., :pos])                           # warmup + compile
    if cols:
        _ = np.asarray(cols[-1].rgba)
    with jax.profiler.trace(outdir):
        for _ in range(hops):
            cols = st.push(x[..., pos:pos + hop])
            pos += hop
            if cols:
                _ = np.asarray(cols[-1].rgba)              # display fetch
    return outdir


def primary_metric(quick: bool = False) -> dict:
    """The headline: reassigned frames/sec at 8192-pt FFT on one GPU.

    ``value`` is the median over three measurements (quick: one) of the
    median warmed call; ``band`` is their [min, max]."""
    from emspec.config import Settings
    device = require_gpu()
    s = Settings(mode="enhanced", multires=False, fft_size=8192)
    runs = 1 if quick else 3
    # 16 s of signal = t_count≈372 frames per call
    reports = [_throughput(s, seconds=2.0 if quick else 16.0,
                           iters=3 if quick else 10)
               for _ in range(runs)]
    vals = [r["columns_per_sec"] for r in reports]
    v = float(np.median(vals))
    return {
        "metric": "reassigned_spectrogram_frames_per_sec_8192pt",
        "value": round(v, 1),
        "unit": "frames/s",
        # no published reference numbers exist (BASELINE.md); compare to the
        # 60 fps sustained-display north-star target
        "vs_baseline": round(v / TARGET_FPS, 2),
        "band": [round(min(vals), 1), round(max(vals), 1)],
        "device": device,
    }


def run_benchmarks(quick: bool = False) -> dict:
    """Full report over the BASELINE.json configs."""
    from emspec.config import Settings

    secs = 1.0 if quick else 4.0
    iters = 2 if quick else 8
    hops = 50 if quick else 200
    report: dict = {
        "device": require_gpu(),
        "primary": primary_metric(quick),
        "configs": {},
    }
    cfgs = {
        "0_stft_2048_natural": (Settings(
            mode="natural", multires=False, fft_size=2048), secs),
        "1_reassigned_2048": (Settings(
            mode="enhanced", multires=False, fft_size=2048), secs),
        "2_multires_log_merge": (Settings(mode="enhanced", multires=True),
                                 secs),
        "4_stress_16ch_96k_32768": (Settings(
            mode="enhanced", multires=False, fft_size=32768,
            sample_rate=96_000, channels=16), secs),
    }
    if not quick:
        # SURVEY §5.7 scaling extensions ("32768 and beyond") — not
        # BASELINE.json configs and the largest compiles in the codebase,
        # so --quick skips them; 262144 needs 8 s to hold >1.5 windows
        cfgs["5_ext_65536_96k"] = (Settings(
            mode="enhanced", multires=False, fft_size=65536,
            sample_rate=96_000), 32.0)
        cfgs["6_ext_131072_96k"] = (Settings(
            mode="enhanced", multires=False, fft_size=131072,
            sample_rate=96_000), secs)
        cfgs["7_ext_262144_96k"] = (Settings(
            mode="enhanced", multires=False, fft_size=262144,
            sample_rate=96_000), 8.0)
    for name, (s, cfg_secs) in cfgs.items():
        report["configs"][name] = _throughput(s, cfg_secs, iters)
    # config 3 is the streaming path: measured as latency
    report["configs"]["3_streaming_latency_default"] = _latency(
        Settings(mode="enhanced", multires=True), hops)
    report["configs"]["3_streaming_latency_8192"] = _latency(
        Settings(mode="enhanced", multires=False, fft_size=8192), hops)
    return report


def sustained_display(settings=None, seconds: float = 8.0,
                      drain_hz: float = 60.0, user_dir=None) -> dict:
    """Product-level north-star measurement [NS: "sustain 60 fps"]: run
    the REAL display stack — real-time-paced synthetic capture → seqlock
    ring → streaming device step → waterfall — for ``seconds`` of wall
    clock, draining at the display cadence like the window shells do,
    and report whether column production kept up with the audio clock.

    Unlike ``_throughput``/``_latency`` (device- and call-level numbers)
    this exercises the whole L1→L4 concurrency story at once: producer
    thread pacing, ring overrun handling, per-hop dispatch, waterfall
    blitting.  ``keepup_ratio`` ≈ 1.0 means the display never starved;
    the reach-delay warmup and ±1 hop of clock quantization make ~0.95+
    the healthy band.  ``emspec bench --sustained`` prints it.
    """
    import contextlib
    import tempfile

    from emspec.config import Settings

    s = settings or Settings(mode="enhanced", multires=True)
    tmp_ctx = (tempfile.TemporaryDirectory(prefix="emspec_sustained_")
               if user_dir is None else contextlib.nullcontext(str(user_dir)))
    with tmp_ctx as ud:
        return _sustained_run(s, ud, seconds, drain_hz)


def _sustained_run(s, ud, seconds: float, drain_hz: float) -> dict:
    import time as _time

    from emspec.app import EmSpecApp
    from emspec.shell.feed import AudioFeeder

    app = EmSpecApp(s, user_dir=ud)
    # compile outside the clock: one silent window through the step
    warm = np.zeros((s.channels,
                     app.stream.pipe.n_max + app.stream.pipe.hop),
                    np.float32)
    app.push_audio(warm if s.channels > 1 else warm[0])

    feeder = AudioFeeder(app, source="synthetic")
    ch = s.channels
    empty = (np.zeros((ch, 0), np.float32) if ch > 1
             else np.zeros(0, np.float32))
    emitted = 0
    gaps = []
    feeder.start()
    t0 = _time.perf_counter()
    last = t0
    try:
        while True:
            now = _time.perf_counter()
            if now - t0 >= seconds:
                break
            got = app.push_audio(empty)
            if got:
                gaps.append(now - last)
                last = now
            emitted += got
            _time.sleep(1.0 / drain_hz)
        # clock stops HERE: feeder.stop() joins the capture thread (up to
        # a capture block) and must not count against the keep-up ratio
        elapsed = _time.perf_counter() - t0
    finally:
        feeder.stop()
        app.close()               # abandon any queued background compiles
    rate = app.settings.sample_rate
    hop = app.stream.pipe.hop
    expected = elapsed * rate / hop
    gaps_ms = sorted(g * 1e3 for g in gaps) or [0.0]
    return {
        "seconds": round(elapsed, 2),
        "expected_cols": int(expected),
        "emitted_cols": emitted,
        "keepup_ratio": round(emitted / max(expected, 1e-9), 4),
        "cols_per_sec_wall": round(emitted / elapsed, 1),
        "hop_rate_hz": round(rate / hop, 1),
        "p50_drain_gap_ms": round(gaps_ms[len(gaps_ms) // 2], 1),
        "p99_drain_gap_ms": round(gaps_ms[int(len(gaps_ms) * 0.99)
                                          if len(gaps_ms) > 1 else 0], 1),
    }
