#!/usr/bin/env python3
"""End-to-end smoke test of emspec on one NVIDIA GPU.

Drives the product's own entry points at deployment widths on the card
and checks what comes out against the float64 oracle (tests/oracle.py):

  device     the default JAX device must be a GPU — there is no CPU
             fallback; prints the card's name and power limit
  render     ``emspec render`` on 16 s of seeded synthetic 48 kHz audio:
             natural 2048, enhanced 8192 and the multires display default
             (8192/2048/512 banks, 512 rows, hop 128); ``render --channel
             all`` on the 16-channel 96 kHz 32768-pt stress deployment
             (8 s).  Each analysis is compared with the oracle on a cut of
             the same signal (DESIGN.md §9 tolerances)
  stream     4 s through ``Stream.push`` hop by hop + ``flush`` at the
             multires default and at 8192, compared with the batch path
             on the same card (DESIGN.md §5 GPU bound)
  live       the live app (EmSpecApp + synthetic capture thread) for ~5 s;
             keep-up is printed as information
  gpu-tests  the pytest cases marked ``gpu`` (tests/test_gpu.py)

Options:
  --engines     instead of the phases above: time both sides of every
                engine choice in emspec/engine.py (warmed, each call ended
                by block_until_ready; medians with sample counts)
  --four-cards  instead: the multi-card paths over 4 GPUs (channel-sharded
                stress batch + streaming with global AGC, a time-sharded
                16 s multires render, the 2 x 2 (ch x t) composed render),
                each compared with card 0 alone
  --seed N      seed of the synthetic signals (default 0)

Every number is printed beside the card's name and power limit.  The
last line is ``{"ok": true, "device": {...}}`` only if every check
passed; otherwise the exit code is 1 and no such line is printed.

Usage: python chip_smoke.py [--engines | --four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# DESIGN.md §9: float32 rFFT error grows ~√N·ε
POWER_TOL = 2e-5          # × √(N/512), relative to peak
DB_TOL = 0.05             # dB, cells within the top 60 dB
ENERGY_TOL = 2e-3         # relative total-energy error of a scatter
MAXF_TOL = 2e-2           # 3×3 max-filtered scatter, relative to peak
# DESIGN.md §5, the GPU streaming ≡ batch contract (also the multi-card ≡
# card-0 contract): display values agree within VIS_TOL and RGBA within
# one quantum on all but OFF_SHARE of the cells.  A deposit whose Δt or f̂
# sits on a rounding boundary may land one cell over in one of the two
# programs (float sums differ in the last bits); such cells are rare and
# are what OFF_SHARE allows.
VIS_TOL = 1e-5
OFF_SHARE = 1e-3


# --------------------------------------------------------------- checks
class Checks:
    """Collects pass/fail per check; every failure is printed when it
    happens and the run exits non-zero at the end."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, name: str, ok: bool, detail: str = "") -> bool:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)
        return ok


def max_filter3(a: np.ndarray) -> np.ndarray:
    """3×3 maximum filter over the last two axes (edges replicate)."""
    pad = [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)]
    p = np.pad(a, pad, mode="edge")
    h, w = a.shape[-2:]
    return np.max([p[..., i:i + h, j:j + w]
                   for i in range(3) for j in range(3)], axis=0)


def compare_power(got, want, n: int, scatter: bool) -> tuple[bool, str]:
    """A (t, rows) power grid against the oracle's, by DESIGN.md §9.

    Plain spectra: max error ≤ POWER_TOL·√(n/512) of peak and ≤ DB_TOL dB
    in the top 60 dB.  Scattered (reassigned) grids: total energy within
    ENERGY_TOL and the 3×3 max-filtered grids within MAXF_TOL of peak — a
    rounding flip legitimately moves a whole deposit one cell."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False, f"shape {got.shape} != oracle {want.shape}"
    scale = float(want.max())
    if not scale > 0:
        return False, "oracle grid is empty"
    if scatter:
        e = abs(got.sum() - want.sum()) / want.sum()
        m = float(np.max(np.abs(max_filter3(got) - max_filter3(want)))) / scale
        return (e <= ENERGY_TOL and m <= MAXF_TOL,
                f"energy rel err {e:.3e} (tol {ENERGY_TOL:g}), 3x3 max-filter "
                f"err {m:.3e} of peak (tol {MAXF_TOL:g})")
    tol = POWER_TOL * np.sqrt(n / 512.0)
    err = float(np.max(np.abs(got - want))) / scale
    mask = want / scale > 1e-6
    db = float(np.max(np.abs(
        10 * np.log10(np.maximum(got[mask], 1e-30) / scale)
        - 10 * np.log10(want[mask] / scale))))
    return (err <= tol and db < DB_TOL,
            f"max err {err:.3e} of peak (tol {tol:.2e}), "
            f"{db:.4f} dB in top 60 dB (tol {DB_TOL})")


def compare_display(vis_a, rgba_a, vis_b, rgba_b) -> tuple[bool, str]:
    """Two renders of the same columns by DESIGN.md §5's GPU bound."""
    vis_a, vis_b = np.asarray(vis_a, np.float64), np.asarray(vis_b, np.float64)
    if vis_a.shape != vis_b.shape:
        return False, f"shape {vis_a.shape} != {vis_b.shape}"
    dv = np.abs(vis_a - vis_b)
    vis_off = float(np.mean(dv > VIS_TOL))
    dq = np.abs(np.asarray(rgba_a, np.int16) - np.asarray(rgba_b, np.int16))
    rgba_off = float(np.mean(dq.max(axis=-1) > 1))
    return (vis_off <= OFF_SHARE and rgba_off <= OFF_SHARE,
            f"max |dvis| {dv.max():.3e}, cells with |dvis| > {VIS_TOL:g}: "
            f"{vis_off:.2e}; RGBA max diff {int(dq.max())}, cells >1 "
            f"quantum {rgba_off:.2e} (each tol {OFF_SHARE:g} of "
            f"{dv.size} cells)")


# ------------------------------------------------------------ inputs
def signal(seconds: float, sr: int, seed: int, channels: int = 1):
    """Seeded synthetic audio: chirp + multitone + noise (io/synth)."""
    from emspec.io import synth
    x = (synth.chirp(80.0, 0.4 * sr, seconds, sr, amplitude=0.4)
         + synth.multitone([110.0, 440.0, 1320.0, 5000.0], seconds, sr,
                           amplitude=0.4)
         + synth.noise(seconds, sr, amplitude=0.01, seed=seed))
    if channels == 1:
        return x.astype(np.float32)
    return np.stack([np.roll(x, 977 * c) * (1.0 - 0.02 * c)
                     for c in range(channels)]).astype(np.float32)


def timed_ms(call, iters: int) -> list[float]:
    """Warm once (compiles), then time ``iters`` calls, each ended by
    ``block_until_ready``."""
    import jax
    jax.block_until_ready(call())
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def med(ms: list[float]) -> str:
    return f"median {np.median(ms):.3f} ms (n={len(ms)})"


# ------------------------------------------------------------- phases
def nvidia_smi() -> str:
    """``name, power.limit`` of the card, read by a child process that
    never touches JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc {r.returncode}): "
                           f"{r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def phase_device(count: int) -> dict:
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU — JAX's default device is {d.platform} "
            f"({d.device_kind}); this smoke test runs on the GPU only")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, JAX sees "
                         f"{len(devs)}")
    card = nvidia_smi()
    print(card)
    print(f"device: {d.platform} {d.device_kind} x{len(devs)} | "
          f"card: {card} | jax {jax.__version__} | "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": count, "card": card}


def phase_render(chk: Checks, seed: int, card: str,
                 seconds: float = 16.0, stress_seconds: float = 8.0,
                 stress_channels: int = 16, cut: dict | None = None) -> None:
    """CLI renders at the deployment shapes + oracle comparisons."""
    import jax.numpy as jnp

    import oracle
    from emspec.__main__ import main as cli
    from emspec.config import Settings
    from emspec.dsp.reassign import reassigned_spectrogram
    from emspec.dsp.stft import power_spectrogram
    from emspec.io.wav import read_wav, write_wav
    from emspec.render.png import read_png

    # seconds of the signal the host oracle re-analyzes per config (its
    # reassignment is a Python loop over every (frame, bin))
    cut = cut or {"natural_2048": 16.0, "enhanced_8192": 4.0,
                  "multires": 0.6, "stress": 1.0}
    sr = 48_000
    x = signal(seconds, sr, seed)
    print(f"render: {seconds:g} s at {sr} Hz, seed {seed}, float32 "
          f"(rfft: cuFFT) | card: {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="emspec_smoke_") as tmp:
        wav = os.path.join(tmp, "in.wav")
        write_wav(wav, x, sr)
        xq = read_wav(wav)[0][0]                       # what render reads
        for name, flags, n in (
                ("natural_2048", ["--mode", "natural", "--fft-size", "2048",
                                  "--no-multires"], 2048),
                ("enhanced_8192", ["--fft-size", "8192", "--no-multires"],
                 8192),
                ("multires", ["--multires"], 8192)):
            png = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            rc = cli(["render", wav, png] + flags)
            wall = time.perf_counter() - t0
            img = read_png(png) if rc == 0 else None
            chk(f"render {name}", rc == 0 and img is not None
                and img.any(),
                f"rc {rc}, image {None if img is None else img.shape}, "
                f"{wall:.2f} s wall incl. compile")

        # --- oracle comparisons of what each render analyzed
        xc = xq[:int(cut["natural_2048"] * sr)]
        got = power_spectrogram(jnp.asarray(xc), 2048, 512)
        ok, msg = compare_power(got, oracle.power_spectrogram(xc, 2048, 512),
                                2048, scatter=False)
        chk("oracle natural_2048 (linear raster)", ok, msg)

        xc = xq[:int(cut["enhanced_8192"] * sr)]
        got = reassigned_spectrogram(jnp.asarray(xc), 8192, 2048)
        ok, msg = compare_power(
            got, oracle.reassigned_spectrogram(xc, 8192, 2048, 1e-12),
            8192, scatter=True)
        chk("oracle enhanced_8192 (linear raster)", ok, msg)

        for mode in ("natural", "enhanced"):
            s = Settings(mode=mode, multires=True)
            _pipeline_vs_oracle(chk, s, xq[:int(cut["multires"] * sr)],
                                f"multires {mode}")
        _batch_report(Settings(mode="enhanced", multires=True), xq, card,
                      "multires 16 s")

        # --- the stress deployment: 16 ch x 96 kHz x 32768, tiled render
        sr2 = 96_000
        xs = signal(stress_seconds, sr2, seed + 1, stress_channels)
        wav2 = os.path.join(tmp, "stress.wav")
        write_wav(wav2, xs, sr2)
        xs = read_wav(wav2)[0]
        png = os.path.join(tmp, "stress.png")
        t0 = time.perf_counter()
        rc = cli(["render", wav2, png, "--channel", "all", "--fft-size",
                  "32768", "--no-multires"])
        wall = time.perf_counter() - t0
        img = read_png(png) if rc == 0 else None
        chk("render stress --channel all", rc == 0 and img is not None
            and img.any(),
            f"rc {rc}, {stress_channels} ch tiled image "
            f"{None if img is None else img.shape}, {wall:.2f} s wall "
            f"incl. compile")
        ss = Settings(mode="enhanced", multires=False, fft_size=32768,
                      sample_rate=sr2, channels=stress_channels)
        _pipeline_vs_oracle(chk, ss, xs[:, :int(cut["stress"] * sr2)],
                            "stress", channels=(0, stress_channels - 1))
        _batch_report(ss, xs, card, f"stress {stress_seconds:g} s")


def _pipeline_vs_oracle(chk: Checks, s, x, name: str,
                        channels: tuple | None = None) -> None:
    """Pipeline power on the card vs oracle.multires_* (per channel)."""
    import jax
    import jax.numpy as jnp

    import oracle
    from emspec.pipeline import Pipeline

    pipe = Pipeline(s)
    t = pipe.num_columns(x.shape[-1])
    p = pipe.params(s)
    fn = (pipe._enhanced_power if s.mode == "enhanced"
          else pipe._natural_power)
    power = np.asarray(jax.jit(fn, static_argnums=1)(jnp.asarray(x), t, p))
    ref = (oracle.multires_enhanced if s.mode == "enhanced"
           else oracle.multires_natural)
    for c in (channels or (None,)):
        xc = x if c is None else x[c]
        got = power if c is None else power[c]
        want = ref(xc, s.active_fft_sizes, s.hop_samples, s.raster_height,
                   s.sample_rate, s.freq_min, s.freq_scale,
                   s.crossover_low, s.crossover_high)
        ok, msg = compare_power(got, want, pipe.n_max,
                                scatter=s.mode == "enhanced")
        chk(f"oracle {name}" + ("" if c is None else f" ch{c}"), ok,
            f"t={t}, rows={pipe.rows}: {msg}")

    # the whole product step, Pipeline.process: finite, in range, uint8
    vis, rgba, st = pipe.process(x, params=p)
    vis = np.asarray(vis)
    chk(f"process {name}", vis.shape[0] == t and np.isfinite(vis).all()
        and 0.0 <= vis.min() and vis.max() <= 1.0
        and np.asarray(rgba).dtype == np.uint8
        and np.isfinite(np.asarray(st.agc_ref)).all(),
        f"vis {vis.shape} in [{vis.min():.3f}, {vis.max():.3f}]")


def _batch_report(s, x, card: str, name: str) -> None:
    """Warmed batch-step time and ``memory_analysis`` of the compiled
    step (information, not a check)."""
    import jax
    from emspec.pipeline import Pipeline
    from emspec.post.chain import PostState

    pipe = Pipeline(s)
    t = pipe.num_columns(x.shape[-1])
    p = pipe.params(s)
    st = PostState.init(x.shape[:-1] + (pipe.rows,))
    xd = jax.device_put(x)
    mem = pipe._batch_jit.lower(xd, p, st, t_count=t).compile() \
        .memory_analysis()
    if mem is not None:
        print(f"  memory_analysis {name}: args "
              f"{mem.argument_size_in_bytes / 2**20:.1f} MiB, out "
              f"{mem.output_size_in_bytes / 2**20:.1f} MiB, temp "
              f"{mem.temp_size_in_bytes / 2**20:.1f} MiB")
    ms = timed_ms(lambda: pipe._batch_jit(xd, p, st, t), 10)
    print(f"  batch step {name}: t={t}, {med(ms)}, "
          f"{t / np.median(ms) * 1e3:.0f} columns/s | card: {card}",
          flush=True)


def phase_stream(chk: Checks, seed: int, card: str,
                 seconds: float = 4.0) -> None:
    """Hop-by-hop Stream vs the batch path on the same card."""
    from emspec.config import Settings
    from emspec.pipeline import get_pipeline
    from emspec.stream import Stream

    print(f"stream: {seconds:g} s pushed hop by hop | card: {card}",
          flush=True)
    for name, s in (("multires", Settings(mode="enhanced", multires=True)),
                    ("8192", Settings(mode="enhanced", multires=False,
                                      fft_size=8192))):
        x = signal(seconds, s.sample_rate, seed + 2)
        st = Stream(s)
        hop = st.pipe.hop
        cols = []
        t0 = time.perf_counter()
        for i in range(0, x.shape[-1], hop):
            cols.extend(st.push(x[i:i + hop]))
        cols.extend(st.flush())
        import jax
        import jax.numpy as jnp
        cols.sort(key=lambda c: c.index)
        vis_s = jnp.stack([c.vis for c in cols])
        rgba_s = jnp.stack([c.rgba for c in cols])
        jax.block_until_ready((vis_s, rgba_s))
        wall = time.perf_counter() - t0
        pipe = get_pipeline(s)
        vis_b, rgba_b, _ = pipe.process(x, params=pipe.params(s))
        ok, msg = compare_display(vis_s, rgba_s, vis_b, rgba_b)
        ok = ok and [c.index for c in cols] == list(range(len(cols)))
        chk(f"stream == batch {name}", ok,
            f"{len(cols)} columns, {wall:.2f} s wall incl. compile; {msg}")


def phase_live(chk: Checks, card: str, seconds: float = 5.0) -> None:
    from emspec.bench.harness import sustained_display
    from emspec.config import Settings

    with tempfile.TemporaryDirectory(prefix="emspec_live_") as ud:
        rep = sustained_display(Settings(mode="enhanced", multires=True),
                                seconds=seconds, user_dir=ud)
    print(f"live (information, not a claim): {json.dumps(rep)} | "
          f"card: {card}", flush=True)
    chk("live app emits columns", rep["emitted_cols"] > 0,
        f"{rep['emitted_cols']} columns, keep-up {rep['keepup_ratio']}")


def phase_gpu_tests(chk: Checks) -> None:
    """The ``gpu``-marked pytest cases, in this process (one process per
    card)."""
    import pytest
    os.environ["JAX_PLATFORMS"] = "cuda"        # tests/conftest.py: keep GPU
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests" / "test_gpu.py")])
    chk("pytest -m gpu", int(rc) == 0, f"rc {int(rc)}")


# ------------------------------------------------------------ engines
def phase_engines(card: str, seed: int) -> None:
    """Both sides of every engine choice, timed on the card."""
    import jax
    import jax.numpy as jnp

    from emspec.config import Settings
    from emspec.dsp.frame import frame_signal
    from emspec.dsp.stft import stft_raw_pair
    from emspec.pipeline import Pipeline
    from emspec.post.chain import PostState, _ema_scan, postprocess_batch

    rng = np.random.default_rng(seed)
    tag = f"| card: {card}"

    print("engines: EMA recurrences (sequential lax.scan vs associative)")
    s0 = Settings(mode="enhanced", multires=True)
    post = Pipeline(s0).params().post
    for t in (90, 372, 1437, 5937):
        for name, shape, alpha in (("agc_ref", (t,), 0.99),
                                   ("smoothing", (t, 512), 0.4)):
            xs = jnp.asarray(rng.standard_normal(shape), jnp.float32)
            y0 = jnp.zeros(shape[1:], jnp.float32)
            r = {}
            for assoc in (False, True):
                f = jax.jit(lambda xs, a=assoc: _ema_scan(y0, alpha, xs, a))
                r[assoc] = timed_ms(lambda: f(xs), 30)
            print(f"  {name} t={t}: sequential {med(r[False])}, "
                  f"associative {med(r[True])} {tag}")
        pw = jnp.asarray(rng.random((t, 512)), jnp.float32)
        st = PostState.init((512,))
        r = {}
        for assoc in (False, True):
            f = jax.jit(lambda pw, a=assoc: postprocess_batch(
                pw, st, post, associative=a))
            r[assoc] = timed_ms(lambda: f(pw), 30)
        print(f"  postprocess_batch t={t}x512: sequential {med(r[False])}, "
              f"associative {med(r[True])} {tag}")

    print("engines: EMA choice end to end (multires batch step)")
    for secs in (4.0, 16.0):
        xm = signal(secs, 48_000, seed)
        for assoc in (False, True):
            _forced_step(s0, xm, assoc, f"multires {secs:g} s "
                         f"[{'associative' if assoc else 'sequential'} EMA]",
                         tag)

    print("engines: four-step matmul FFT vs rfft (fft_impl)")
    for n, sr_, ch, secs in ((8192, 48_000, 1, 16.0),
                             (32768, 96_000, 16, 8.0)):
        x = signal(secs, sr_, seed, ch)
        fr = frame_signal(jnp.asarray(x), n, n // 4)
        for impl in ("xla", "fourstep"):
            f = jax.jit(lambda fr, i=impl: stft_raw_pair(fr, i))
            print(f"  stft_raw_pair n={n} frames {fr.shape}: {impl} "
                  f"{med(timed_ms(lambda: f(fr), 20))} {tag}")
        for impl in ("xla", "fourstep"):
            s = Settings(mode="enhanced", multires=False, fft_size=n,
                         sample_rate=sr_, channels=ch, fft_impl=impl)
            _forced_step(s, x, None, f"batch step n={n} ch={ch} "
                         f"fft_impl={impl}", tag)

    print("engines: reassignment scatter (XLA scatter-add) share of the "
          "enhanced step")
    for n, sr_, ch, secs in ((8192, 48_000, 1, 16.0),
                             (32768, 96_000, 16, 8.0),
                             (None, 48_000, 1, 16.0)):
        s = (Settings(mode="enhanced", multires=True) if n is None else
             Settings(mode="enhanced", multires=False, fft_size=n,
                      sample_rate=sr_, channels=ch))
        x = jnp.asarray(signal(secs, sr_, seed, ch))
        pipe = Pipeline(s)
        t = pipe.num_columns(x.shape[-1])
        p = pipe.params()
        lead = x.shape[:-1]
        dep = jax.jit(lambda x: pipe._deposits(pipe._bank_frames(x, t), p))
        rows_i, delta, contrib = jax.block_until_ready(dep(x))
        sc = jax.jit(lambda r, d, c: pipe._scatter_segment_sum(
            r, d, c, t, lead))
        ms_sc = timed_ms(lambda: sc(rows_i, delta, contrib), 20)
        stp = PostState.init(lead + (pipe.rows,))
        ms_all = timed_ms(lambda: pipe._batch_jit(x, p, stp, t), 20)
        label = "multires" if n is None else f"n={n} ch={ch}"
        print(f"  {label} t={t}, {contrib.size} deposits: scatter alone "
              f"{med(ms_sc)}; whole step {med(ms_all)}; share "
              f"{np.median(ms_sc) / np.median(ms_all):.2f} {tag}")
        _trace_share(pipe, x, p, stp, t, label, tag)


def _forced_step(s, x, assoc, label, tag) -> None:
    """Warmed batch-step time, with the EMA choice forced unless None."""
    import jax
    from emspec import engine
    from emspec.pipeline import Pipeline
    from emspec.post.chain import PostState

    saved = engine.associative_ema
    try:
        if assoc is not None:
            engine.associative_ema = lambda v=assoc: v
        pipe = Pipeline(s)
        t = pipe.num_columns(x.shape[-1])
        p = pipe.params()
        st = PostState.init(x.shape[:-1] + (pipe.rows,))
        xd = jax.device_put(x)
        ms = timed_ms(lambda: pipe._batch_jit(xd, p, st, t), 20)
    finally:
        engine.associative_ema = saved
    print(f"  {label}: t={t}, {med(ms)}, "
          f"{t / np.median(ms) * 1e3:.0f} columns/s {tag}", flush=True)


def _trace_share(pipe, x, p, st, t, label: str, tag: str) -> None:
    """Profile 5 warmed batch steps; sum the GPU's kernel time by name
    and report the share of scatter kernels (the trace is read and
    deleted)."""
    import jax
    jax.block_until_ready(pipe._batch_jit(x, p, st, t))
    with tempfile.TemporaryDirectory(prefix="emspec_trace_") as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(5):
                jax.block_until_ready(pipe._batch_jit(x, p, st, t))
        pb = sorted(Path(tmp).rglob("*.xplane.pb"))
        prof = jax.profiler.ProfileData.from_file(str(pb[-1]))
        totals: dict = {}
        for plane in prof.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration_ns
    busy = sum(totals.values())
    scat = sum(v for k, v in totals.items() if "scatter" in k.lower())
    print(f"  trace {label}: GPU stream time {busy / 5e6:.3f} ms/step, "
          f"scatter kernels {scat / 5e6:.3f} ms/step (share "
          f"{scat / max(busy, 1):.2f}) {tag}")
    for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {v / 5e6:8.3f} ms/step  {k[:100]}")


# --------------------------------------------------------- four cards
def phase_four_cards(chk: Checks, seed: int, card: str,
                     stress_seconds: float = 8.0, mr_seconds: float = 16.0,
                     stress_channels: int = 16) -> None:
    """The multi-card paths over 4 devices vs device 0 alone."""
    import jax

    from emspec.config import Settings
    from emspec.parallel import (ShardedPipeline, ShardedStream,
                                 TimeParallelRenderer, ch_time_mesh,
                                 channel_mesh)
    from emspec.pipeline import Pipeline

    devs = jax.devices()[:4]
    n_dev = len(devs)
    tag = f"| card: {card}"

    def shards(arr, want, what):
        shapes = {sh.data.shape for sh in arr.addressable_shards}
        devset = {sh.device for sh in arr.addressable_shards}
        return chk(f"shards {what}", shapes == {want}
                   and len(devset) == n_dev,
                   f"per-device {sorted(shapes)} on {len(devset)} devices "
                   f"(want {want} on {n_dev})")

    # 1. channel-sharded stress deployment with global AGC: batch
    sr2 = 96_000
    s = Settings(mode="enhanced", multires=False, fft_size=32768,
                 sample_rate=sr2, channels=stress_channels, agc_global=True)
    x = signal(stress_seconds, sr2, seed + 1, stress_channels)
    per = stress_channels // n_dev
    mesh = channel_mesh(devs)
    sp = ShardedPipeline(s, mesh)
    t0 = time.perf_counter()
    vis, rgba, st = sp.process(x)
    jax.block_until_ready((vis, rgba, st))
    wall = time.perf_counter() - t0
    vis1, rgba1, st1 = Pipeline(s).process(x)
    ok, msg = compare_display(vis, rgba, vis1, rgba1)
    refs = np.asarray(st.agc_ref)
    chk("4-card stress batch == card 0", ok and np.allclose(refs, refs[0]),
        f"{wall:.2f} s wall incl. compile; {msg}; agc_ref spread "
        f"{np.ptp(refs):.2e} {tag}")
    t = vis.shape[0]
    shards(vis, (t, per, s.raster_height), "stress vis")
    shards(st.smooth, (per, s.raster_height), "stress post state")
    ms = timed_ms(lambda: sp.process(x), 5)
    print(f"  4-card stress batch: t={t}, {med(ms)} (host input incl.) {tag}")

    # 1b. the same deployment streaming over the mesh
    pipe = Pipeline(s)
    n_max, hop = pipe.n_max, pipe.hop
    sst = ShardedStream(s, mesh)
    sst.reset_window(x[:, :n_max])
    outs = {}
    total = t + pipe.reach
    for k in range(total):
        if k < t:
            block = x[:, k * hop + n_max - hop:k * hop + n_max]
        else:
            if k == t:
                sst.reset_window(None)
            block = np.zeros((stress_channels, hop), np.float32)
        o = sst.step(block)
        if o is not None:
            outs[int(o[0])] = o
    ok = sorted(outs) == list(range(t))
    if ok:
        v_s = np.stack([np.asarray(outs[i][1]) for i in range(t)])
        r_s = np.stack([np.asarray(outs[i][2]) for i in range(t)])
        ok, msg = compare_display(v_s, r_s, vis1, rgba1)
        shards(outs[t - 1][1], (per, s.raster_height), "stress stream column")
    else:
        msg = f"emitted columns {sorted(outs)[:5]}… of {t}"
    chk("4-card stress stream == card-0 batch", ok, f"{msg} {tag}")

    # 2. time-sharded 16 s multires render
    s2 = Settings(mode="enhanced", multires=True)
    x2 = signal(mr_seconds, s2.sample_rate, seed)
    tpr = TimeParallelRenderer(s2, channel_mesh(devs, axis="t"))
    t0 = time.perf_counter()
    v2, r2, st2 = tpr.render(x2)
    jax.block_until_ready((v2, r2, st2))
    wall = time.perf_counter() - t0
    bv2, br2, bst2 = Pipeline(s2).process(x2)
    ok, msg = compare_display(v2, r2, bv2, br2)
    chk("4-card time-sharded multires == card 0", ok,
        f"t={v2.shape[0]}, {wall:.2f} s wall incl. compile; {msg} {tag}")
    chk("time-sharded output spans the mesh",
        len(v2.sharding.device_set) == n_dev,
        f"{len(v2.sharding.device_set)} devices")
    pipe2 = Pipeline(s2)
    ms = timed_ms(lambda: tpr.render(x2), 5)
    ms1 = timed_ms(lambda: pipe2.process(x2), 5)
    print(f"  time-sharded multires {mr_seconds:g} s: 4 cards {med(ms)}, "
          f"card 0 alone {med(ms1)} (host input incl.) {tag}")

    # 3. (2 x 2) ch x t composed render, global AGC
    s3 = Settings(mode="enhanced", multires=True, channels=4,
                  agc_global=True)
    x3 = signal(mr_seconds / 4, s3.sample_rate, seed + 3, 4)
    r3 = TimeParallelRenderer(s3, ch_time_mesh(2, devices=devs))
    v3, rg3, st3 = r3.render(x3)
    jax.block_until_ready((v3, rg3, st3))
    bv3, br3, bst3 = Pipeline(s3).process(x3)
    ok, msg = compare_display(v3, rg3, bv3, br3)
    chk("4-card (2x2) ch x t render == card 0", ok, f"{msg} {tag}")
    shards(st3.smooth, (2, s3.raster_height), "(ch x t) final state")


# --------------------------------------------------------------- main
def _cache_counter() -> dict:
    """Counts JAX's persistent-compilation-cache hits and misses."""
    from jax._src import monitoring
    counts = {"cache_hits": 0, "cache_misses": 0}

    def listen(event, **kw):
        key = event.rsplit("/", 1)[-1]
        if key in counts:
            counts[key] += 1

    monitoring.register_event_listener(listen)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--engines", action="store_true")
    mode.add_argument("--four-cards", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))             # the oracle
    from emspec.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    counts = _cache_counter()
    count = 4 if args.four_cards else 1
    dev = phase_device(count)
    card = dev["card"]
    chk = Checks()
    t0 = time.perf_counter()
    if args.engines:
        phase_engines(card, args.seed)
    elif args.four_cards:
        phase_four_cards(chk, args.seed, card)
    else:
        phase_render(chk, args.seed, card)
        phase_stream(chk, args.seed, card)
        phase_live(chk, card)
        phase_gpu_tests(chk)
    print(f"compile cache: {cache_dir}: {counts['cache_hits']} hits, "
          f"{counts['cache_misses']} misses; total "
          f"{time.perf_counter() - t0:.1f} s | card: {card}")
    if chk.failed:
        print(f"chip_smoke: FAILED: {', '.join(chk.failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
