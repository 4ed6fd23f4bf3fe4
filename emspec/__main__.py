"""Command-line surface: ``python -m emspec <cmd>``.

The reference is a GUI app (README.md:35-39); the rebuild's human-facing
surface is this CLI over the same settings API — render a WAV to a PNG
spectrogram, stream it hop-by-hop, inspect a frequency, list presets.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


class UsageError(ValueError):
    """A user-input mistake that should surface as one stderr line + rc 2.

    Only this type is swallowed by main()'s boundary — an arbitrary
    ValueError raised deep in the pipeline/jax keeps its traceback
    (round-3 advisor finding: the blanket ``except ValueError`` hid
    genuine bugs behind a fake usage error)."""


def _add_settings_args(p: argparse.ArgumentParser) -> None:
    from emspec.config import COLORMAPS, FFT_SIZES
    p.add_argument("--fft-size", type=int, default=4096, choices=FFT_SIZES)
    p.add_argument("--mode", choices=["enhanced", "natural"], default="enhanced")
    p.add_argument("--colormap", choices=COLORMAPS, default="inferno")
    p.add_argument("--db-range", type=float, default=58.0)
    p.add_argument("--gain", type=float, default=3.5)
    p.add_argument("--brightness", type=float, default=0.44)
    p.add_argument("--noise-gate-db", type=float, default=-65.0)
    p.add_argument("--agc-strength", type=float, default=1.0)
    p.add_argument("--no-auto-gain", action="store_true")
    p.add_argument("--smoothing", type=float, default=0.0)
    p.add_argument("--low-end-boost", type=float, default=3.9)
    p.add_argument("--freq-scale", type=float, default=1.0)
    p.add_argument("--multires", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="enhanced low-end: 8192/2048/512 banks on a "
                        "log-frequency axis (default: off for render, on "
                        "for stream/live; --no-multires to force off)")
    p.add_argument("--hop", type=int, default=0, help="hop in samples (0 = fft_size/4)")


def _read_wav_cli(path):
    """Decode a CLI-supplied WAV, converting decoder rejections (not a
    RIFF/WAVE file, unsupported bit depth, truncated data — all user
    input) into the one-line UsageError contract instead of a
    traceback."""
    from emspec.io.wav import read_wav
    try:
        return read_wav(path)
    except ValueError as e:
        raise UsageError(str(e)) from None


def _pick_channel(audio, channel) -> int:
    """Validate a --channel index against the decoded audio: a clear
    usage error (via main()'s UsageError boundary), not an IndexError
    traceback."""
    try:
        c = int(channel)
    except ValueError:
        raise UsageError(
            f"--channel must be an integer or 'all', got {channel!r}") \
            from None
    if not 0 <= c < audio.shape[0]:
        raise UsageError(
            f"--channel {c} out of range: the file has {audio.shape[0]} "
            f"channel(s) (0..{audio.shape[0] - 1}, or 'all')")
    return c


def _settings_from(args, sample_rate: int, channels: int = 1,
                   multires_default: bool = False):
    from emspec.config import Settings
    multires = (args.multires if args.multires is not None
                else multires_default)
    try:
        return Settings(
            fft_size=args.fft_size, mode=args.mode, colormap=args.colormap,
            db_range=args.db_range, gain=args.gain, brightness=args.brightness,
            noise_gate_db=args.noise_gate_db, agc_strength=args.agc_strength,
            auto_gain=not args.no_auto_gain, smoothing=args.smoothing,
            low_end_boost=args.low_end_boost, freq_scale=args.freq_scale,
            multires=multires, hop=args.hop,
            sample_rate=sample_rate, channels=channels,
        )
    except ValueError as e:
        # Settings validation of CLI flag values is user input
        raise UsageError(str(e)) from None


def cmd_render(args) -> int:
    from emspec.render.png import tile_images, write_png

    audio, rate = _read_wav_cli(args.input)
    s = _settings_from(args, rate)
    n_need = max(s.multires_sizes) if s.multires else s.fft_size
    if audio.shape[-1] < n_need:
        fix = ("--no-multires or smaller multires banks" if s.multires
               else "a smaller --fft-size")
        print(f"error: {args.input} has {audio.shape[-1]} samples but one "
              f"{'multires window' if s.multires else 'FFT window'} needs "
              f"{n_need} — use a longer file or {fix}",
              file=sys.stderr)
        return 2
    time_parallel = getattr(args, "time_parallel", False)
    if time_parallel and not (s.multires or args.channel == "all"):
        raise UsageError(
            "--time-parallel requires the log-frequency display "
            "pipeline (--multires, or --channel all which always uses "
            "it); the linear-axis offline raster is single-device")
    if args.channel == "all":
        # tiled per-channel view (log-frequency display path), one batched
        # pipeline pass over all channels
        if time_parallel:
            # compose the two seams when the device count allows it
            # (round 5): the largest n_ch dividing both the channel
            # count and the device count shards channels, the rest of
            # the mesh shards time; on one device (or indivisible
            # channels) this degrades to the pure time mesh
            import jax as _jax
            import numpy as _np
            from emspec.parallel import (TimeParallelRenderer,
                                         ch_time_mesh, channel_mesh)
            sc = s.replace(channels=audio.shape[0], display_channel=0)
            n_ch = math.gcd(audio.shape[0], len(_jax.devices()))
            mesh = (ch_time_mesh(n_ch) if n_ch > 1
                    else channel_mesh(axis="t"))
            r = TimeParallelRenderer(sc, mesh)
            _, rgba, _ = r.render(audio)
            raster = _np.asarray(rgba)            # (t, ch, rows, 4)
            imgs = [raster[:, c].transpose(1, 0, 2)[::-1]
                    for c in range(raster.shape[1])]
        else:
            from emspec.pipeline import render_images_channels
            imgs = render_images_channels(audio, s)
        img = tile_images(imgs)
        write_png(args.output, img)
        print(f"{args.output}: {img.shape[1]}x{img.shape[0]} px, "
              f"{audio.shape[0]} channels tiled, mode={s.mode}, sr={rate}")
        return 0
    x = audio[_pick_channel(audio, args.channel)]
    if time_parallel:
        # offline N-chip scaling: shard the render over the time axis
        # (emspec.parallel.TimeParallelRenderer; on one device this is
        # simply the same render through the sharded program)
        from emspec.parallel import TimeParallelRenderer, channel_mesh
        r = TimeParallelRenderer(s, channel_mesh(axis="t"))
        _, rgba, _ = r.render(x)
        import numpy as _np
        img = _np.asarray(rgba).transpose(1, 0, 2)[::-1]
    elif s.multires:
        from emspec.pipeline import render_image_multires
        img = render_image_multires(x, s)
    else:
        from emspec.render.raster import render_image
        img = render_image(x, s)
    write_png(args.output, img)
    print(f"{args.output}: {img.shape[1]}x{img.shape[0]} px, mode={s.mode}, "
          f"fft={s.fft_size}, sr={rate}")
    return 0


def cmd_export(args) -> int:
    """Export the display-ready analysis ARRAYS instead of pixels: a
    no-pickle ``.npz`` with the pre-LUT ``vis`` values in [0, 1], the
    frequency axis in Hz per row, the column (window-center) times in
    seconds, and the full Settings as JSON.  The values are the same
    quantity the PNG shows, through the identical compiled graph —
    ``apply_lut(vis)`` reproduces the render pixel-exactly (pinned by
    tests/test_cli.py), so downstream tooling gets numbers with the
    whole display contract (dB window, gate, AGC, smoothing) applied."""
    import json

    import numpy as np

    audio, rate = _read_wav_cli(args.input)
    all_ch = args.channel == "all"
    s = _settings_from(args, rate,
                       channels=audio.shape[0] if all_ch else 1)
    n_need = max(s.multires_sizes) if s.multires else s.fft_size
    if audio.shape[-1] < n_need:
        raise UsageError(
            f"{args.input} has {audio.shape[-1]} samples but one "
            f"analysis window needs {n_need}")
    if s.multires or all_ch:
        # log-frequency display pipeline — same path (and same multires
        # setting) as `render --channel all` / stream / gui, so the
        # exported arrays match the corresponding PNG exactly
        from emspec.pipeline import get_pipeline
        s = s.replace(display_channel=0)
        x = audio if all_ch else audio[_pick_channel(audio, args.channel)]
        pipe = get_pipeline(s)
        v, _, _ = pipe.process(x, params=pipe.params(s))
        vis = np.moveaxis(np.asarray(v), 0, -1)      # ([ch,] rows, t)
        freq_hz = np.asarray(pipe._axis(s.freq_scale), np.float64)
        hop, n_win = pipe.hop, pipe.n_max
    else:
        # single-bank linear-axis offline path
        from emspec.render.raster import render_vis
        x = audio[_pick_channel(audio, args.channel)]
        vis = render_vis(x, s)                       # (bins, t)
        n_win = s.fft_size
        hop = s.hop if s.hop > 0 else n_win // 4
        freq_hz = (np.arange(n_win // 2 + 1, dtype=np.float64)
                   * (rate / n_win))
    time_s = (np.arange(vis.shape[-1], dtype=np.float64) * hop
              + n_win / 2) / rate
    np.savez(args.output, vis=vis.astype(np.float32), freq_hz=freq_hz,
             time_s=time_s,
             settings_json=np.asarray(json.dumps(s.to_dict())))
    print(f"{args.output}: vis {'x'.join(map(str, vis.shape))} "
          f"({freq_hz[0]:.1f}-{freq_hz[-1]:.1f} Hz x {time_s[-1]:.2f} s), "
          f"mode={s.mode}, sr={rate}")
    return 0


def cmd_stream(args) -> int:
    """Feed a WAV through the real-time streaming path into a scrolling
    waterfall, then snapshot the waterfall to PNG.  ``--channel all``
    streams every channel through one multichannel Stream and tiles one
    waterfall per channel."""
    from emspec.post.colormap import lut
    from emspec.render.png import tile_images, write_png
    from emspec.render.waterfall import Waterfall
    from emspec.stream import Stream

    audio, rate = _read_wav_cli(args.input)
    tiled = args.channel == "all" and audio.shape[0] > 1
    nch = audio.shape[0] if tiled else 1
    s = _settings_from(args, rate, channels=nch, multires_default=True)
    stream = Stream(s)
    wfs = [Waterfall(args.width, s.raster_height, s.scroll_speed,
                     lut_table=lut(s.colormap))
           for _ in range(nch)]
    x = (audio if tiled else
         audio[0 if args.channel == "all"
               else _pick_channel(audio, args.channel)])
    n_cols = 0
    def paint(col):
        one = col.rgba.ndim == 2
        for c, wf in enumerate(wfs):
            wf.add_column(col.rgba if one else col.rgba[c],
                          col.vis if one else col.vis[c])
    for i in range(0, x.shape[-1], args.chunk):
        for col in stream.push(x[..., i:i + args.chunk]):
            paint(col)
            n_cols += 1
    for col in stream.flush():
        paint(col)
        n_cols += 1
    write_png(args.output, tile_images([wf.image() for wf in wfs]))
    print(f"{args.output}: streamed {n_cols} columns x{nch}ch "
          f"(reach={stream.reach} hops), waterfall {args.width}x{s.raster_height}")
    return 0


def cmd_doctor(args) -> int:
    """Environment self-check: one line per subsystem, ``ok``/``WARN``/
    ``FAIL``.  The production troubleshooting entry point — the JAX
    backend, the native ring, capture backends, the native-window shell
    and the update manifest reported in one place."""
    import platform

    fails = 0

    def row(status, name, detail=""):
        nonlocal fails
        fails += status == "FAIL"
        print(f"{status:<5} {name:<16} {detail}")

    from emspec import __version__
    row("ok", "emspec", f"{__version__} (python {platform.python_version()}, "
                        f"{platform.system().lower()})")

    import jax
    try:
        devs = jax.devices()
        row("ok", "jax backend", f"{jax.default_backend()} x{len(devs)} "
                                 f"({devs[0].device_kind})")
    except Exception as e:                       # no usable backend at all
        row("FAIL", "jax backend", str(e))
    row("ok", "jax version", jax.__version__)

    try:
        from emspec.native import lib as native
        ok = native.available()
    except Exception:
        ok = False
    row("ok" if ok else "WARN", "native ring",
        "C++ seqlock SPSC ring loaded" if ok else
        "numpy fallback (build: make -C emspec/native)")

    try:
        import sounddevice as sd
        n_in = sum(1 for d in sd.query_devices()
                   if d.get("max_input_channels", 0) > 0)
        row("ok", "audio capture", f"sounddevice: {n_in} input device(s)")
    except Exception:
        row("WARN", "audio capture",
            "sounddevice not installed — synthetic/WAV sources only")

    try:
        import tkinter                               # noqa: F401
        row("ok", "native window", "tkinter available (emspec gui --native)")
    except Exception:
        row("WARN", "native window", "no tkinter — web shell only")

    from emspec.utils.update import UPDATE_MANIFEST_ENV, check_for_update
    import os
    if os.environ.get(UPDATE_MANIFEST_ENV):
        note = check_for_update()
        row("ok", "update check",
            f"newer version available: {note['latest']}" if note
            else "up to date")
    else:
        row("ok", "update check", "no manifest configured (offline)")

    print(f"doctor: {'all checks passed' if fails == 0 else f'{fails} FAILURE(S)'}")
    return 1 if fails else 0


def cmd_animate(args) -> int:
    """Render the SCROLLING display itself to an animated PNG: frame k =
    the live waterfall after k/fps seconds of audio, through the real
    streaming path (emspec/render/animate.py).  The last frame is
    bit-identical to ``emspec stream``'s snapshot of the same audio."""
    from emspec.render.animate import animate_frames, frame_count
    from emspec.render.apng import write_apng

    audio, rate = _read_wav_cli(args.input)
    if not args.fps > 0:
        raise UsageError(f"--fps must be positive, got {args.fps}")
    tiled = args.channel == "all" and audio.shape[0] > 1
    nch = audio.shape[0] if tiled else 1
    s = _settings_from(args, rate, channels=nch, multires_default=True)
    x = (audio if tiled else
         audio[0 if args.channel == "all"
               else _pick_channel(audio, args.channel)])
    n_frames = frame_count(x.shape[-1], rate, args.fps)
    write_apng(args.output,
               animate_frames(x, s, fps=args.fps, width=args.width),
               fps=args.fps)
    print(f"{args.output}: {n_frames} frames @ {args.fps:g} fps x{nch}ch, "
          f"waterfall {args.width}x{s.raster_height}")
    return 0


def cmd_live(args) -> int:
    if args.capture:
        from emspec.render.terminal import live_capture_view
        s = _settings_from(args, args.sample_rate, multires_default=True)
        device = args.device
        if device is not None and device.lstrip("-").isdigit():
            device = int(device)
        n = live_capture_view(s, backend=args.backend,
                              duration=args.duration, width=args.width,
                              device=device)
        print(f"\ndisplayed {n} columns ({args.backend} capture)")
        return 0
    if not args.input:
        print("live: provide a WAV file or use --capture", file=sys.stderr)
        return 1
    from emspec.render.terminal import live_view

    audio, rate = _read_wav_cli(args.input)    # decoded once, passed through
    s = _settings_from(args, rate, multires_default=True)
    n = live_view((audio, rate), s, width=args.width, realtime=not args.fast)
    print(f"\ndisplayed {n} columns")
    return 0


def cmd_note(args) -> int:
    from emspec.utils.notes import describe_frequency
    try:
        print(describe_frequency(args.freq))
    except ValueError as e:               # e.g. freq ≤ 0: user input
        raise UsageError(str(e)) from None
    return 0


def cmd_presets(args) -> int:
    """Preset CRUD — the full reference surface (README.md:16
    "Add/Edit/Delete"): ``add``/``edit`` build a Settings bundle from the
    same flags as render/stream and persist it."""
    from emspec.config import PresetStore
    store = PresetStore(args.file)
    if args.action == "list":
        for name in store.names():
            print(name)
    elif args.action == "show":
        try:
            preset = store.get(args.name)
        except KeyError:
            raise UsageError(f"no preset named {args.name!r}") from None
        print(json.dumps(preset.to_dict(), indent=2, sort_keys=True))
    elif args.action == "delete":
        try:
            store.delete(args.name)
        except KeyError:
            raise UsageError(f"no preset named {args.name!r}") from None
        except ValueError as e:           # Default-delete guard
            raise UsageError(str(e)) from None
    elif args.action in ("add", "edit"):
        exists = args.name in store.names()
        if args.action == "add" and exists:
            print(f"preset {args.name!r} already exists (use 'edit')",
                  file=sys.stderr)
            return 1
        if args.action == "edit" and not exists:
            print(f"no preset named {args.name!r} (use 'add')", file=sys.stderr)
            return 1
        s = _settings_from(args, args.sample_rate, args.channels,
                           multires_default=True)
        store.add(args.name, s)
        print(f"{args.action}: {args.name} -> {args.file}")
    return 0


def cmd_gui(args) -> int:
    """Window shell: ``--native`` opens a real frameless always-on-top
    desktop window (tkinter); default serves the live display + settings
    panel on a local web page (reference README.md:13,35-39; degrade to
    ``emspec live`` in terminals — the raster boundary is the same)."""
    from emspec.shell import ShellServer

    source = "wav" if args.input else args.backend
    s = _settings_from(args, args.sample_rate, multires_default=True)
    # pre-compile the FFT-size dropdown in the background so flipping it
    # in the panel never stalls the display (SURVEY.md §7 hard part 3).
    # Only the reference dropdown range (≤32768): the §5.7 ext sizes are
    # the two largest compiles in the codebase and almost never selected
    # live — they compile on first use instead.
    from emspec.config import FFT_SIZES
    warm = (tuple(n for n in FFT_SIZES if n <= 32768)
            if not args.no_prewarm else None)
    if args.native:
        from emspec.shell.native import NativeUnavailable, run_native
        try:
            run_native(s, source=source, wav_path=args.input,
                       user_dir=args.user_dir, prewarm_sizes=warm)
            return 0
        except NativeUnavailable as e:
            print(f"native window unavailable ({e}); "
                  f"falling back to the web shell", file=sys.stderr)
    srv = ShellServer(s, port=args.port, source=source, wav_path=args.input,
                      user_dir=args.user_dir, prewarm_sizes=warm)
    print(f"emspec shell: http://127.0.0.1:{srv.port}/  "
          f"(source={source}, Ctrl-C to quit)")
    srv.serve_forever(duration=args.duration)
    return 0


def cmd_bench(args) -> int:
    from emspec.bench.harness import run_benchmarks, write_profiler_trace
    if args.trace:
        from emspec.config import Settings
        out = write_profiler_trace(
            Settings(mode="enhanced", multires=False, fft_size=8192),
            args.trace)
        print(f"profiler trace written to {out}")
        return 0
    if args.stages:
        # per-stage device-cost breakdown (SURVEY.md §5.5), prefix
        # timing — emspec.bench.stages
        from emspec.bench.stages import stage_breakdown
        from emspec.config import Settings
        report = {
            "8192_enhanced": stage_breakdown(
                Settings(mode="enhanced", multires=False, fft_size=8192)),
            "multires": stage_breakdown(Settings(mode="enhanced", multires=True)),
            "stress_16ch": stage_breakdown(
                Settings(mode="enhanced", multires=False, fft_size=32768,
                         sample_rate=96_000, channels=16)),
        }
        print(json.dumps(report, indent=2))
        return 0
    if args.soak:
        # long-running leak soak on the product path (L1→L4 + live shell
        # + settings/preset churn thread) — RSS/device-mem/keep-up slopes
        from emspec.bench.soak import soak
        from emspec.config import Settings
        report = soak(
            settings=Settings(mode=args.soak_mode, multires=True),
            seconds=args.duration or 600.0,
            inject_nonfinite=args.soak_inject_nonfinite)
        if args.quick:
            report.pop("raw", None)
        print(json.dumps(report, indent=2))
        return 0
    if args.sustained:
        # product-level north-star check [NS: "sustain 60 fps"]: the whole
        # L1→L4 stack against wall clock — capture thread → ring →
        # streaming step → waterfall, drained at display cadence
        from emspec.bench.harness import sustained_display
        from emspec.config import Settings
        report = {
            "default_multires": sustained_display(seconds=args.duration or 8.0),
            "north_star_32768": sustained_display(
                Settings(mode="enhanced", multires=False, fft_size=32768),
                seconds=args.duration or 8.0),
        }
        print(json.dumps(report, indent=2))
        return 0
    report = run_benchmarks(quick=args.quick)
    print(json.dumps(report, indent=2))
    return 0


def main(argv=None) -> int:
    from emspec import __version__
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        # launch-UX parity [OBS: README.md:35-36 "Launch EM-Spec; the
        # spectrogram will automatically start visualizing your system
        # audio"]: a bare launch opens the window shell on auto capture
        argv = ["gui"]
    from emspec.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="emspec",
                                 description="streaming reassigned-spectrogram framework")
    ap.add_argument("--version", action="version",
                    version=f"emspec {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a WAV file to a PNG spectrogram")
    pr.add_argument("input")
    pr.add_argument("output")
    pr.add_argument("--channel", default="0", help="channel index, or 'all' for a tiled per-channel view (always the log-frequency display path, like stream/gui; a plain single-channel render without --multires uses the linear-axis offline raster)")
    pr.add_argument("--time-parallel", action="store_true",
                    help="shard the render over the TIME axis across all "
                         "visible devices (offline N-chip scaling; "
                         "requires the --multires display pipeline)")
    _add_settings_args(pr)
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser(
        "export",
        help="export analysis arrays to .npz (pre-LUT vis values + "
             "frequency/time axes + settings JSON) instead of pixels")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--channel", default="0",
                    help="channel index, or 'all' to export every channel "
                         "(always the log-frequency display path; a plain "
                         "single-channel export without --multires uses "
                         "the linear-axis single-bank path)")
    _add_settings_args(pe)
    pe.set_defaults(fn=cmd_export)

    ps = sub.add_parser("stream", help="stream a WAV hop-by-hop into a scrolling waterfall PNG")
    ps.add_argument("input")
    ps.add_argument("output")
    ps.add_argument("--channel", default="0", help="channel index, or 'all' for a tiled per-channel view (always the log-frequency display path, like stream/gui; a plain single-channel render without --multires uses the linear-axis offline raster)")
    ps.add_argument("--chunk", type=int, default=1024, help="samples per push")
    ps.add_argument("--width", type=int, default=1024, help="waterfall columns")
    _add_settings_args(ps)
    ps.set_defaults(fn=cmd_stream)

    pd = sub.add_parser(
        "doctor",
        help="environment self-check (JAX backend, native ring, capture, "
             "window shell)")
    pd.set_defaults(fn=cmd_doctor)

    pa = sub.add_parser(
        "animate",
        help="render the scrolling waterfall itself to an animated PNG "
             "(APNG; frame k = the live display at k/fps seconds)")
    pa.add_argument("input")
    pa.add_argument("output")
    pa.add_argument("--channel", default="0",
                    help="channel index, or 'all' for a tiled per-channel "
                         "animation")
    pa.add_argument("--fps", type=float, default=30.0,
                    help="display frame rate (frames per second of audio)")
    pa.add_argument("--width", type=int, default=1024, help="waterfall columns")
    _add_settings_args(pa)
    pa.set_defaults(fn=cmd_animate)

    pl = sub.add_parser("live", help="live terminal waterfall (ANSI truecolor)")
    pl.add_argument("input", nargs="?", default=None,
                    help="WAV file (omit with --capture)")
    pl.add_argument("--width", type=int, default=512)
    pl.add_argument("--fast", action="store_true",
                    help="render as fast as possible instead of audio-rate")
    pl.add_argument("--capture", action="store_true",
                    help="visualize live captured audio instead of a file "
                         "(README.md:36 behavior)")
    pl.add_argument("--backend", choices=["auto", "sounddevice", "synthetic"],
                    default="auto", help="capture backend (auto: real device "
                                         "if sounddevice is installed, else "
                                         "synthetic test source)")
    pl.add_argument("--device", default=None,
                    help="capture device index or PortAudio name (default: "
                         "prefer a loopback/monitor input — the OS output "
                         "tap the reference visualizes — else the default "
                         "input)")
    pl.add_argument("--duration", type=float, default=10.0,
                    help="capture run time in seconds")
    pl.add_argument("--sample-rate", type=int, default=48_000)
    _add_settings_args(pl)
    pl.set_defaults(fn=cmd_live)

    pn = sub.add_parser("note", help="frequency → musical note (hover readout)")
    pn.add_argument("freq", type=float)
    pn.set_defaults(fn=cmd_note)

    pp = sub.add_parser("presets", help="preset store CRUD (Add/Edit/Delete)")
    pp.add_argument("action", choices=["list", "show", "add", "edit", "delete"])
    pp.add_argument("--name", default="Default")
    pp.add_argument("--file", default="presets.json")
    pp.add_argument("--sample-rate", type=int, default=48_000)
    pp.add_argument("--channels", type=int, default=1)
    _add_settings_args(pp)
    pp.set_defaults(fn=cmd_presets)

    pg = sub.add_parser("gui", help="window-shell analog: local web page "
                                    "with live display + settings panel")
    pg.add_argument("input", nargs="?", default=None,
                    help="WAV file to loop (default: live capture)")
    pg.add_argument("--port", type=int, default=7780)
    pg.add_argument("--backend", choices=["auto", "sounddevice", "synthetic"],
                    default="auto", help="capture backend when no WAV given")
    pg.add_argument("--duration", type=float, default=0.0,
                    help="serve for N seconds (0 = until Ctrl-C)")
    pg.add_argument("--sample-rate", type=int, default=48_000)
    pg.add_argument("--user-dir", default=".emspec",
                    help="presets + live_state.json directory")
    pg.add_argument("--native", action="store_true",
                    help="open a real frameless always-on-top desktop "
                         "window (tkinter) instead of the web page; "
                         "falls back to the web shell when headless")
    pg.add_argument("--no-prewarm", action="store_true",
                    help="skip background pre-compilation of the FFT-size "
                         "dropdown (saves memory; size changes will stall "
                         "while compiling)")
    _add_settings_args(pg)
    pg.set_defaults(fn=cmd_gui)

    pb = sub.add_parser("bench", help="run the performance harness")
    pb.add_argument("--quick", action="store_true")
    pb.add_argument("--stages", action="store_true",
                    help="per-stage device-cost breakdown instead of the "
                         "full throughput report")
    pb.add_argument("--trace", metavar="DIR", default=None,
                    help="write a jax.profiler trace of the streaming hot "
                         "loop to DIR instead of running the harness")
    pb.add_argument("--sustained", action="store_true",
                    help="wall-clock sustained-display check: real-time "
                         "capture thread → ring → streaming step → "
                         "waterfall, drained at 60 Hz (the north-star "
                         "'sustain 60 fps' as a product-level measurement)")
    pb.add_argument("--soak", action="store_true",
                    help="long leak soak: live shell + settings/preset "
                         "churn thread, tracking RSS / device memory / "
                         "keep-up drift (default 600 s; see --duration)")
    pb.add_argument("--duration", type=float, default=0.0,
                    help="seconds per --sustained or --soak run "
                         "(defaults 8 / 600)")
    pb.add_argument("--soak-mode", choices=["enhanced", "natural"],
                    default="enhanced",
                    help="display mode for the --soak run (natural is "
                         "the reference's other first-class button)")
    pb.add_argument("--soak-inject-nonfinite", action="store_true",
                    help="corrupt every 40th capture block with one "
                         "NaN/Inf sample during the soak — drives the "
                         "non-finite poisoning guard at product scale")
    pb.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        # user-facing: missing WAV/preset file is a usage error, not a
        # traceback (verify-drive finding, round 3)
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
