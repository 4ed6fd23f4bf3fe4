"""CLI surface (``python -m emspec``): the human-facing command set over
the settings API, including the full preset Add/Edit/Delete contract
(reference: README.md:16)."""

import json

import numpy as np
import pytest

from emspec.__main__ import main
from emspec.io import synth
from emspec.io.wav import write_wav


def test_presets_add_edit_delete_cli(tmp_path, capsys):
    store = str(tmp_path / "presets.json")
    # add a named preset with slider values
    rc = main(["presets", "add", "--name", "Bass", "--file", store,
               "--gain", "7.5", "--fft-size", "8192", "--mode", "natural"])
    assert rc == 0
    rc = main(["presets", "list", "--file", store])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Bass" in out and "Default" in out

    # show round-trips the stored values
    main(["presets", "show", "--name", "Bass", "--file", store])
    d = json.loads(capsys.readouterr().out)
    assert d["gain"] == 7.5 and d["fft_size"] == 8192 and d["mode"] == "natural"

    # edit overwrites
    rc = main(["presets", "edit", "--name", "Bass", "--file", store,
               "--gain", "2.0"])
    assert rc == 0
    capsys.readouterr()                      # drop the edit confirmation
    main(["presets", "show", "--name", "Bass", "--file", store])
    assert json.loads(capsys.readouterr().out)["gain"] == 2.0

    # add refuses an existing name; edit refuses a missing one
    assert main(["presets", "add", "--name", "Bass", "--file", store]) == 1
    assert main(["presets", "edit", "--name", "Nope", "--file", store]) == 1

    # delete, and Default stays protected
    assert main(["presets", "delete", "--name", "Bass", "--file", store]) == 0
    main(["presets", "list", "--file", store])
    assert "Bass" not in capsys.readouterr().out
    rc = main(["presets", "delete", "--name", "Default", "--file", store])
    assert rc == 2
    assert "Default preset cannot be deleted" in capsys.readouterr().err


def test_cli_clean_errors_for_user_mistakes(tmp_path, capsys):
    """Missing files and unknown preset names are usage errors: one line
    on stderr + rc 2, never a traceback (round-3 verify-drive finding)."""
    rc = main(["render", str(tmp_path / "nope.wav"), str(tmp_path / "o.png")])
    assert rc == 2
    assert "file not found" in capsys.readouterr().err
    rc = main(["presets", "show", "--name", "Nope",
               "--file", str(tmp_path / "p.json")])
    assert rc == 2
    assert "no preset named 'Nope'" in capsys.readouterr().err
    # a corrupt/non-WAV input is user input too, not a traceback
    # (round-4 review: the UsageError narrowing had dropped decoder
    # ValueErrors from the one-line contract)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a riff file at all, definitely not audio")
    rc = main(["render", str(bad), str(tmp_path / "o.png")])
    assert rc == 2
    err = capsys.readouterr().err
    assert "error:" in err and "Traceback" not in err


def test_render_cli_rejects_bad_channel(tmp_path, capsys):
    wav = str(tmp_path / "mono.wav")
    write_wav(wav, synth.tone(440.0, 0.3), 48_000)
    rc = main(["render", wav, str(tmp_path / "o.png"),
               "--fft-size", "1024", "--channel", "5"])
    assert rc == 2
    assert "out of range" in capsys.readouterr().err
    rc = main(["render", wav, str(tmp_path / "o.png"),
               "--fft-size", "1024", "--channel", "left"])
    assert rc == 2
    assert "'all'" in capsys.readouterr().err


def test_render_cli_writes_png(tmp_path, capsys):
    wav = tmp_path / "t.wav"
    write_wav(wav, synth.tone(440.0, 0.2), 48_000)
    out = tmp_path / "out.png"
    rc = main(["render", str(wav), str(out), "--mode", "natural",
               "--fft-size", "1024", "--no-multires"])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 100


@pytest.mark.slow
def test_render_cli_all_channels_tiled(tmp_path, capsys):
    """--channel all renders every channel and tiles them into one PNG
    (VERDICT #7: multichannel output must be inspectable)."""
    wav = tmp_path / "st.wav"
    x = np.stack([np.asarray(synth.tone(440.0, 0.4)),
                  np.asarray(synth.tone(880.0, 0.4))])
    write_wav(wav, x, 48_000)
    out = tmp_path / "tiled.png"
    rc = main(["render", str(wav), str(out), "--channel", "all",
               "--mode", "enhanced", "--multires"])
    assert rc == 0
    msg = capsys.readouterr().out
    assert "2 channels tiled" in msg
    assert out.exists()


def test_stream_cli_all_channels(tmp_path, capsys):
    wav = tmp_path / "st2.wav"
    x = np.stack([np.asarray(synth.tone(300.0, 0.3)),
                  np.asarray(synth.tone(1200.0, 0.3))])
    write_wav(wav, x, 48_000)
    out = tmp_path / "wf.png"
    rc = main(["stream", str(wav), str(out), "--channel", "all",
               "--no-multires", "--fft-size", "1024", "--width", "64"])
    assert rc == 0
    assert "x2ch" in capsys.readouterr().out
    assert out.exists()


def _assert_pngs_within_one_quantum(a, b):
    """The timeshard path reassociates both f32 EMAs (affine re-basing),
    so its documented contract vs the single program is ≤1 RGBA quantum
    (test_time_parallel_render_matches_single_device), not bitwise —
    a vis value landing on a 1/255 LUT rounding boundary may flip."""
    from emspec.render.png import read_png
    ia, ib = read_png(a), read_png(b)
    assert ia.shape == ib.shape
    dq = np.abs(ia.astype(np.int16) - ib.astype(np.int16))
    assert dq.max() <= 1


@pytest.mark.slow
def test_render_cli_time_parallel(tmp_path, capsys):
    """--time-parallel routes the multires render through the
    time-sharded program (≤1 RGBA quantum vs the single program on
    however many devices are visible) and cleanly rejects the
    linear-axis raster path."""
    wav = tmp_path / "t.wav"
    write_wav(wav, synth.chirp(200.0, 6000.0, 0.4), 48_000)
    out_a = tmp_path / "a.png"
    out_b = tmp_path / "b.png"
    assert main(["render", str(wav), str(out_a), "--multires"]) == 0
    assert main(["render", str(wav), str(out_b), "--multires",
                 "--time-parallel"]) == 0
    capsys.readouterr()
    _assert_pngs_within_one_quantum(out_a, out_b)
    rc = main(["render", str(wav), str(tmp_path / "c.png"),
               "--time-parallel"])
    assert rc == 2
    assert "--multires" in capsys.readouterr().err


@pytest.mark.slow
def test_render_cli_time_parallel_all_channels(tmp_path, capsys):
    """--time-parallel composes with --channel all: channels ride
    unsharded while the TIME axis shards over devices, and the tiled
    output matches the single-program tiled render to ≤1 RGBA
    quantum."""
    wav = tmp_path / "tp2.wav"
    x = np.stack([np.asarray(synth.tone(440.0, 0.4)),
                  np.asarray(synth.chirp(200.0, 6000.0, 0.4))])
    write_wav(wav, x, 48_000)
    out_a = tmp_path / "a.png"
    out_b = tmp_path / "b.png"
    assert main(["render", str(wav), str(out_a), "--channel", "all",
                 "--multires"]) == 0
    assert main(["render", str(wav), str(out_b), "--channel", "all",
                 "--multires", "--time-parallel"]) == 0
    msg = capsys.readouterr().out
    assert "2 channels tiled" in msg
    _assert_pngs_within_one_quantum(out_a, out_b)


def test_export_cli_linear_matches_render(tmp_path, capsys):
    """``emspec export`` writes the pre-LUT vis array with its axes, and
    applying the LUT to it reproduces ``emspec render``'s PNG
    pixel-exactly — arrays and pixels are one display contract."""
    from emspec.post.colormap import apply_lut, lut
    from emspec.render.png import read_png

    wav = tmp_path / "e.wav"
    write_wav(wav, synth.chirp(300.0, 9000.0, 0.5), 48_000)
    npz, png = tmp_path / "e.npz", tmp_path / "e.png"
    assert main(["export", str(wav), str(npz), "--fft-size", "2048"]) == 0
    assert main(["render", str(wav), str(png), "--fft-size", "2048"]) == 0
    z = np.load(npz, allow_pickle=False)
    vis, freq, t = z["vis"], z["freq_hz"], z["time_s"]
    assert vis.shape == (2048 // 2 + 1, len(t)) and len(freq) == vis.shape[0]
    assert vis.dtype == np.float32 and 0.0 <= vis.min() <= vis.max() <= 1.0
    assert freq[0] == 0.0 and freq[-1] == 24_000.0
    # window centers: first column analyzes x[0:N], center N/2 samples in
    assert t[0] == pytest.approx(1024 / 48_000)
    s = json.loads(str(z["settings_json"]))
    assert s["fft_size"] == 2048 and s["mode"] == "enhanced"
    rgba = np.asarray(apply_lut(vis.T, np.asarray(lut(s["colormap"]))))
    np.testing.assert_array_equal(rgba.transpose(1, 0, 2)[::-1],
                                  read_png(png))


def test_export_cli_multires_and_channels(tmp_path, capsys):
    """The display-path export: log-frequency axis (ascending, matching
    the pipeline's hover axis) for --multires, and one vis plane per
    channel for --channel all."""
    from emspec.pipeline import get_pipeline

    wav = tmp_path / "m.wav"
    x = np.stack([np.asarray(synth.tone(440.0, 0.4)),
                  np.asarray(synth.chirp(200.0, 6000.0, 0.4))])
    write_wav(wav, x, 48_000)
    npz = tmp_path / "m.npz"
    assert main(["export", str(wav), str(npz), "--multires"]) == 0
    z = np.load(npz, allow_pickle=False)
    assert z["vis"].ndim == 2 and np.all(np.diff(z["freq_hz"]) > 0)
    from emspec.config import Settings
    sc = Settings.from_dict(json.loads(str(z["settings_json"])))
    assert sc.multires           # settings_json describes the used pipeline
    pipe = get_pipeline(sc)
    np.testing.assert_allclose(z["freq_hz"], pipe._axis(sc.freq_scale))

    # --channel all follows the same multires setting as render
    # --channel all (single-bank display path by default), and the
    # per-channel vis planes reproduce render's tiles through the LUT
    from emspec.post.colormap import apply_lut, lut
    from emspec.render.png import read_png
    assert main(["export", str(wav), str(npz), "--channel", "all"]) == 0
    z = np.load(npz, allow_pickle=False)
    assert z["vis"].shape[0] == 2 and z["vis"].ndim == 3
    assert not json.loads(str(z["settings_json"]))["multires"]
    png = wav.with_suffix(".png")
    assert main(["render", str(wav), str(png), "--channel", "all"]) == 0
    table = np.asarray(lut("inferno"))
    tiles = [np.asarray(apply_lut(v.T, table)).transpose(1, 0, 2)[::-1]
             for v in z["vis"]]
    from emspec.render.png import tile_images
    np.testing.assert_array_equal(tile_images(tiles), read_png(png))

    # too-short input is a one-line usage error, not a traceback
    short = tmp_path / "s.wav"
    write_wav(short, synth.tone(440.0, 0.01), 48_000)
    assert main(["export", str(short), str(npz), "--multires"]) == 2
    assert "analysis window needs" in capsys.readouterr().err


def test_note_cli(capsys):
    assert main(["note", "440"]) == 0
    assert "A4" in capsys.readouterr().out


def test_render_cli_rejects_too_short_input(tmp_path, capsys):
    """A WAV shorter than one FFT window must fail with a clear message,
    not silently write a 0-column PNG."""
    wav = str(tmp_path / "short.wav")
    write_wav(wav, synth.tone(440.0, 0.25), 48_000)   # 12k samples
    rc = main(["render", wav, str(tmp_path / "o.png"),
               "--fft-size", "32768"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "32768" in err and "12000 samples" in err


def test_note_cli_rejects_nonpositive_frequency(capsys):
    rc = main(["note", "0"])
    assert rc == 2
    assert "positive" in capsys.readouterr().err
    rc = main(["note", "443"])
    assert rc == 0


def test_bare_invocation_defaults_to_gui(monkeypatch):
    """Launch-UX parity [OBS: README.md:35-36]: bare ``emspec`` opens the
    window shell on auto capture instead of printing argparse help."""
    import emspec.__main__ as m
    seen = {}
    monkeypatch.setattr(m, "cmd_gui", lambda args: seen.update(
        backend=args.backend, input=args.input) or 0)
    assert m.main([]) == 0
    assert seen == {"backend": "auto", "input": None}


def test_internal_valueerror_is_not_swallowed(monkeypatch, tmp_path):
    """Only UsageError becomes a one-line rc-2 message; an arbitrary
    ValueError from deep inside the pipeline keeps its traceback
    (round-3 advisor finding)."""
    import pytest

    import emspec.__main__ as m
    monkeypatch.setattr(
        m, "cmd_render",
        lambda args: (_ for _ in ()).throw(ValueError("internal bug")))
    # rebuild dispatch: set_defaults reads the module global at parse time
    with pytest.raises(ValueError, match="internal bug"):
        m.main(["render", "a.wav", "b.png"])


def test_doctor_cli(capsys):
    """`emspec doctor` is the troubleshooting entry point: one
    ok/WARN/FAIL line per subsystem, rc 0 when nothing is broken."""
    rc = main(["doctor"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "jax backend" in out and "jax version" in out
    assert "native ring" in out and "update check" in out
    assert "doctor: all checks passed" in out
