"""chip_smoke.py off the GPU: it must refuse to run, and its oracle and
display comparisons must hold at a tiny size."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from emspec.config import Settings
from emspec.pipeline import Pipeline

import oracle

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=env)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass


def test_chip_smoke_comparisons_pass_at_tiny_size():
    """The same comparisons chip_smoke makes on the card, here on the CPU
    at a tiny shape: plain and reassigned power vs the oracle, and the
    streaming ≡ batch display bound."""
    from emspec.stream import stream_signal

    sr = 48_000
    s = Settings(mode="enhanced", multires=True,
                 multires_sizes=(1024, 512), raster_height=64, hop=256)
    x = chip_smoke.signal(0.1, sr, seed=1)
    pipe = Pipeline(s)
    t = pipe.num_columns(len(x))
    p = pipe.params()
    for mode, fn, ref in (("enhanced", pipe._enhanced_power,
                           oracle.multires_enhanced),
                          ("natural", Pipeline(s.replace(
                              mode="natural"))._natural_power,
                           oracle.multires_natural)):
        got = np.asarray(fn(jnp.asarray(x), t, p))
        want = ref(x, s.multires_sizes, s.hop_samples, s.raster_height, sr,
                   s.freq_min, s.freq_scale, s.crossover_low,
                   s.crossover_high)
        ok, msg = chip_smoke.compare_power(got, want, pipe.n_max,
                                           scatter=mode == "enhanced")
        assert ok, (mode, msg)
    # a power grid far off the oracle fails
    ok, _ = chip_smoke.compare_power(2.0 * want, want, 1024, scatter=False)
    assert not ok
    vis_s, rgba_s = stream_signal(x, s, chunk=s.hop)
    vis_b, rgba_b, _ = pipe.process(x)
    ok, msg = chip_smoke.compare_display(vis_s, rgba_s, vis_b, rgba_b)
    assert ok, msg
    assert np.array_equal(chip_smoke.max_filter3(np.eye(3))[1], np.ones(3))
