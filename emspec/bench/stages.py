"""Per-stage timing breakdown (SURVEY.md §5.5: "per-stage μs").

Times cumulative pipeline prefixes (framing → FFT+corrections → scatter →
post chain → LUT) as separately-jitted functions and reports the
differences.  Prefix-timing measures each stage *with fusion context*
rather than in isolation, which is what actually matters under XLA.
Bench-mode only — every call is warmed and fenced with
``block_until_ready``; a GPU is required.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from emspec.config import MODE_ENHANCED, Settings
from emspec.pipeline import Pipeline
from emspec.post.chain import PostState, postprocess_batch
from emspec.post.colormap import apply_lut


def stage_breakdown(settings: Settings, seconds: float = 4.0) -> dict:
    from emspec.bench.harness import _signal, _timed_ms, require_gpu

    require_gpu()
    pipe = Pipeline(settings)
    ch = settings.channels
    x = _signal(seconds, settings.sample_rate, ch)
    if ch == 1 and x.ndim > 1:
        x = x[0]
    t_count = pipe.num_columns(x.shape[-1])
    p = pipe.params()
    lead = (ch,) if ch > 1 else ()
    st = PostState.init(lead + (pipe.rows,))
    xd = jax.device_put(x)

    def upto_frames(x):
        return tuple(pipe._bank_frames(x, t_count))

    def upto_deposits(x):
        return pipe._deposits(pipe._bank_frames(x, t_count), p)

    def upto_power(x):
        if settings.mode == MODE_ENHANCED:
            return pipe._enhanced_power(x, t_count, p)
        return pipe._natural_power(x, t_count, p)

    def upto_post(x, st):
        # the PRODUCTION batch post chain (vectorized block + unrolled /
        # associative EMA scans), not the per-column chain
        power = upto_power(x)
        cols_first = jnp.moveaxis(power, -2, 0)
        return postprocess_batch(cols_first, st, p.post, settings.agc_global)

    def upto_lut(x, st):
        vis, st2 = upto_post(x, st)
        return apply_lut(vis, p.lut), st2

    def timed(fn, *args):
        """Median warmed device-fenced µs of one prefix call."""
        f = jax.jit(fn)
        return float(np.median(_timed_ms(lambda: f(*args), 20))) * 1e3

    prefixes = {
        "frames": timed(upto_frames, xd),
        "fft+corrections+bins": timed(upto_deposits, xd),
        "scatter(power-grid)": timed(upto_power, xd),
        "post-chain-scan": timed(upto_post, xd, st),
        "lut": timed(upto_lut, xd, st),
    }
    names = list(prefixes)
    stages = {names[0]: prefixes[names[0]]}
    for a, b in zip(names, names[1:]):
        stages[b] = max(prefixes[b] - prefixes[a], 0.0)
    return {
        "t_count": t_count,
        "prefix_us": {k: round(v, 1) for k, v in prefixes.items()},
        "stage_us": {k: round(v, 1) for k, v in stages.items()},
    }


if __name__ == "__main__":
    import json
    cfg = Settings(mode="enhanced", multires=False, fft_size=8192)
    print(json.dumps(stage_breakdown(cfg), indent=2))
    cfg = Settings(mode="enhanced", multires=True)
    print(json.dumps(stage_breakdown(cfg), indent=2))