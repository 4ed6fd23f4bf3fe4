"""Post-processing chain (L3): linear power → display value in [0, 1].

Reference evidence: the settings glossary README.md:43-51 and every slider
in assets/settings.png (dB Range, Gain, Noise Gate, AGC Strength,
Smoothing, Brightness, Low End Boost).  The north star requires the whole
chain to fuse "into a single XLA pipeline so each hop emits a
display-ready raster with no host round-trip" [NS] — everything here is
elementwise / small-reduction jnp, fused by XLA into the hop step.

**Canonical stage order** (the parity contract; the float64 oracle in
``tests/oracle.py`` implements the identical order — the reference's own
internal order is unobservable [INF], so this order *is* the spec):

1. ``P *= low_end_ramp(f)``     bass emphasis, power domain (README.md:49)
2. ``P *= gain``                "Gain" slider, linear power multiplier
3. ``v = 10·log10(P + 1e-12)``  dB conversion
4. AGC (if enabled): ``v += strength·(0 − ref)`` with ``ref`` a slow EMA
   of the pre-AGC per-column peak dB (stateful; "adaptive brightness",
   README.md:14)
5. noise gate: ``v → −200 dB`` where ``v < gate_db`` (README.md:51)
6. normalize: ``vis = clip((v − (0 − db_range)) / db_range, 0, 1)``
7. temporal smoothing: ``y = α·y_prev + (1−α)·vis`` (stateful, README.md:50)
8. brightness: ``vis *= 2·brightness`` (0.5 = neutral [INF]); clip to [0,1]

States initialize to ``ref = 0 dB`` (AGC neutral) and ``y = 0`` so that
streaming and batch processing agree exactly (SURVEY.md §4.4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from emspec import engine
from emspec.config import Settings

DB_EPS = 1e-12        # guards log10(0)
DB_FLOOR = -200.0     # gated cells land here, below any visible range
AGC_TARGET_DB = 0.0   # AGC steers the EMA'd peak toward full scale
AGC_DECAY = 0.99      # per-hop EMA coefficient of the AGC reference


class PostParams(NamedTuple):
    """Continuous post-chain parameters — plain jit arguments, moving any
    of them never recompiles (SURVEY.md §3.3)."""
    gain: jnp.ndarray            # scalar, linear power multiplier
    db_range: jnp.ndarray        # scalar, visible dynamic window in dB
    noise_gate_db: jnp.ndarray   # scalar
    agc_strength: jnp.ndarray    # scalar in [0, 1]
    agc_enabled: jnp.ndarray     # scalar {0., 1.} — "Auto Gain" toggle
    smoothing: jnp.ndarray       # scalar EMA alpha in [0, 1)
    brightness: jnp.ndarray      # scalar, 0.5 = neutral
    low_end_ramp: jnp.ndarray    # (rows,) per-row boost factor (precomputed)

    @staticmethod
    def from_settings(s: Settings, freqs_hz: np.ndarray) -> "PostParams":
        f32 = lambda v: jnp.float32(v)
        return PostParams(
            gain=f32(s.gain),
            db_range=f32(s.db_range),
            noise_gate_db=f32(s.noise_gate_db),
            agc_strength=f32(s.agc_strength),
            agc_enabled=f32(1.0 if s.auto_gain else 0.0),
            smoothing=f32(s.smoothing),
            brightness=f32(s.brightness),
            low_end_ramp=jnp.asarray(
                low_end_ramp(freqs_hz, s.low_end_boost, s.low_end_cutoff),
                dtype=jnp.float32,
            ),
        )


class PostState(NamedTuple):
    """Streaming state carried hop→hop (donated in the stream driver)."""
    smooth: jnp.ndarray   # (..., rows) last smoothed display values
    agc_ref: jnp.ndarray  # (...,) EMA of per-column peak dB

    @staticmethod
    def init(shape_rows: tuple) -> "PostState":
        *lead, _rows = shape_rows
        return PostState(
            smooth=jnp.zeros(shape_rows, jnp.float32),
            agc_ref=jnp.full(tuple(lead), AGC_TARGET_DB, jnp.float32),
        )


def _ema_scan(y0: jnp.ndarray, alpha, xs: jnp.ndarray,
              associative: bool) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Leading-axis EMA ``y_t = α·y_{t-1} + (1−α)·x_t`` → (ys, y_final).

    associative=False: sequential ``lax.scan`` — bit-identical to the
    streaming per-column evolution (the CPU contract), unroll=8 because
    the two-FMA body is cheaper than the scan's per-step loop overhead.

    associative=True: the affine recurrence composed by
    ``lax.associative_scan`` — O(log t) full-array sweeps instead of t
    sequential steps.  Reassociation changes f32 rounding by ~log2(t)·ε
    relative (~1e-6 at display-scale t — an order under the display's
    1/255 quantum; the CPU suite keeps the bit-exact pin on the
    sequential path).
    """
    b = (1.0 - alpha) * xs
    if xs.shape[0] == 0:
        # t = 0 (audio shorter than one frame): mimic a length-0 lax.scan
        # — empty ys, carry unchanged.  The associative branch below would
        # raise on ys[-1].
        return b, y0
    if not associative:
        def step(y, bt):
            y = alpha * y + bt
            return y, y

        y_final, ys = jax.lax.scan(step, y0, b, unroll=8)
        return ys, y_final
    a = jnp.broadcast_to(jnp.asarray(alpha, xs.dtype), xs.shape)

    def compose(l, r):
        (a1, b1), (a2, b2) = l, r
        return a2 * a1, a2 * b1 + b2

    A, B = jax.lax.associative_scan(compose, (a, b), axis=0)
    ys = A * y0 + B
    return ys, ys[-1]


def _boost_db_peak(power, p: PostParams, global_agc: bool,
                   lead_axes: tuple):
    """Stages 1-3 + the pre-AGC per-column peak — the chain's stateless
    head, in ONE place for every path (per-column, batch, time-sharded):
    the docstring stage order is the parity contract, and a stage tweak
    must be impossible to apply to one path and miss in another.

    ``lead_axes``: axes of ``peak_db`` the global-AGC option couples
    (all channel/batch axes; never the time axis)."""
    boosted = power * p.low_end_ramp * p.gain                      # 1-2
    v_db = 10.0 * jnp.log10(boosted + DB_EPS)                      # 3
    peak_db = jnp.max(v_db, axis=-1)
    if global_agc and lead_axes:
        peak_db = jnp.broadcast_to(
            jnp.max(peak_db, axis=lead_axes, keepdims=True), peak_db.shape)
    return v_db, peak_db


def _agc_gate_norm(v_db, refs, p: PostParams):
    """Stages 4-6 given the AGC reference (column or leading-axis
    series): AGC offset, noise gate, dB-window normalize."""
    offset = p.agc_enabled * p.agc_strength * (AGC_TARGET_DB - refs)
    v_db = v_db + offset[..., None]                                # 4
    v_db = jnp.where(v_db < p.noise_gate_db, DB_FLOOR, v_db)       # 5
    return jnp.clip((v_db - (AGC_TARGET_DB - p.db_range)) / p.db_range,
                    0.0, 1.0)                                      # 6


def _brightness_clip(smoothed, p: PostParams):
    return jnp.clip(smoothed * (2.0 * p.brightness), 0.0, 1.0)     # 8


def postprocess_batch(
    power_ts: jnp.ndarray, state: PostState, p: PostParams,
    global_agc: bool = False, associative: bool | None = None,
) -> tuple[jnp.ndarray, PostState]:
    """Whole-signal post chain: (t, ..., rows) power → (t, ..., rows) vis.

    **Bit-identical** to scanning :func:`postprocess_column` over t — the
    same per-element operations in the same order — but only the two EMA
    recurrences (AGC reference, temporal smoothing) stay inside
    ``lax.scan``; the dB conversion, gate, normalize, and brightness are
    one big fused elementwise block.  This matters: a naive per-column
    scan serializes t × rows transcendentals; here the sequential part is
    two FMAs per element.

    ``associative`` switches the EMA recurrences to a parallel
    associative scan (see :func:`_ema_scan` for the cost model and the
    tolerance note; on the associative path the bit-identical guarantee
    above relaxes to ~1e-6 relative).  ``None`` leaves the choice to
    :func:`emspec.engine.associative_ema`, which decides by device.
    """
    if associative is None:
        associative = engine.associative_ema()
    # peak_db is (t, ...): global AGC couples the lead axes after t
    v_db, peak_db = _boost_db_peak(
        power_ts, p, global_agc, tuple(range(1, power_ts.ndim - 1)))

    # AGC_DECAY stays a PYTHON float: ``1.0 - alpha`` must constant-fold
    # in f64 exactly as postprocess_column writes it, or the bit-exact
    # streaming ≡ batch pin breaks in the last mantissa bit
    refs, ref_final = _ema_scan(state.agc_ref, AGC_DECAY,
                                peak_db, associative)
    vis = _agc_gate_norm(v_db, refs, p)                            # 4-6

    smoothed, smooth_final = _ema_scan(state.smooth, p.smoothing, vis,
                                       associative)                # 7
    out = _brightness_clip(smoothed, p)                            # 8
    return out, PostState(smooth=smooth_final, agc_ref=ref_final)


def _affine_chunk_in(y0, fin_all, alpha_L, axis_name):
    """Incoming EMA state for this device's time chunk.

    With constant per-step α, a length-L chunk composes to the affine map
    ``y_out = α^L·y_in + B`` where ``B`` is the chunk's zero-init final
    (``fin_all[k]`` for chunk k, gathered over the mesh).  Unrolling
    across the d preceding chunks:

        y_in(d) = α^(L·d)·y0  +  Σ_{k<d} α^(L·(d−1−k))·B_k

    Computed identically on every device from the gathered finals — a
    tiny (n_dev, …) contraction, the only cross-device data the post
    chain needs (scaling-book recipe: collect the per-chunk summaries,
    not the series)."""
    d = jax.lax.axis_index(axis_name)
    n = fin_all.shape[0]
    k = jnp.arange(n)
    expo = jnp.maximum(d - 1 - k, 0).astype(jnp.float32)
    w = jnp.where(k < d, jnp.power(alpha_L, expo), 0.0)
    w = w.reshape((n,) + (1,) * (fin_all.ndim - 1))
    return jnp.power(alpha_L, d.astype(jnp.float32)) * y0 \
        + jnp.sum(w * fin_all, axis=0)


def postprocess_batch_timeshard(
    power_local: jnp.ndarray, state0: PostState, p: PostParams,
    axis_name: str, global_agc: bool = False, valid_count=None,
    ch_axis: str | None = None,
) -> tuple[jnp.ndarray, PostState]:
    """Post chain for a TIME-sharded batch under ``shard_map``
    (SURVEY §2.5; used by :class:`emspec.parallel.TimeParallelRenderer`).

    ``ch_axis``: when the mesh ALSO shards channels (the 2-D (ch × t)
    composition), the global-AGC coupling needs one more hop — the
    local lead-axis max only covers this device's channel shard, so a
    ``pmax`` over ``ch_axis`` completes it.  That is the composition's
    only cross-channel collective; everything else (the EMA all_gathers,
    the final-state psum) crosses the time axis alone.

    ``power_local``: this device's contiguous (L, ..., rows) column
    chunk; ``state0`` the GLOBAL initial post state (replicated).  The
    chain's only sequential couplings are the two constant-α EMAs (AGC
    reference, temporal smoothing), and a constant-α EMA over a chunk is
    an affine map of its incoming state — so each device scans its chunk
    zero-initialized, one ``all_gather`` ships the (n_dev, …) chunk
    finals, and the exact correction ``y_t = α^(t+1)·y_in + y_t(0)``
    re-bases the local series.  Everything else is elementwise and stays
    on-device.  Tolerance: the re-basing reassociates the float
    recurrence — same ~1e-6 class as the associative scan
    (``_ema_scan`` docstring); the CPU bit-exact pin stays on the
    unsharded paths.

    Returns (vis_local, carry-out PostState of THIS chunk) — the global
    final state is the LAST device's carry-out; the renderer selects it
    with a masked ``psum``."""
    L = power_local.shape[0]
    # peak_db is (L, ...): same lead-axis coupling as postprocess_batch
    v_db, peak_db = _boost_db_peak(
        power_local, p, global_agc, tuple(range(1, power_local.ndim - 1)))
    if global_agc and ch_axis is not None:
        peak_db = jax.lax.pmax(peak_db, ch_axis)

    zero_ref = jnp.zeros_like(state0.agc_ref)
    refs0, ref_fin0 = _ema_scan(zero_ref, AGC_DECAY, peak_db, True)
    ref_in = _affine_chunk_in(
        state0.agc_ref, jax.lax.all_gather(ref_fin0, axis_name),
        jnp.float32(AGC_DECAY ** L), axis_name)
    tpow = jnp.float32(AGC_DECAY) ** jnp.arange(1, L + 1, dtype=jnp.float32)
    tpow = tpow.reshape((L,) + (1,) * (refs0.ndim - 1))
    refs = tpow * ref_in + refs0
    vis = _agc_gate_norm(v_db, refs, p)                            # 4-6

    zero_smooth = jnp.zeros_like(state0.smooth)
    smooth0, smooth_fin0 = _ema_scan(zero_smooth, p.smoothing, vis, True)
    s_in = _affine_chunk_in(
        state0.smooth, jax.lax.all_gather(smooth_fin0, axis_name),
        jnp.power(p.smoothing, jnp.float32(L)), axis_name)
    spow = jnp.power(p.smoothing,
                     jnp.arange(1, L + 1, dtype=jnp.float32))
    spow = spow.reshape((L,) + (1,) * (smooth0.ndim - 1))
    smoothed = spow * s_in + smooth0                               # 7
    out = _brightness_clip(smoothed, p)                            # 8
    # carry-out: the state at the last VALID local column (a chunk that
    # extends past the signal's t_count carries padded zero columns
    # whose state evolution must not leak into the global final state)
    if valid_count is None:
        idx = L - 1
    else:
        idx = jnp.clip(valid_count - 1, 0, L - 1)
    return out, PostState(smooth=jnp.take(smoothed, idx, axis=0),
                          agc_ref=jnp.take(refs, idx, axis=0))


def low_end_ramp(freqs_hz: np.ndarray, boost: float, cutoff_hz: float) -> np.ndarray:
    """Per-frequency bass-boost factor (README.md:49 "Emphasize bass").

    ``boost`` at/below cutoff/2, 1.0 at/above cutoff, linear in log2(f)
    across the octave in between [INF: smooth multiplicative ramp is the
    only shape consistent with a single "3.9x" slider].
    """
    f = np.maximum(np.asarray(freqs_hz, np.float64), 1e-6)
    shape = np.clip(np.log2(cutoff_hz / f), 0.0, 1.0)
    return (1.0 + (float(boost) - 1.0) * shape).astype(np.float32)


def postprocess_column(
    power: jnp.ndarray, state: PostState, p: PostParams,
    global_agc: bool = False,
) -> tuple[jnp.ndarray, PostState]:
    """One hop: linear power column (..., rows) → display values + new state.

    This is the fused per-column path used by the streaming driver; the
    batch path ``lax.scan``s it over time (streaming ≡ batch by
    construction, SURVEY.md §4.4).

    ``global_agc=True`` couples the AGC reference across all leading
    (channel) axes — one brightness for the whole multichannel display.
    Under a channel-sharded mesh this max is the pipeline's one genuine
    cross-device collective (GSPMD inserts the all-reduce; SURVEY.md
    §5.8).
    """
    # no time axis here: every peak_db axis is a channel axis the
    # global option couples (broadcast_to(max) ≡ the old max·ones —
    # multiply by 1.0 is exact in f32, the bit-exact pins hold)
    v_db, peak_db = _boost_db_peak(
        power, p, global_agc, tuple(range(power.ndim - 1)))        # 1-3
    new_ref = AGC_DECAY * state.agc_ref + (1.0 - AGC_DECAY) * peak_db
    vis = _agc_gate_norm(v_db, new_ref, p)                         # 4-6
    smoothed = p.smoothing * state.smooth + (1.0 - p.smoothing) * vis  # 7
    out = _brightness_clip(smoothed, p)                            # 8
    return out, PostState(smooth=smoothed, agc_ref=new_ref)
