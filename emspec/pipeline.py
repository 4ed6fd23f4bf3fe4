"""Pipeline builder: settings → fused jitted hop→raster functions (L2–L4 glue).

This is the product's hot path (SURVEY.md §3.2).  One ``Pipeline`` object
per structural-settings combination; continuous sliders are members of the
``PipelineParams`` pytree and never recompile (SURVEY.md §3.3).

Display-path design for the multires banks [NS configs[2]]:

* **Natural mode**: per-bank |X_h|² → precomputed gather/lerp merge onto
  the log-frequency rows with raised-cosine band crossfades
  (``emspec.dsp.multires``).
* **Enhanced mode**: the reassignment scatters **directly onto the display
  grid** — row index from the inverse log-frequency map of the reassigned
  frequency f̂, column offset from Δt/hop.  One scatter, no second
  interpolation pass: sharper (reassigned energy is a 2-D histogram on
  the raster, which is what the reference's sharpened display is) and
  cheaper.  Band crossfade weights are evaluated at the *source*
  bin frequency (that is where each bank's reliability is defined) [INF].

Per-unit normalization: each bank's power is scaled 1/N² so a stationary
tone displays equally bright through any bank (Hann coherent power gain
is N²/4; the residual 4 is absorbed by the Gain slider).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from emspec.config import MODE_ENHANCED, Settings
from emspec.dsp.frame import frame_signal, num_frames
from emspec.dsp.histogram import histogram_reference
from emspec.dsp.multires import (
    MergeTables, band_support_hz, band_weight_at, bank_offsets,
    build_merge_tables, merge_columns,
)
from emspec.dsp.reassign import reassignment_corrections
from emspec.dsp.stft import stft_triple_stencil, windowed_triple
from emspec.dsp.windows import hann
from emspec.post.chain import (
    PostParams, PostState, postprocess_batch, postprocess_column,
)
from emspec.post.colormap import apply_lut, lut


class PipelineParams(NamedTuple):
    """Everything continuous: post-chain params + merge tables as arrays.
    Swapping any of these (slider moves, colormap change, Freq-Scale zoom)
    re-uses the compiled step."""
    post: PostParams
    lut: jnp.ndarray                 # (256, 4) uint8
    # enhanced-mode row map:  row = (log2(f_hz) - a) * b
    logmap_a: jnp.ndarray            # scalar: log2(f_min)
    logmap_b: jnp.ndarray            # scalar: rows_per_log2
    # natural-mode merge tables (per bank)
    i0: tuple                        # (rows,) int32
    w0: tuple                        # (rows,) float32
    band_rows: tuple                 # (rows,) float32 band weight per row
    band_bins: tuple                 # (K_b,) float32 band weight per source bin
    power_floor: jnp.ndarray         # scalar: drop |X_h|^2 below this
                                     # (Settings.reassign_floor_db)


def _row_map_consts(tables: MergeTables, rows: int):
    f = tables.row_freqs
    a = np.log2(f[0])
    b = (rows - 1) / (np.log2(f[-1]) - np.log2(f[0]))
    return np.float32(a), np.float32(b)


class Pipeline:
    """Compiled analysis+display pipeline for one structural configuration."""

    def __init__(self, settings: Settings):
        s = settings
        self.settings = s
        self.sizes = s.active_fft_sizes
        self.hop = s.hop_samples
        self.offsets = bank_offsets(self.sizes)
        self.n_max = max(self.sizes)
        self.rows = s.raster_height
        self.tables = build_merge_tables(
            self.sizes, s.sample_rate, self.rows, s.freq_min, s.freq_scale,
            s.crossover_low, s.crossover_high)
        self.row_freqs = self.tables.row_freqs
        # per-bank active bin range: outside its band support a bank's
        # weight is exactly zero, so those bins are sliced away before the
        # corrections+scatter (at the multires default ~93% of the
        # deposits are zero-weight)
        self.k_slices = []
        n_banks = len(self.sizes)
        for b, n in enumerate(self.sizes):
            k_count = n // 2 + 1
            if n_banks == 1:
                self.k_slices.append((0, k_count))
                continue
            lo_hz, hi_hz = band_support_hz(
                b, n_banks, s.crossover_low, s.crossover_high,
                s.sample_rate / 2.0)
            bin_hz = s.sample_rate / n
            k_lo = max(int(np.floor(lo_hz / bin_hz)) - 1, 0)
            k_hi = min(int(np.ceil(hi_hz / bin_hz)) + 2, k_count)
            self.k_slices.append((k_lo, k_hi))
        self._batch_jit = jax.jit(self._batch_vis, static_argnames=("t_count",))
        # the canonical streaming executables, shared by Stream and
        # prewarm() so warming actually hits the cache the live stream
        # will use.  _stream_jit takes the full analysis window
        # (ShardedStream); _stream_roll_jit is the production Stream
        # entry — the window lives in the carry and only the `hop` new
        # samples cross host→device per hop (the H2D floor is the audio
        # rate itself)
        self._stream_jit = jax.jit(self._stream_step, donate_argnums=0)
        self._stream_roll_jit = jax.jit(self._stream_step_rolling,
                                        donate_argnums=0)

    @property
    def fft_impl(self) -> str:
        """Resolved FFT engine ("fourstep" | "xla") — see Settings.fft_impl.

        "auto" resolves to "xla": rfft is bitwise batch-shape-stable, so
        streaming ≡ batch stays bit-exact where the scatter order is
        fixed.  "fourstep" stays selectable wherever it is supported
        (float32-tolerance parity, tested)."""
        from emspec.dsp import fourstep
        s = self.settings.fft_impl
        if s == "auto":
            return "xla"
        if s == "fourstep" and not all(fourstep.supported(n) for n in self.sizes):
            raise ValueError(f"fourstep FFT unsupported for sizes {self.sizes}")
        return s

    # ---------------- params ----------------
    def params(self, settings: Settings | None = None) -> PipelineParams:
        """Build the continuous-param pytree (cheap; call on slider moves)."""
        s = settings or self.settings
        tables = self.tables
        if s.freq_scale != self.settings.freq_scale:
            tables = build_merge_tables(
                self.sizes, s.sample_rate, self.rows, s.freq_min, s.freq_scale,
                s.crossover_low, s.crossover_high)
        a, b = _row_map_consts(tables, self.rows)
        band_bins = []
        n_banks = len(self.sizes)
        for bank_idx, n in enumerate(self.sizes):
            k_lo, k_hi = self.k_slices[bank_idx]
            bin_f = np.arange(k_lo, k_hi) * (s.sample_rate / n)
            # band weight per source bin, evaluated analytically (exactly
            # zero outside the sliced support — zoom-independent)
            band_bins.append(band_weight_at(
                bin_f, bank_idx, n_banks, s.crossover_low, s.crossover_high,
            ).astype(np.float32))
        return PipelineParams(
            post=PostParams.from_settings(s, tables.row_freqs),
            lut=jnp.asarray(lut(s.colormap)),
            logmap_a=jnp.float32(a), logmap_b=jnp.float32(b),
            i0=tuple(jnp.asarray(i) for i in tables.i0),
            w0=tuple(jnp.asarray(w) for w in tables.w0),
            band_rows=tuple(jnp.asarray(w) for w in tables.band_w),
            band_bins=tuple(jnp.asarray(w) for w in band_bins),
            power_floor=jnp.float32(10.0 ** (s.reassign_floor_db / 10.0)),
        )

    # ---------------- analysis ----------------
    def _bank_frames(self, x: jnp.ndarray, t_count: int):
        """Center-aligned per-bank frames: bank b frame t covers
        [offset_b + t*hop, … + N_b) so all columns share their center."""
        out = []
        for n, off in zip(self.sizes, self.offsets):
            end = off + (t_count - 1) * self.hop + n
            out.append(frame_signal(x[..., off:end], n, self.hop))
        return out

    def _bank_power(self, frames: jnp.ndarray, n: int) -> jnp.ndarray:
        """Hann |X|^2 of one bank's frames/window — the single definition
        both the batch and streaming natural paths share (so they cannot
        silently diverge).

        Non-finite scrub (the natural path's poisoning guard): one
        NaN/Inf capture sample NaNs every bin of its frame's spectrum;
        unscrubbed, that NaN reaches ``peak_db`` and permanently poisons
        the AGC reference EMA (``post/chain.py`` stage 4) — every later
        column would be NaN for process lifetime.  Zeroing non-finite
        power here renders the affected columns black and recovers as
        soon as the bad sample leaves the analysis window, matching the
        enhanced path's immunity (its deposit validity mask already
        zeroes non-finite contribs).  For finite inputs the ``where`` is
        an exact identity, so the bit-exact streaming ≡ batch pins are
        untouched.  Mirrored in ``tests/oracle.py`` (invariants
        contract); the reference app runs indefinitely on live system
        audio [OBS: README.md:36] so the state must be unpoisonable."""
        w = jnp.asarray(hann(n))
        if self.fft_impl == "fourstep":
            from emspec.dsp.fourstep import rfft_fourstep
            X = rfft_fourstep(frames * w)
        else:
            X = jnp.fft.rfft(frames * w, axis=-1)
        power = (X.real**2 + X.imag**2).astype(jnp.float32)
        return jnp.where(jnp.isfinite(power), power, 0.0)

    def _natural_power(self, x, t_count, p: PipelineParams):
        specs = [self._bank_power(frames, n)
                 for frames, n in zip(self._bank_frames(x, t_count), self.sizes)]
        tables = MergeTables(self.row_freqs,
                             tuple(p.i0), tuple(p.w0), tuple(p.band_rows))
        return merge_columns(tuple(specs), tables)          # (..., t, rows)

    def _deposits(self, frames_list, p: PipelineParams):
        """Shared by batch and streaming: per-bank frames (..., N_b) →
        flattened ``(row, col_delta, contrib)`` each (..., ΣK_b).

        ``col_delta = round(Δt/hop)`` is the *relative* column offset —
        the caller adds its own absolute column index and applies its own
        column-range mask (contrib is already zeroed for every other
        invalidity: sub-floor power, out-of-axis row, |Δt| > N/2)."""
        sr = float(self.settings.sample_rate)
        rows_l, delta_l, contrib_l = [], [], []
        for frames, n, bb, (k_lo, k_hi) in zip(
                frames_list, self.sizes, p.band_bins, self.k_slices):
            if self.settings.fft_method == "stencil":
                X = stft_triple_stencil(frames, self.fft_impl)
            else:
                windowed = windowed_triple(frames)
                if self.fft_impl == "fourstep":
                    from emspec.dsp.fourstep import rfft_fourstep
                    Xs = rfft_fourstep(windowed)
                else:
                    Xs = jnp.fft.rfft(windowed, axis=-1)
                X = (Xs[0], Xs[1], Xs[2])
            # slice to the bank's band support (zero weight outside):
            # corrections + scatter skip the dead bins entirely
            X = tuple(a[..., k_lo:k_hi] for a in X)
            power, dt, dw = reassignment_corrections(*X)
            k_idx = jnp.arange(k_lo, k_hi, dtype=jnp.float32)
            f_hat = (k_idx + dw * (n / (2.0 * np.pi))) * (sr / n)   # Hz
            delta = jnp.round(dt / float(self.hop)).astype(jnp.int32)
            row_f = (jnp.log2(jnp.maximum(f_hat, 1e-6)) - p.logmap_a) * p.logmap_b
            row = jnp.round(row_f).astype(jnp.int32)
            valid = (
                (power > p.power_floor)
                & (row >= 0) & (row < self.rows)
                & (f_hat > 0)
                & (jnp.abs(dt) <= float(n) / 2.0)
            )
            contrib = jnp.where(valid, power * bb * (1.0 / float(n * n)), 0.0)
            rows_l.append(jnp.clip(row, 0, self.rows - 1))
            delta_l.append(delta)
            contrib_l.append(contrib)
        cat = lambda parts: jnp.concatenate(
            [a.reshape(a.shape[:-1] + (-1,)) for a in parts], axis=-1)
        return cat(rows_l), cat(delta_l), cat(contrib_l)

    def _enhanced_power(self, x, t_count, p: PipelineParams,
                        frame_valid=None):
        """Reassigned 2-D histogram directly on the (t, rows) display grid.

        ``frame_valid``: optional (t,) float mask zeroing the deposits of
        frames that exist only as analysis halo (time-sharded rendering,
        ``emspec.parallel.TimeParallelRenderer``): a shard's local frame
        range extends past the global [0, t_count) to recompute boundary
        deposits, and a trailing PARTIAL frame — one the global batch
        never analyzes because its window ends past the signal — must
        not deposit into the kept columns."""
        frames_list = self._bank_frames(x, t_count)

        def fmask(c):                                  # (..., t, K)
            return c if frame_valid is None else c * frame_valid[:, None]

        rows_i, delta, contrib = self._deposits(frames_list, p)
        return self._scatter_segment_sum(rows_i, delta, fmask(contrib),
                                         t_count, x.shape[:-1])

    def _scatter_segment_sum(self, rows_i, delta, contrib, t_count, lead):
        """The reassignment scatter: one flattened segment_sum over the
        absolute (t, rows) grid (the shared histogram_reference
        formulation, also used by the streaming step)."""
        t_idx = jnp.arange(t_count, dtype=jnp.int32)[:, None]
        col = t_idx + delta
        ids = jnp.where((col >= 0) & (col < t_count),
                        col * self.rows + rows_i, -1)
        flat_ids = ids.reshape(lead + (-1,)) if lead else ids.reshape(-1)
        flat_vals = (contrib.reshape(lead + (-1,)) if lead
                     else contrib.reshape(-1))
        out = histogram_reference(flat_ids, flat_vals, t_count * self.rows)
        return out.reshape(lead + (t_count, self.rows))

    # ---------------- full batch path ----------------
    def _batch_vis(self, x, p: PipelineParams, state: PostState, t_count: int):
        power = (self._enhanced_power(x, t_count, p)
                 if self.settings.mode == MODE_ENHANCED
                 else self._natural_power(x, t_count, p))    # (..., t, rows)
        cols_first = jnp.moveaxis(power, -2, 0)              # (t, ..., rows)
        # vectorized post chain (bit-identical to the per-column scan the
        # streaming step uses — see postprocess_batch)
        vis, state = postprocess_batch(cols_first, state, p.post,
                                       self.settings.agc_global)
        rgba = apply_lut(vis, p.lut)                          # (t, ..., rows, 4)
        return vis, rgba, state

    def num_columns(self, num_samples: int) -> int:
        return num_frames(num_samples, self.n_max, self.hop)

    # ---------------- streaming path (per-hop step, SURVEY.md §3.2) ----------
    @property
    def reach(self) -> int:
        """R: max columns the time-reassignment can move energy.

        Δt is the first moment of time over the window support
        [−N/2, N/2] (Auger–Flandrin; DESIGN.md §3), so |Δt| ≤ N/2 for
        any physical component — larger excursions are interference/
        noise artifacts the validity mask drops (round-3 spec
        tightening from |Δt| ≤ N: halves P = 2R+1 scatter spaces AND
        the streaming emit latency).  |δ| ≤ round(N/(2·hop)); natural
        mode never moves energy: R = 0."""
        if self.settings.mode != MODE_ENHANCED:
            return 0
        return max(int(np.round(n / (2.0 * self.hop))) for n in self.sizes)

    def _bank_windows(self, window: jnp.ndarray):
        """Single analysis window (..., N_max) → center-aligned per-bank
        slices (..., N_b)."""
        return [window[..., off:off + n]
                for n, off in zip(self.sizes, self.offsets)]

    def _stream_step(self, carry, window, p: PipelineParams):
        """One hop: scatter this frame's deposits into the pending ring of
        P = 2R+1 columns, then emit column t−R (final: no later frame can
        reach it).  Post-chain state only advances on real emissions, so a
        stream followed by ``flush`` reproduces the batch scan exactly
        (SURVEY.md §4.4 streaming ≡ batch)."""
        t, acc, post = carry                     # acc: (P, ..., rows)
        R = self.reach
        P = 2 * R + 1
        lead = window.shape[:-1]

        if self.settings.mode == MODE_ENHANCED:
            rows_i, delta, contrib = self._deposits(
                self._bank_windows(window), p)
            contrib = jnp.where(t + delta >= 0, contrib, 0.0)
            slot = jnp.mod(t + delta, P)
            ids = slot * self.rows + rows_i
            dep = histogram_reference(ids, contrib, P * self.rows)
            dep = dep.reshape(dep.shape[:-1] + (P, self.rows))
            dep = jnp.moveaxis(dep, -2, 0)              # (P, ..., rows)
            acc = acc + dep
        else:
            specs = [self._bank_power(win, n)
                     for win, n in zip(self._bank_windows(window), self.sizes)]
            tables = MergeTables(self.row_freqs,
                                 tuple(p.i0), tuple(p.w0), tuple(p.band_rows))
            col = merge_columns(tuple(specs), tables)       # (..., rows)
            acc = acc.at[jnp.mod(t, P)].add(col)

        emit_slot = jnp.mod(t - R, P)
        emit_power = acc[emit_slot]                          # (..., rows)
        vis, new_post = postprocess_column(emit_power, post, p.post,
                                           self.settings.agc_global)
        do_emit = t >= R
        post = jax.tree_util.tree_map(
            lambda new, old: jnp.where(do_emit, new, old), new_post, post)
        vis = jnp.where(do_emit, vis, 0.0)
        rgba = apply_lut(vis, p.lut)
        acc = acc.at[emit_slot].set(0.0)                     # slot reused by t+R+1
        return (t + 1, acc, post), (vis, rgba, t - R)

    def _stream_step_rolling(self, carry, block, p: PipelineParams):
        """H2D-minimal streaming hop: the analysis window is carry
        state; ``block`` is only the ``hop`` NEW samples.

        window' = concat(window[hop:], block) reproduces exactly the
        window `_stream_step` would have been fed, so streaming ≡ batch
        bit-exactness is inherited unchanged — the concat is pure data
        movement ahead of the identical step.  Rationale: per-hop
        windows overlap by (n_max − hop)/n_max; shipping the full
        window re-transfers every sample n_max/hop times (32× at the
        display default).  Keeping the window device-resident cuts
        host→device traffic to the information floor — the audio byte
        rate."""
        window, inner = carry
        window = jnp.concatenate([window[..., self.hop:], block], axis=-1)
        inner, out = self._stream_step(inner, window, p)
        return (window, inner), out

    def init_stream_carry(self, lead: tuple = ()):
        P = 2 * self.reach + 1
        return (jnp.int32(0),
                jnp.zeros((P,) + lead + (self.rows,), jnp.float32),
                PostState.init(lead + (self.rows,)))

    def init_roll_carry(self, lead: tuple = ()):
        """Carry for :meth:`_stream_step_rolling`: (window, inner)."""
        return (jnp.zeros(lead + (self.n_max,), jnp.float32),
                self.init_stream_carry(lead))

    # ---------------- hover readout (SURVEY.md §3.5) ----------------
    def _axis(self, freq_scale: float | None) -> np.ndarray:
        """Row-frequency axis at the given zoom.  Freq Scale is a
        *continuous* slider: pass the current value (the construction-time
        ``self.row_freqs`` reflects only the zoom the Pipeline was built
        with; the display itself follows params())."""
        if freq_scale is None or freq_scale == self.settings.freq_scale:
            return self.row_freqs
        from emspec.dsp.multires import log_freq_axis
        s = self.settings
        return log_freq_axis(self.rows, s.freq_min, s.sample_rate / 2.0,
                             freq_scale)

    def frequency_at_row(self, row: int, freq_scale: float | None = None) -> float:
        """Display row (0 = bottom/bass) → center frequency in Hz —
        the inverse of the log-frequency axis at the given zoom."""
        return float(self._axis(freq_scale)[row])

    def row_of_frequency(self, freq_hz: float,
                         freq_scale: float | None = None) -> int:
        """Nearest display row for a frequency (hover inverse map)."""
        f = self._axis(freq_scale)
        r = (np.log2(max(freq_hz, 1e-9)) - np.log2(f[0])) \
            / (np.log2(f[-1]) - np.log2(f[0])) * (self.rows - 1)
        return int(np.clip(round(r), 0, self.rows - 1))

    def describe_row(self, row: int, freq_scale: float | None = None) -> str:
        """The Shift+hover tooltip text for a display row
        (reference: README.md:39 'note and frequency information')."""
        from emspec.utils.notes import describe_frequency
        return describe_frequency(self.frequency_at_row(row, freq_scale))

    def process(self, x, params: PipelineParams | None = None,
                state: PostState | None = None):
        """Whole-signal batch processing.

        x: (..., samples) → (vis (t, ..., rows), rgba uint8 (t, ..., rows, 4),
        final PostState).  Streaming ≡ batch: the scan inside evolves the
        identical per-column state as the streaming driver (SURVEY.md §4.4).
        """
        x = jnp.asarray(x, jnp.float32)
        t_count = self.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(
                f"need at least {self.n_max} samples, got {x.shape[-1]}")
        p = params or self.params()
        st = state or PostState.init(x.shape[:-1] + (self.rows,))
        return self._batch_jit(x, p, st, t_count)


# Sized for the prewarm set (7 dropdown sizes + the multires variant,
# × enhanced/natural) with headroom for structural churn — a gain tweak
# must never evict a just-warmed executable (tests/test_ops.py pins the
# prewarm set staying resident).
@functools.lru_cache(maxsize=32)
def _cached_pipeline(settings: Settings) -> Pipeline:
    return Pipeline(settings)


def _structural_projection(s: Settings) -> Settings:
    """Settings with every continuous field reset to its default — the
    cache key.  Two Settings that differ only in sliders share one
    compiled Pipeline (otherwise a gain tweak before an FFT-size switch
    would miss the prewarm()ed executable and stall the live stream for a
    full compile)."""
    from emspec.config import STRUCTURAL_FIELDS
    defaults = Settings()
    import dataclasses
    cont = {f.name: getattr(defaults, f.name)
            for f in dataclasses.fields(Settings)
            if f.name not in STRUCTURAL_FIELDS}
    return s.replace(**cont)


def get_pipeline(settings: Settings) -> Pipeline:
    """Pipeline cache keyed by the *structural* projection of Settings —
    pre-warming the dropdown's FFT-size set amounts to calling this for
    each size (SURVEY.md §7 hard part 3).  NOTE: the returned Pipeline's
    ``.settings`` carries default continuous values; always build params
    with YOUR settings (``pipe.params(settings)``)."""
    return _cached_pipeline(_structural_projection(settings))


class WarmHandle:
    """Handle over the queued per-variant warm jobs.  ``cancel()`` drops
    every variant that hasn't started compiling yet — an app quitting
    mid-warm must not hang interpreter exit behind the rest of the
    dropdown (one in-flight compile still finishes; the executor's
    atexit join waits only for that)."""

    def __init__(self, futures):
        self.futures = list(futures)

    def result(self, timeout: float | None = None):
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        for f in self.futures:
            left = (None if deadline is None
                    else max(0.0, deadline - _time.monotonic()))
            f.result(left)

    def done(self) -> bool:
        return all(f.done() for f in self.futures)

    def cancel(self) -> None:
        for f in self.futures:
            f.cancel()


def prewarm(base: Settings, sizes: tuple | None = None,
            background: bool = True):
    """Pre-compile the streaming step for every FFT size in the dropdown so
    a size change never stalls the live stream (SURVEY.md §7 hard part 3;
    §3.3: structural changes re-specialize).

    Warms the single-bank variant for each ``size`` plus the multires
    variant once.  Returns a :class:`WarmHandle` (or None when
    ``background=False`` and warming ran inline).  Each variant is its
    own queued job so ``WarmHandle.cancel()`` can abandon the un-started
    remainder when the app shuts down mid-warm.
    """
    from emspec.config import FFT_SIZES

    sizes = sizes or FFT_SIZES
    variants = [base.replace(multires=False, fft_size=n) for n in sizes]
    if base.multires:
        variants.append(base)

    def _warm_one(s: Settings) -> None:
        pipe = get_pipeline(s)
        lead = (s.channels,) if s.channels > 1 else ()
        carry = pipe.init_roll_carry(lead)
        block = jnp.zeros(lead + (pipe.hop,), jnp.float32)
        jax.block_until_ready(
            pipe._stream_roll_jit(carry, block, pipe.params()))

    if background:
        pool = _warm_pool()
        return WarmHandle([pool.submit(_warm_one, s) for s in variants])
    for s in variants:
        _warm_one(s)
    return None


@functools.lru_cache(maxsize=1)
def _warm_pool():
    """One shared single-thread warmer: repeated prewarm() calls (every
    structural change in an app session) queue on the same worker instead
    of each leaking a fresh thread."""
    import concurrent.futures
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="emspec-prewarm")


def render_image_multires(x, settings: Settings) -> np.ndarray:
    """Audio → (rows, t, 4) uint8 RGBA log-frequency image.

    Multichannel input renders ``settings.display_channel`` (single-view
    display, matching the app controller; see render_images_channels for
    the tiled all-channel output)."""
    pipe = get_pipeline(settings)
    _, rgba, _ = pipe.process(x, params=pipe.params(settings))
    img = np.asarray(rgba)            # (t, [ch,] rows, 4)
    if img.ndim == 4:
        img = img[:, settings.display_channel]
    return img.transpose(1, 0, 2)[::-1]


def render_images_channels(x, settings: Settings) -> list[np.ndarray]:
    """Multichannel audio (ch, samples) → one (rows, t, 4) log-frequency
    image per channel, from a single batched pipeline pass (the stress
    config's 16 rasters become inspectable — tile with
    ``emspec.render.png.tile_images``)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None]
    s = settings.replace(channels=x.shape[0], display_channel=0)
    pipe = get_pipeline(s)
    _, rgba, _ = pipe.process(x, params=pipe.params(s))
    img = np.asarray(rgba)            # (t, ch, rows, 4)
    if img.ndim == 3:
        img = img[:, None]
    return [img[:, c].transpose(1, 0, 2)[::-1] for c in range(img.shape[1])]
