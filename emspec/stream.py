"""Streaming driver: real-time hop→raster loop (L1→L4 hot path).

This realizes the reference's live visualization loop (SURVEY.md §3.2):
samples arrive in a host ring buffer, each hop stages only the ``hop``
NEW samples to the device (the analysis window itself is device-resident
carry state — ``Pipeline._stream_step_rolling``), one fused jitted step
scatters/merges and emits a display column, and only the finished uint8
RGBA column crosses back to host [NS: "no host round-trip" for the
compute chain].  Host→device traffic is therefore the audio byte rate —
the information floor — instead of n_max/hop × that (32× at the display
default).

Double-buffered prefetch [NS north_star]: staging is an explicit two-slot
queue — ``_stage_one`` issues the host→HBM copy of hop t+1 *before* the
step for hop t is dispatched, so even a blocking transfer path overlaps
the copy with compute (JAX dispatch is additionally asynchronous; the
queue makes the overlap a structural property rather than a runtime
accident).  tests/test_stream.py::test_staging_overlaps_compute pins the
ordering.

Pause/resume mirrors the reference's Max-for-Live window sync
(docs/MAX-FOR-LIVE.md): see ``emspec.integrations.live_state``.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from emspec.config import Settings
from emspec.io.ring import make_ring
from emspec.pipeline import Pipeline, PipelineParams, get_pipeline


def _stage_to_device(block: np.ndarray):
    """Host→device staging copy of one hop block."""
    return jax.device_put(block.astype(np.float32, copy=False))


class Column(NamedTuple):
    """One emitted display column (still device-resident until read).

    ``index`` is the absolute analysis-hop number (column ⋅ hop = sample
    offset of the window start), *including* frames skipped on producer
    overrun — so the display time axis stays aligned with absolute audio
    time even across a skip-ahead (failure contract, SURVEY.md §5.3)."""
    index: int            # absolute column number (0-based)
    vis: jax.Array        # (..., rows) float32 in [0, 1]
    rgba: jax.Array       # (..., rows, 4) uint8


class Stream:
    """Stateful streaming session over one Pipeline.

    >>> stream = Stream(Settings())
    >>> cols = stream.push(samples)     # list[Column] ready so far
    >>> cols += stream.flush()          # drain the reassignment pending ring
    """

    def __init__(self, settings: Settings, params: PipelineParams | None = None,
                 ring_seconds: float = 4.0, native_ring: bool = True):
        self.pipe: Pipeline = get_pipeline(settings)
        self.settings = settings
        s = settings
        self.channels = s.channels
        lead = (s.channels,) if s.channels > 1 else ()
        self._lead = lead
        # pipe is cached by structural projection; params must come
        # from THIS stream's settings (sliders live here)
        self.params = params or self.pipe.params(settings)
        capacity = max(int(ring_seconds * s.sample_rate),
                       self.pipe.n_max + 8 * self.pipe.hop)
        self.ring = make_ring(capacity, s.channels, prefer_native=native_ring)
        self.dropped_frames = 0     # overrun accounting (SURVEY.md §5.3)
        # rolling-window carry: the analysis window is device state and
        # each hop ships only the `hop` NEW samples (the H2D floor is
        # the audio byte rate — Pipeline._stream_step_rolling docstring)
        self._carry = self.pipe.init_roll_carry(lead)
        self._window_ready = False  # device window primed for _next_stage?
        self._t = 0                 # host mirror of the carry's hop counter
        self._last_col = None       # underrun repaint contract (SURVEY 5.3)
        self._next_frame = 0        # next hop index to analyze
        self._next_stage = 0        # next hop index to stage to device
        self._staged = deque()      # two-slot host→HBM prefetch queue
        self._paused = False
        self._finished = False
        # the pipeline's canonical donated-carry executable (shared with
        # prewarm(), so a pre-warmed size switch never stalls)
        self._step = self.pipe._stream_roll_jit

    # ------------------------------------------------------------------ API
    @property
    def reach(self) -> int:
        return self.pipe.reach

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def push(self, samples: np.ndarray) -> list[Column]:
        """Feed new samples; returns every display column that became final.

        While paused the ring still fills (so no audio is lost on short
        pauses) but no analysis runs — matching the reference's minimized
        behavior [INF from MAX-FOR-LIVE.md window sync]."""
        if self._finished:
            raise RuntimeError(
                "stream already flushed; create a new Stream to continue")
        samples = np.asarray(samples)
        if samples.shape[-1]:
            # zero-length pushes are the sanctioned "drain only" idiom for
            # capture-fed streams (the capture thread is the ring's single
            # producer; even a 0-sample push would read-modify-write the
            # ring's counters from this thread — a two-producer race)
            self.ring.push(samples)
        if self._paused:
            return []
        return self._drain()

    def last_column(self) -> Column | None:
        """The most recently emitted column, or None before the first.

        Underrun contract (SURVEY.md §5.3): when the producer starves the
        stream, the app loop keeps painting this column so the display
        never freezes on a half-drawn frame."""
        return self._last_col

    def flush(self) -> list[Column]:
        """Emit the R pending columns at stream end (zero-padded hops).
        After ``flush`` the streamed columns 0..T-1 equal the batch
        ``Pipeline.process`` output exactly — and the stream is finished:
        further ``push`` raises (the zero-hops already advanced the
        carry, so resumed columns would be index-shifted)."""
        self._finished = True
        out = []
        # zero the device window first: flush hops analyze ALL-zero
        # windows (the exact semantic the streaming ≡ batch pin relies
        # on — an all-zero window deposits nothing, so the R pending
        # columns drain with no contribution from past-the-end windows
        # the batch path never analyzes)
        window, inner = self._carry
        self._carry = (jnp.zeros_like(window), inner)
        zero = np.zeros(self._lead + (self.pipe.hop,), np.float32)
        for _ in range(self.pipe.reach):
            out.extend(self._run_one(zero))
        return out

    # ------------------------------------------------------------- internals
    def _stage_one(self) -> bool:
        """Stage the next hop's NEW samples (plus, at stream start or
        after an overrun skip-ahead, the window prefix that re-primes
        the device-resident rolling window).  Returns False when the
        ring doesn't hold hop ``_next_stage``'s full window yet."""
        n_max, hop = self.pipe.n_max, self.pipe.hop
        while True:
            t = self._next_stage
            if self.ring.total_written < t * hop + n_max:
                return False
            try:
                if self._window_ready:
                    # continuity holds: only the hop-new samples cross
                    block = self.ring.window_at(t * hop + n_max - hop, hop)
                    w_init = None
                else:
                    # prime: concat(w_init[hop:], block) == window t
                    window = self.ring.window_at(t * hop, n_max)
                    block = window[..., n_max - hop:]
                    w_init = np.concatenate(
                        [np.zeros(window.shape[:-1] + (hop,), np.float32),
                         window[..., :n_max - hop]], axis=-1)
                    self._window_ready = True
            except ValueError:
                # overrun: the producer lapped us. Skip to the newest
                # fully-available frame and keep going — degraded display
                # beats a dead stream (failure contract, SURVEY.md §5.3).
                # The skip breaks hop continuity: re-prime the window.
                newest = (self.ring.total_written - n_max) // hop
                self.dropped_frames += max(newest - self._next_stage, 0)
                self._next_stage = max(newest, self._next_stage + 1)
                self._window_ready = False
                continue
            if self.channels == 1:
                block = block[0]
                if w_init is not None:
                    w_init = w_init[0]
            dev = _stage_to_device(block)
            # snapshot the drop count WITH the window: a later overrun
            # (while this window waits in the queue) must not inflate the
            # already-staged column's absolute-time index
            self._staged.append((self.dropped_frames, dev, w_init))
            self._next_stage += 1
            return True

    def _drain(self) -> list[Column]:
        out = []
        while True:
            # two-slot double buffering: before dispatching the step for
            # hop t, hop t+1's copy is already in flight
            while len(self._staged) < 2 and self._stage_one():
                pass
            if not self._staged:
                break
            dropped_at_stage, dev, w_init = self._staged.popleft()
            if not self._staged:
                self._stage_one()           # stage t+1 ahead of step t
            out.extend(self._dispatch(dev, dropped_at_stage, w_init))
            self._next_frame = self._next_stage - len(self._staged)
        return out

    def _run_one(self, block: np.ndarray) -> list[Column]:
        return self._dispatch(_stage_to_device(block), self.dropped_frames)

    def _dispatch(self, dev, dropped: int, w_init=None) -> list[Column]:
        if w_init is not None:
            # one-time window (re)prime: a single full-window transfer
            # at stream start / after an overrun skip-ahead
            self._carry = (jax.device_put(w_init), self._carry[1])
        self._carry, (vis, rgba, _) = self._step(self._carry, dev, self.params)
        # host-side counter mirrors the carry so no device sync per hop;
        # the stage-time drop count keeps Column.index on absolute audio
        # time across overrun skip-aheads (Column docstring contract)
        idx = self._t - self.pipe.reach + dropped
        self._t += 1
        if idx < 0:
            return []                                     # warmup, discarded
        col = Column(index=idx, vis=vis, rgba=rgba)
        self._last_col = col
        return [col]

    # ------------------------------------------------------- state save/load
    def state_pytree(self):
        """Streaming state as a pytree for checkpoint/resume (SURVEY.md §5.4:
        smoothing/AGC carries + pending ring + hop counter).

        Carry leaves are materialized to host numpy: the live carry's
        device buffers are *donated* into the next step, so a snapshot that
        aliased them would be invalidated by the next push/flush."""
        carry = jax.tree_util.tree_map(np.asarray, self._carry)
        return {"carry": carry, "t": self._t, "next_frame": self._next_frame}

    def load_state(self, state) -> None:
        self._carry = state["carry"]
        self._t = int(state["t"])
        self._next_frame = int(state["next_frame"])
        # restaging restarts from the resume point (staged-but-unanalyzed
        # windows are never part of a snapshot: _drain always empties the
        # queue before returning)
        self._next_stage = self._next_frame
        self._staged.clear()
        # the snapshot's carry includes the rolling window, so hop
        # continuity holds from the resume point (unless nothing was
        # ever streamed — then the zeros window still needs priming)
        self._window_ready = self._t > 0


def stream_signal(x: np.ndarray, settings: Settings,
                  chunk: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """Convenience: push a whole signal through a Stream in small chunks.

    Returns (vis (T, ..., rows), rgba (T, ..., rows, 4)) host arrays —
    the streaming counterpart of ``Pipeline.process`` for tests/tools."""
    st = Stream(settings)
    x = np.asarray(x, np.float32)
    cols = []
    for i in range(0, x.shape[-1], chunk):
        cols.extend(st.push(x[..., i:i + chunk]))
    cols.extend(st.flush())
    if not cols:
        raise ValueError(
            f"signal too short: need at least {st.pipe.n_max} samples for "
            f"one analysis window, got {x.shape[-1]}")
    cols.sort(key=lambda c: c.index)
    vis = np.stack([np.asarray(c.vis) for c in cols])
    rgba = np.stack([np.asarray(c.rgba) for c in cols])
    return vis, rgba
