"""Multi-chip scaling over a device mesh (SURVEY.md §2.5 / §5.8).

The reference is a single-process desktop app with no distributed story;
the rebuild's honest parallel axis is **channels** (the stress config is
16 channels [NS configs[4]]).  The reassignment scatter is channel-local,
so channel sharding needs no collectives beyond the initial shard — except
the optional global AGC (``Settings.agc_global``), whose cross-channel max
GSPMD turns into the one real ICI all-reduce of the pipeline.

Usage:

>>> mesh = channel_mesh()                        # all visible devices
>>> sp = ShardedPipeline(settings, mesh)         # channels % n_devices == 0
>>> vis, rgba, state = sp.process(x)             # x: (channels, samples)

Everything is plain ``jax.sharding`` + jit (GSPMD): no hand-written
communication, shardings annotated on inputs/outputs, XLA inserts the
collectives and rides ICI.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from emspec.config import Settings
from emspec.pipeline import Pipeline, get_pipeline
from emspec.post.chain import PostState


def channel_mesh(devices=None, axis: str = "ch") -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    devices = np.array(devices if devices is not None else jax.devices())
    return Mesh(devices, (axis,))


def ch_time_mesh(n_ch: int, devices=None) -> Mesh:
    """2-D (ch × t) mesh for the composed :class:`TimeParallelRenderer`:
    ``n_ch`` channel shards × (devices/n_ch) time shards.  "ch" is the
    major axis: consecutive devices hold the SAME channel shard across
    consecutive time shards, so the "ch" collective (the one global-AGC
    pmax per render) crosses device strides of n_t.  All collectives
    here are once-per-render, so the layout barely matters for this
    renderer; on a real pod reorder the device array to match the
    physical topology if profiling says otherwise."""
    devices = np.array(devices if devices is not None else jax.devices())
    if devices.size % n_ch:
        raise ValueError(f"{devices.size} devices not divisible by "
                         f"n_ch={n_ch}")
    return Mesh(devices.reshape(n_ch, -1), ("ch", "t"))


class ShardedPipeline:
    """Channel-sharded batch processing over a mesh.

    Shards the channel axis of inputs, post-state, and outputs; params are
    replicated.  ``settings.channels`` must be divisible by the mesh size.
    """

    def __init__(self, settings: Settings, mesh: Mesh):
        if settings.channels % mesh.devices.size != 0:
            raise ValueError(
                f"channels ({settings.channels}) must be divisible by the "
                f"mesh size ({mesh.devices.size})")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.pipe: Pipeline = get_pipeline(settings)
        self.settings = settings
        ax = self.axis
        self._sh_x = NamedSharding(mesh, P(ax, None))
        self._sh_state = PostState(
            smooth=NamedSharding(mesh, P(ax, None)),
            agc_ref=NamedSharding(mesh, P(ax)),
        )
        self._repl = NamedSharding(mesh, P())
        self._step = jax.jit(
            self.pipe._batch_vis,
            static_argnames=("t_count",),
            out_shardings=(
                NamedSharding(mesh, P(None, ax, None)),        # vis (t, ch, rows)
                NamedSharding(mesh, P(None, ax, None, None)),  # rgba
                self._sh_state,
            ),
        )

    def init_state(self) -> PostState:
        state = PostState.init((self.settings.channels, self.pipe.rows))
        return jax.device_put(state, self._sh_state)

    def process(self, x, params=None, state=None):
        """x: (channels, samples) → (vis (t, ch, rows), rgba, PostState),
        all sharded over the mesh's channel axis."""
        x = np.asarray(x, np.float32)
        t_count = self.pipe.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(f"need at least {self.pipe.n_max} samples")
        xd = jax.device_put(x, self._sh_x)
        p = jax.device_put(params or self.pipe.params(self.settings),
                           self._repl)
        st = state if state is not None else self.init_state()
        return self._step(xd, p, st, t_count=t_count)


class ShardedStream:
    """Channel-sharded STREAMING: the production per-hop rolling step
    (``_stream_step_rolling``) jitted over the mesh with the full carry —
    hop counter (replicated), the device-resident analysis window
    (channel-sharded), pending reassignment ring (P, ch, rows) and
    post-chain state (both channel-sharded) — **donated** each hop,
    exactly like the single-chip Stream's executable.  Per hop only the
    ``hop`` NEW samples cross host→device (the audio-rate floor — the
    same H2D design as Stream).  The scatter is channel-local; with
    ``agc_global=True`` the per-hop cross-channel max is the one
    all-reduce (SURVEY.md §5.8).

    Feed protocol (mirrors ``emspec.stream.Stream._stage_one``):
    ``reset_window(x[:, :n_max])`` primes the window for hop 0, then
    ``step(x[:, t*hop + n_max - hop : t*hop + n_max])`` per hop; at
    flush, ``reset_window(None)`` zeroes the window and zero blocks
    drain the pending ring.  ``stream_signal_sharded`` packages this so
    streaming ≡ batch is assertable under sharding
    (tests/test_parallel.py).
    """

    def __init__(self, settings: Settings, mesh: Mesh, params=None):
        if settings.channels % mesh.devices.size != 0:
            raise ValueError(
                f"channels ({settings.channels}) must be divisible by the "
                f"mesh size ({mesh.devices.size})")
        self.mesh = mesh
        ax = mesh.axis_names[0]
        self.pipe: Pipeline = get_pipeline(settings)
        self.settings = settings
        ch = settings.channels
        repl = NamedSharding(mesh, P())
        self._sh_window = NamedSharding(mesh, P(ax, None))
        self._sh_block = NamedSharding(mesh, P(ax, None))
        sh_carry = (
            self._sh_window,                              # rolling window
            (
                repl,                                     # hop counter t
                NamedSharding(mesh, P(None, ax, None)),   # acc (P, ch, rows)
                PostState(smooth=NamedSharding(mesh, P(ax, None)),
                          agc_ref=NamedSharding(mesh, P(ax))),
            ),
        )
        self._sh_carry = sh_carry
        self._carry = jax.device_put(
            self.pipe.init_roll_carry((ch,)), sh_carry)
        self.params = jax.device_put(
            params or self.pipe.params(settings), repl)
        self._step = jax.jit(
            self.pipe._stream_step_rolling,
            donate_argnums=0,
            out_shardings=(
                sh_carry,
                (NamedSharding(mesh, P(ax, None)),        # vis (ch, rows)
                 NamedSharding(mesh, P(ax, None, None)),  # rgba
                 repl),                                   # emitted index
            ),
        )
        self._t = 0
        self.needs_window_prime = False

    def reset_window(self, window: np.ndarray | None) -> None:
        """(Re)prime the device-resident rolling window.

        ``window``: hop 0's full (channels, n_max) samples — the next
        ``step`` block must then be ``window[:, n_max-hop:]`` (which
        completes it) — or None to zero the window for flush hops."""
        ch, n_max, hop = self.settings.channels, self.pipe.n_max, self.pipe.hop
        if window is None:
            w = np.zeros((ch, n_max), np.float32)
        else:
            w = np.concatenate(
                [np.zeros((ch, hop), np.float32),
                 np.asarray(window, np.float32)[..., :n_max - hop]], axis=-1)
        self._carry = (jax.device_put(w, self._sh_window), self._carry[1])
        self.needs_window_prime = False

    def step(self, block: np.ndarray):
        """One hop: (channels, hop) NEW samples → finalized column or
        None (warmup: the first ``reach`` hops emit nothing, like
        Stream)."""
        if self.needs_window_prime:
            # set by checkpoint migration of a pre-rolling-window
            # snapshot: the window leaf is zeros and CANNOT continue
            # the roll — stepping would silently emit wrong columns
            raise RuntimeError(
                "this stream was restored from a pre-rolling-window "
                "snapshot: call reset_window(window_at_resume_point) "
                "before the next step")
        dev = jax.device_put(np.asarray(block, np.float32),
                             self._sh_block)
        self._carry, (vis, rgba, _) = self._step(self._carry, dev,
                                                 self.params)
        idx = self._t - self.pipe.reach
        self._t += 1
        return None if idx < 0 else (idx, vis, rgba)

    # ----------------------------------------------------- checkpoint/resume
    def state_pytree(self):
        """Sharded streaming state as a HOST pytree (SURVEY.md §5.4 ×
        §5.8): carry leaves are gathered to host numpy — the live
        carry's device buffers are donated into the next step, and a
        snapshot must survive an *elastic* restart onto a different
        mesh size (load_state re-shards on whatever mesh the restored
        stream runs)."""
        carry = jax.tree_util.tree_map(np.asarray, self._carry)
        return {"carry": carry, "t": self._t}

    def load_state(self, state) -> None:
        """Resume from a snapshot, re-sharding onto THIS stream's mesh
        (the snapshot's mesh size need not match — channels must)."""
        self._carry = jax.device_put(state["carry"], self._sh_carry)
        self._t = int(state["t"])


class TimeParallelRenderer:
    """Offline batch rendering sharded over the TIME axis (SURVEY §2.5):
    a long recording's spectrogram computed N× faster on an N-device
    mesh.  The channel axis shards live streaming (:class:`ShardedStream`);
    this is the other honest parallel axis — offline t is embarrassingly
    parallel except for two couplings, each resolved the scaling-book
    way (pick the mesh, move summaries not series, let XLA ride ICI):

    * **Reassignment reach**: deposits from frame f land in columns
      f ± R, so a shard boundary column needs its neighbor's frames.
      Resolved by HALO RECOMPUTE, not communication: each device
      analyzes its L columns plus R frames of halo on each side (R ≪ L)
      and keeps the interior — deposits crossing the boundary are
      regenerated locally by both owners, bit-identically, because the
      padded global signal is replicated and a zero-padded frame
      deposits nothing (the flush semantic).
    * **Post-chain state**: the two constant-α EMA recurrences compose
      affinely over a chunk, so one ``all_gather`` of (n_dev, …) chunk
      finals + an exact re-basing replaces the sequential scan
      (:func:`emspec.post.chain.postprocess_batch_timeshard`).

    Tolerance: the analysis interior is the batch computation on the
    same values; the post re-basing reassociates the EMAs — the same
    ~1e-6 class as the associative scan (``emspec.post.chain``).
    tests/test_parallel.py pins equality vs the single-device batch on
    the virtual mesh, plus shard shapes (no silent
    replication) and the collective census (exactly the two
    all_gathers + the final-state psum).

    **2-D (ch × t) composition** (round-5; SURVEY §2.5 × §5.8): pass a
    two-axis mesh with one axis named ``"t"`` — the other axis shards
    CHANNELS, composing this renderer with :class:`ShardedPipeline`'s
    seam (the stress config [NS configs[4]] offline-rendered on a pod
    wants both).  The channel axis is embarrassingly parallel through
    the whole analysis (the scatter is channel-local); the only
    cross-channel collective is the optional global-AGC ``pmax``
    (``postprocess_batch_timeshard(ch_axis=…)``) — ONE all-reduce per
    render covering every column's peak — while the EMA all_gathers and
    the final-state psum cross the time axis alone.
    """

    def __init__(self, settings: Settings, mesh: Mesh, params=None):
        self.mesh = mesh
        names = mesh.axis_names
        if len(names) == 1:
            self.axis, self.ch_axis = names[0], None
        elif len(names) == 2:
            if "t" not in names:
                raise ValueError(
                    f"a 2-D TimeParallelRenderer mesh needs an axis "
                    f"named 't' (time); got {names}")
            self.axis = "t"
            self.ch_axis = next(a for a in names if a != "t")
            n_ch = mesh.shape[self.ch_axis]
            if settings.channels % n_ch != 0:
                raise ValueError(
                    f"channels ({settings.channels}) must be divisible "
                    f"by the mesh's {self.ch_axis!r} axis ({n_ch})")
        else:
            raise ValueError(f"mesh must be 1-D (time) or 2-D (ch × "
                             f"time); got axes {names}")
        self.pipe: Pipeline = get_pipeline(settings)
        self.settings = settings
        self.params = params or self.pipe.params(settings)
        self._jit_cache = {}

    def _build(self, t_count: int):
        from jax import shard_map

        from emspec.config import MODE_ENHANCED
        from emspec.post.chain import postprocess_batch_timeshard
        from emspec.post.colormap import apply_lut

        pipe, ax, chax = self.pipe, self.axis, self.ch_axis
        n = self.mesh.shape[ax]
        L = -(-t_count // n)                       # ceil: columns per device
        R, hop, n_max = pipe.reach, pipe.hop, pipe.n_max
        t_local = L + 2 * R
        slice_len = (t_local - 1) * hop + n_max
        agc_global = self.settings.agc_global

        def local_fn(x_pad, p, state0):
            d = jax.lax.axis_index(ax)
            xd = jax.lax.dynamic_slice_in_dim(
                x_pad, d * (L * hop), slice_len, axis=-1)
            # halo frames outside the GLOBAL frame range must not
            # deposit: left-of-0 frames are all-zero (the pad) but a
            # trailing partial frame holds real samples the batch never
            # analyzes — mask both (pipeline._enhanced_power docstring)
            g = jnp.arange(t_local) + (d * L - R)
            frame_valid = ((g >= 0) & (g < t_count)).astype(jnp.float32)
            power = (pipe._enhanced_power(xd, t_local, p, frame_valid)
                     if self.settings.mode == MODE_ENHANCED
                     else pipe._natural_power(xd, t_local, p))
            power = jnp.moveaxis(power, -2, 0)[R:R + L]   # interior columns
            valid = jnp.clip(t_count - d * L, 0, L)
            vis, st_out = postprocess_batch_timeshard(
                power, state0, p.post, ax, agc_global, valid_count=valid,
                ch_axis=chax)
            rgba = apply_lut(vis, p.lut)
            # global final state = carry-out of the device owning column
            # t_count−1, shipped to every device via a masked psum
            # (crossing the time axis only — the channel axis keeps its
            # own shard of the state)
            owner = (t_count - 1) // L
            sel = (d == owner).astype(jnp.float32)
            st_fin = jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a * sel, ax), st_out)
            return vis, rgba, st_fin

        # channel-sharded leaves: x (ch, samples), state (ch, rows)/(ch,)
        sh_x = P(chax, None) if chax else P()
        sh_state = (PostState(smooth=P(chax, None), agc_ref=P(chax))
                    if chax else P())
        sh_vis = P(ax, chax, None) if chax else P(ax)
        sh_rgba = P(ax, chax, None, None) if chax else P(ax)
        return jax.jit(shard_map(
            local_fn, mesh=self.mesh,
            in_specs=(sh_x, P(), sh_state),
            out_specs=(sh_vis, sh_rgba, sh_state),
        )), L, slice_len

    def render(self, x, state: PostState | None = None):
        """x: (samples,) or (channels, samples) → (vis (t, ..., rows),
        rgba (t, ..., rows, 4), final PostState) — the time axis sharded
        over the mesh, numerically the single-device ``Pipeline.process``
        up to the documented EMA re-basing tolerance."""
        x = np.asarray(x, np.float32)
        pipe = self.pipe
        t_count = pipe.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(f"need at least {pipe.n_max} samples")
        lead = x.shape[:-1]
        if self.ch_axis is not None and (
                x.ndim != 2 or x.shape[0] % self.mesh.shape[self.ch_axis]):
            raise ValueError(
                f"a (ch × t) mesh needs (channels, samples) input with "
                f"channels divisible by the {self.ch_axis!r} axis "
                f"({self.mesh.shape[self.ch_axis]}); got {x.shape}")
        # one program per t_count (jit re-specializes on lead shapes
        # internally); bounded like the module-level graph caches — a
        # directory of varying-length files must not accumulate compiled
        # executables forever (FIFO eviction, oldest length first)
        if t_count not in self._jit_cache:
            while len(self._jit_cache) >= 8:
                self._jit_cache.pop(next(iter(self._jit_cache)))
            self._jit_cache[t_count] = self._build(t_count)
        f, L, slice_len = self._jit_cache[t_count]
        n = self.mesh.shape[self.axis]
        R, hop = pipe.reach, pipe.hop
        # padded coordinates: R·hop zeros on the left (so device 0's halo
        # exists), zeros on the right covering the last device's slice —
        # and at least the whole signal (trailing samples past the last
        # complete window still need a home; natural mode's R=0 slices
        # would otherwise undershoot len(x))
        need = max((n - 1) * (L * hop) + slice_len,
                   R * hop + x.shape[-1])
        x_pad = np.zeros(lead + (need,), np.float32)
        x_pad[..., R * hop: R * hop + x.shape[-1]] = x
        st = state if state is not None else PostState.init(
            lead + (pipe.rows,))
        vis, rgba, st_fin = f(x_pad, self.params, st)
        return vis[:t_count], rgba[:t_count], st_fin


def stream_signal_sharded(x: np.ndarray, settings: Settings, mesh: Mesh):
    """Hop-by-hop sharded streaming of a whole signal → (vis, rgba) host
    arrays, the sharded counterpart of ``emspec.stream.stream_signal``
    (zero-padded flush hops drain the pending ring identically)."""
    st = ShardedStream(settings, mesh)
    pipe = st.pipe
    x = np.asarray(x, np.float32)
    t_count = pipe.num_columns(x.shape[-1])
    if t_count <= 0:
        raise ValueError(f"need at least {pipe.n_max} samples")
    cols = []
    n_max, hop = pipe.n_max, pipe.hop
    zero_block = np.zeros((settings.channels, hop), np.float32)
    st.reset_window(x[..., :n_max])              # prime for hop 0
    for t in range(t_count + pipe.reach):
        if t < t_count:
            block = x[..., t * hop + n_max - hop: t * hop + n_max]
        else:
            if t == t_count:
                st.reset_window(None)            # flush: all-zero windows
            block = zero_block
        out = st.step(block)
        if out is not None:
            cols.append(out)
    cols.sort(key=lambda c: c[0])
    vis = np.stack([np.asarray(v) for _, v, _ in cols])
    rgba = np.stack([np.asarray(r) for _, _, r in cols])
    return vis, rgba
