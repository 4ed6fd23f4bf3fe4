"""Channel-sharded processing on the virtual 8-device CPU mesh
(SURVEY.md §2.5/§5.8; the driver's dryrun covers the same path)."""

import jax
import numpy as np
import pytest

from emspec.config import Settings
from emspec.parallel import ShardedPipeline, channel_mesh
from emspec.pipeline import Pipeline
from emspec.io import synth

SR = 48_000



# device counts are read inside fixtures, never at import: every xdist
# worker must collect the same tests
@pytest.fixture
def _mesh_devices():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")


@pytest.fixture
def _mesh_4_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs a 2×2+ (ch × t) mesh")


needs_mesh = pytest.mark.usefixtures("_mesh_devices")
needs_4dev = pytest.mark.usefixtures("_mesh_4_devices")


def _settings(**kw):
    kw.setdefault("mode", "enhanced")
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (1024, 512))
    kw.setdefault("raster_height", 128)
    kw.setdefault("hop", 256)
    return Settings(**kw)


@needs_mesh
@pytest.mark.slow
def test_sharded_matches_single_device():
    n_dev = len(jax.devices())
    s = _settings(channels=2 * n_dev, smoothing=0.4)
    x = np.stack([synth.tone(200.0 * (c + 1), 0.1, SR)
                  for c in range(s.channels)])
    mesh = channel_mesh()
    sp = ShardedPipeline(s, mesh)
    vis_sh, rgba_sh, state_sh = sp.process(x)
    vis_1, rgba_1, state_1 = Pipeline(s).process(x)
    np.testing.assert_allclose(np.asarray(vis_sh), np.asarray(vis_1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(state_sh.agc_ref),
                               np.asarray(state_1.agc_ref), atol=1e-4)
    # outputs really are sharded over the mesh
    assert len(vis_sh.sharding.device_set) == n_dev


@needs_mesh
@pytest.mark.slow
def test_sharded_global_agc_collective():
    """agc_global=True forces a cross-chip all-reduce; references must be
    identical on every shard."""
    n_dev = len(jax.devices())
    s = _settings(channels=n_dev, agc_global=True)
    x = np.stack([(10.0 ** -c) * synth.tone(440.0, 0.08, SR)
                  for c in range(s.channels)])      # wildly uneven levels
    sp = ShardedPipeline(s, channel_mesh())
    _, _, state = sp.process(x)
    refs = np.asarray(state.agc_ref)
    np.testing.assert_allclose(refs, refs[0], atol=1e-5)


@needs_mesh
def test_sharded_rejects_indivisible_channels():
    s = _settings(channels=3)
    if len(jax.devices()) in (1, 3):
        pytest.skip("degenerate mesh size")
    with pytest.raises(ValueError, match="divisible"):
        ShardedPipeline(s, channel_mesh())


@needs_mesh
@pytest.mark.slow
def test_sharded_stream_matches_batch():
    """Streaming ≡ batch under channel sharding (VERDICT round-2 #3b):
    the production _stream_step jitted over the mesh with the full
    donated carry must reproduce the sharded batch output.  Under GSPMD
    the partitioner may reassociate float ops between the two programs,
    so the single-chip CPU bit-exact pin relaxes here to ulp-level
    (measured max 6e-8 abs on vis; rgba may flip one 1/255 quantum
    where vis sits on a LUT boundary)."""
    from emspec.parallel import ShardedStream, stream_signal_sharded

    n_dev = len(jax.devices())
    s = _settings(channels=n_dev, smoothing=0.35, agc_global=True,
                  auto_gain=True)
    x = np.stack([synth.chirp(150.0 * (c + 1), 3000.0, 0.1, SR)
                  for c in range(s.channels)])
    mesh = channel_mesh()
    vis_st, rgba_st = stream_signal_sharded(x, s, mesh)
    sp = ShardedPipeline(s, mesh)
    vis_b, rgba_b, _ = sp.process(x)
    np.testing.assert_allclose(vis_st, np.asarray(vis_b), atol=1e-6)
    dq = np.abs(rgba_st.astype(np.int16) - np.asarray(rgba_b).astype(np.int16))
    assert dq.max() <= 1 and (dq != 0).mean() < 0.01
    # the per-hop outputs really are sharded and the carry is donated
    st = ShardedStream(s, mesh)
    st.reset_window(x[:, :st.pipe.n_max])
    out = None
    t = 0
    n_max, hop = st.pipe.n_max, st.pipe.hop
    while out is None:
        out = st.step(x[:, t * hop + n_max - hop: t * hop + n_max])
        t += 1
    _, vis, _ = out
    assert len(vis.sharding.device_set) == n_dev


@needs_mesh
def test_sharded_stream_rejects_indivisible_channels():
    from emspec.parallel import ShardedStream

    if len(jax.devices()) in (1, 3):
        pytest.skip("degenerate mesh size")
    with pytest.raises(ValueError, match="divisible"):
        ShardedStream(_settings(channels=3), channel_mesh())


@needs_mesh
def test_sharded_step_collective_structure():
    """Pin the comm design in the compiled HLO (SURVEY §5.8): the
    reassignment pipeline is channel-local, so the sharded streaming step
    carries NO all-reduce — until agc_global couples the channels, which
    must introduce exactly the cross-channel reduction and nothing else
    (no all-to-all / collective-permute resharding creeping in)."""
    from emspec.parallel import ShardedStream

    n_dev = len(jax.devices())
    mesh = channel_mesh()

    def compiled_text(agc_global: bool) -> str:
        st = ShardedStream(_settings(channels=n_dev,
                                     agc_global=agc_global), mesh)
        block = jax.device_put(
            np.zeros((n_dev, st.pipe.hop), np.float32), st._sh_block)
        return st._step.lower(st._carry, block,
                              st.params).compile().as_text()

    local = compiled_text(False)
    coupled = compiled_text(True)
    assert "all-reduce" not in local, \
        "channel-local step must not communicate"
    assert "all-reduce" in coupled, \
        "global AGC must lower to a cross-channel all-reduce"
    for txt, name in ((local, "local"), (coupled, "coupled")):
        assert "all-to-all" not in txt and "collective-permute" not in txt, \
            f"unexpected resharding collective in the {name} step"


@needs_mesh
@pytest.mark.slow
def test_sharded_stream_elastic_checkpoint_resume():
    """Checkpoint/resume × multichip (SURVEY §5.4 × §5.8): snapshot a
    sharded stream mid-flight to a HOST pytree, resume it on a mesh of a
    DIFFERENT size (elastic restart — fewer devices after a failure),
    and the continuation must match the uninterrupted run exactly
    (the snapshot is host numpy, so resharding is just device_put)."""
    from emspec.parallel import ShardedStream

    n_dev = len(jax.devices())
    assert n_dev >= 4
    s = _settings(channels=n_dev, smoothing=0.3, auto_gain=True)
    x = np.stack([synth.chirp(120.0 * (c + 1), 2500.0, 0.1, SR)
                  for c in range(s.channels)])

    def feed(st, t):
        n_max, hop = st.pipe.n_max, st.pipe.hop
        if t == 0:
            st.reset_window(x[:, :n_max])
        return st.step(x[:, t * hop + n_max - hop: t * hop + n_max])

    # uninterrupted reference on the full mesh
    ref = ShardedStream(s, channel_mesh())
    n_hops = ref.pipe.num_columns(x.shape[-1])
    ref_cols = [feed(ref, t) for t in range(n_hops)]

    # interrupted twin: snapshot at the midpoint...
    a = ShardedStream(s, channel_mesh())
    mid = n_hops // 2
    cols = [feed(a, t) for t in range(mid)]
    snap = a.state_pytree()
    # every leaf is host numpy — a real checkpoint, not aliased device
    # buffers the next step would donate away
    for leaf in jax.tree_util.tree_leaves(snap["carry"]):
        assert isinstance(leaf, np.ndarray)

    # ...and resume on a HALVED mesh
    b = ShardedStream(s, channel_mesh(jax.devices()[: n_dev // 2]))
    b.load_state(snap)
    cols += [feed(b, t) for t in range(mid, n_hops)]

    got = [(i, np.asarray(v)) for c in cols if c is not None
           for i, v, _ in [c]]
    want = [(i, np.asarray(v)) for c in ref_cols if c is not None
            for i, v, _ in [c]]
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)


@needs_mesh
def test_sharded_stream_npz_checkpoint_roundtrip(tmp_path):
    """The sharded snapshot persists through the same no-pickle .npz
    format as the single-chip stream (utils/checkpoint)."""
    from emspec.parallel import ShardedStream
    from emspec.utils.checkpoint import (load_sharded_stream,
                                         save_sharded_stream)

    n_dev = len(jax.devices())
    s = _settings(channels=n_dev, smoothing=0.4)
    x = np.stack([synth.tone(200.0 * (c + 1), 0.1, SR)
                  for c in range(s.channels)])
    def blk(st, t):
        return x[:, t * st.pipe.hop + st.pipe.n_max - st.pipe.hop:
                 t * st.pipe.hop + st.pipe.n_max]

    a = ShardedStream(s, channel_mesh())
    hops = a.pipe.num_columns(x.shape[-1])
    a.reset_window(x[:, :a.pipe.n_max])
    for t in range(hops // 2):
        a.step(blk(a, t))
    save_sharded_stream(tmp_path / "ck", a)

    b = ShardedStream(s, channel_mesh(jax.devices()[: max(n_dev // 2, 1)]))
    load_sharded_stream(tmp_path / "ck", b)
    for t in range(hops // 2, hops):
        w = blk(a, t)
        oa, ob = a.step(w), b.step(w)
        if oa is None:
            assert ob is None
            continue
        assert oa[0] == ob[0]
        np.testing.assert_allclose(np.asarray(oa[1]), np.asarray(ob[1]),
                                   atol=1e-6)


@needs_mesh
def test_sharded_checkpoint_migration_guards_step(tmp_path):
    """A pre-rolling-window sharded snapshot (round-4 carry layout
    change) migrates with a ZEROED window.  ShardedStream owns no ring
    to re-prime from, so the restored stream must REFUSE to step until
    ``reset_window`` re-primes it — a silent zero-window resume would
    emit wrong columns — and after re-priming the continuation must
    match the uninterrupted stream."""
    from emspec.parallel import ShardedStream
    from emspec.utils.checkpoint import (load_sharded_stream,
                                         save_sharded_stream)

    n_dev = len(jax.devices())
    s = _settings(channels=n_dev, smoothing=0.4)
    x = np.stack([synth.tone(200.0 * (c + 1), 0.1, SR)
                  for c in range(s.channels)])

    def blk(st, t):
        return x[:, t * st.pipe.hop + st.pipe.n_max - st.pipe.hop:
                 t * st.pipe.hop + st.pipe.n_max]

    a = ShardedStream(s, channel_mesh())
    hops = a.pipe.num_columns(x.shape[-1])
    mid = hops // 2
    a.reset_window(x[:, :a.pipe.n_max])
    for t in range(mid):
        a.step(blk(a, t))
    ck = tmp_path / "ck"
    save_sharded_stream(ck, a)

    # rewrite the npz in the OLD layout: drop the window leaf (carry_0)
    # and renumber the inner leaves down (same forgery as
    # test_ops.test_checkpoint_migrates_pre_rolling_layout)
    z = dict(np.load(tmp_path / "ck.npz", allow_pickle=False))
    n_carry = sum(1 for k in z if k.startswith("carry_"))
    old = {k: v for k, v in z.items() if not k.startswith("carry_")}
    for i in range(1, n_carry):
        old[f"carry_{i - 1}"] = z[f"carry_{i}"]
    np.savez(tmp_path / "ck.npz", **old)

    b = ShardedStream(s, channel_mesh())
    assert load_sharded_stream(ck, b) is True       # migrated
    with pytest.raises(RuntimeError, match="reset_window"):
        b.step(blk(b, mid))

    # the guard travels with a snapshot: saving the migrated-but-unprimed
    # stream must not launder its zeroed window into a "clean" file
    ck2 = tmp_path / "ck2"
    save_sharded_stream(ck2, b)
    c = ShardedStream(s, channel_mesh())
    assert load_sharded_stream(ck2, c) is True
    with pytest.raises(RuntimeError, match="reset_window"):
        c.step(blk(c, mid))
    # re-prime with the window at the resume point: hop `mid` analyzes
    # x[:, mid*hop : mid*hop + n_max], whose completing block is
    # blk(mid) — exactly the reset_window feed-protocol contract
    hop, n_max = b.pipe.hop, b.pipe.n_max
    b.reset_window(x[:, mid * hop: mid * hop + n_max])
    for t in range(mid, hops):
        w = blk(a, t)
        oa, ob = a.step(w), b.step(w)
        if oa is None:
            assert ob is None
            continue
        assert oa[0] == ob[0]
        np.testing.assert_allclose(np.asarray(oa[1]), np.asarray(ob[1]),
                                   atol=1e-6)

    # a later HEALTHY load on the same (stale-guarded) stream object
    # must clear the guard, not leave the stream permanently refusing
    ck3 = tmp_path / "ck3"
    save_sharded_stream(ck3, a)
    assert load_sharded_stream(ck3, c) is False
    assert c.needs_window_prime is False
    c.step(np.zeros((s.channels, a.pipe.hop), np.float32))  # no raise


@needs_mesh
@pytest.mark.slow
def test_time_parallel_render_matches_single_device():
    """TIME-axis offline rendering (the other parallel seam, SURVEY
    §2.5): halo-recompute analysis + affine EMA re-basing must equal the
    single-device batch to the EMA-reassociation tolerance, with RGBA
    quantum-exact, across modes and with multichannel global AGC."""
    from emspec.parallel import TimeParallelRenderer

    n_dev = len(jax.devices())
    for mode, mr, ch in (("enhanced", True, 1), ("natural", False, 1),
                         ("enhanced", True, 2)):
        s = _settings(mode=mode, multires=mr, channels=ch,
                      smoothing=0.4, auto_gain=True, agc_global=ch > 1)
        one = synth.chirp(150.0, 8000.0, 1.1, SR)
        x = (np.stack([one * (c + 1) for c in range(ch)])
             if ch > 1 else np.asarray(one, np.float32))
        r = TimeParallelRenderer(s, channel_mesh(axis="t"))
        vis, rgba, st = r.render(x)
        vis1, rgba1, st1 = Pipeline(s).process(x)
        np.testing.assert_allclose(np.asarray(vis), np.asarray(vis1),
                                   atol=1e-5)
        dq = np.abs(np.asarray(rgba).astype(np.int16)
                    - np.asarray(rgba1).astype(np.int16))
        assert dq.max() <= 1
        np.testing.assert_allclose(np.asarray(st.smooth),
                                   np.asarray(st1.smooth), atol=1e-5)
        np.testing.assert_allclose(np.asarray(st.agc_ref),
                                   np.asarray(st1.agc_ref), atol=1e-4)
        # really sharded over the mesh, L columns per device
        assert len(vis.sharding.device_set) == n_dev


@needs_mesh
def test_time_parallel_render_collective_census():
    """Pin the comm design: the whole time-parallel render ships only
    the two (n_dev, …) EMA chunk-final all_gathers and the final-state
    psum — the analysis halo is RECOMPUTED, never communicated (no
    all-to-all / collective-permute / extra all-reduces creeping in)."""
    from emspec.parallel import TimeParallelRenderer
    from emspec.post.chain import PostState

    s = _settings(mode="enhanced", smoothing=0.4, auto_gain=True)
    x = np.asarray(synth.chirp(150.0, 8000.0, 1.1, SR), np.float32)
    r = TimeParallelRenderer(s, channel_mesh(axis="t"))
    t_count = r.pipe.num_columns(len(x))
    f, L, slice_len = r._build(t_count)
    n = len(jax.devices())
    R, hop = r.pipe.reach, r.pipe.hop
    need = max((n - 1) * (L * hop) + slice_len, R * hop + len(x))
    x_pad = np.zeros(need, np.float32)
    state = PostState.init((r.pipe.rows,))
    txt = f.lower(x_pad, r.params, state).compile().as_text()
    n_ag = txt.count(" all-gather(") + txt.count(" all-gather-start(")
    n_ar = txt.count(" all-reduce(") + txt.count(" all-reduce-start(")
    assert n_ag == 2, f"expected exactly 2 all-gathers, found {n_ag}"
    assert n_ar <= 2, f"unexpected all-reduces: {n_ar}"   # psum on 2 state leaves
    assert "all-to-all" not in txt and "collective-permute" not in txt


@needs_mesh
@pytest.mark.slow
def test_time_parallel_render_uneven_tail():
    """t_count not divisible by the mesh: the padded tail columns must
    neither appear in the output nor leak into the final post state."""
    from emspec.parallel import TimeParallelRenderer

    s = _settings(mode="enhanced", smoothing=0.5, auto_gain=True)
    r = TimeParallelRenderer(s, channel_mesh(axis="t"))
    hop, n_max = r.pipe.hop, r.pipe.n_max
    n_dev = len(jax.devices())
    # pick a sample count giving t_count ≡ 3 (mod n_dev)
    t_target = 2 * n_dev + 3
    x = np.asarray(synth.chirp(200.0, 6000.0,
                               ((t_target - 1) * hop + n_max) / SR, SR),
                   np.float32)[: (t_target - 1) * hop + n_max]
    assert r.pipe.num_columns(len(x)) == t_target
    vis, _, st = r.render(x)
    vis1, _, st1 = Pipeline(s).process(x)
    assert vis.shape[0] == t_target == vis1.shape[0]
    np.testing.assert_allclose(np.asarray(vis), np.asarray(vis1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st.smooth),
                               np.asarray(st1.smooth), atol=1e-5)


@needs_4dev
@pytest.mark.slow
def test_time_parallel_render_2d_ch_time_mesh():
    """Round-5 composition (VERDICT r4 #2): the channel seam and the
    time seam in ONE shard_map program over a (ch × t) mesh — equality
    vs the single-device batch with multichannel global AGC (the pmax
    crossing the channel axis), both modes."""
    from emspec.parallel import TimeParallelRenderer, ch_time_mesh

    n_dev = len(jax.devices())
    mesh = ch_time_mesh(2)
    n_t = n_dev // 2
    for mode, mr in (("enhanced", True), ("natural", False)):
        s = _settings(mode=mode, multires=mr, channels=4, smoothing=0.4,
                      auto_gain=True, agc_global=True)
        one = synth.chirp(150.0, 8000.0, 1.1, SR)
        x = np.stack([np.asarray(one, np.float32) * (c + 1)
                      for c in range(4)])
        r = TimeParallelRenderer(s, mesh)
        vis, rgba, st = r.render(x)
        vis1, rgba1, st1 = Pipeline(s).process(x)
        np.testing.assert_allclose(np.asarray(vis), np.asarray(vis1),
                                   atol=1e-5)
        dq = np.abs(np.asarray(rgba).astype(np.int16)
                    - np.asarray(rgba1).astype(np.int16))
        assert dq.max() <= 1
        np.testing.assert_allclose(np.asarray(st.smooth),
                                   np.asarray(st1.smooth), atol=1e-5)
        np.testing.assert_allclose(np.asarray(st.agc_ref),
                                   np.asarray(st1.agc_ref), atol=1e-4)
        # global AGC really coupled ACROSS the sharded channel axis
        refs = np.asarray(st.agc_ref)
        np.testing.assert_allclose(refs, refs[0], atol=1e-5)
        assert len(vis.sharding.device_set) == n_dev
        # replication-proof: the final state is channel-sharded —
        # ch/2 rows per device, replicated over t
        assert {sh.data.shape for sh in st.smooth.addressable_shards} \
            == {(2, r.pipe.rows)}


@needs_4dev
def test_time_parallel_2d_collective_census_and_shards():
    """Comm design of the composed program: the two EMA all_gathers and
    the 2-leaf final-state psum cross the TIME axis; with agc_global
    the ONE extra collective is the channel-axis pmax.  Per-device
    input/output shard shapes must scale as ch/n_ch × t/n_t (no silent
    replication)."""
    from emspec.parallel import TimeParallelRenderer, ch_time_mesh
    from emspec.post.chain import PostState

    mesh = ch_time_mesh(2)
    n_t = mesh.shape["t"]

    def census(agc_global):
        s = _settings(mode="enhanced", channels=4, smoothing=0.4,
                      auto_gain=True, agc_global=agc_global)
        x = np.stack([np.asarray(synth.chirp(150.0, 8000.0, 1.1, SR),
                                 np.float32)] * 4)
        r = TimeParallelRenderer(s, mesh)
        t_count = r.pipe.num_columns(x.shape[-1])
        f, L, slice_len = r._build(t_count)
        R, hop = r.pipe.reach, r.pipe.hop
        need = max((n_t - 1) * (L * hop) + slice_len,
                   R * hop + x.shape[-1])
        x_pad = np.zeros((4, need), np.float32)
        state = PostState.init((4, r.pipe.rows))
        txt = f.lower(x_pad, r.params, state).compile().as_text()
        n_ag = txt.count(" all-gather(") + txt.count(" all-gather-start(")
        n_ar = txt.count(" all-reduce(") + txt.count(" all-reduce-start(")
        assert "all-to-all" not in txt and "collective-permute" not in txt
        # outputs of the compiled program shard over BOTH axes
        vis, rgba, st = f(x_pad, r.params, state)
        assert {sh.data.shape for sh in vis.addressable_shards} \
            == {(L, 2, r.pipe.rows)}
        assert {sh.data.shape for sh in st.agc_ref.addressable_shards} \
            == {(2,)}
        return n_ag, n_ar

    ag0, ar0 = census(agc_global=False)
    ag1, ar1 = census(agc_global=True)
    assert ag0 == ag1 == 2, f"expected exactly 2 all-gathers ({ag0}/{ag1})"
    # 2-leaf state psum (+ fusion variance); the global-AGC pmax adds
    # EXACTLY one collective — the only cross-channel communication
    assert ar1 == ar0 + 1, f"AGC pmax must add exactly 1 all-reduce " \
                           f"({ar0} -> {ar1})"
    assert ar0 <= 2


@needs_mesh
def test_time_parallel_2d_mesh_validation():
    """Constructor contract: a 2-D mesh needs a 't' axis and channels
    divisible by the channel axis; render() rejects mono input."""
    from emspec.parallel import TimeParallelRenderer, ch_time_mesh
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:2]).reshape(2, 1)
    with pytest.raises(ValueError, match="axis .*named 't'"):
        TimeParallelRenderer(_settings(channels=2),
                             Mesh(devs, ("a", "b")))
    with pytest.raises(ValueError, match="divisible"):
        TimeParallelRenderer(_settings(channels=3),
                             Mesh(devs, ("ch", "t")))
    r = TimeParallelRenderer(_settings(channels=2), Mesh(devs, ("ch", "t")))
    with pytest.raises(ValueError, match="channels, samples"):
        r.render(np.zeros(40_000, np.float32))


@needs_mesh
def test_sharded_step_partitions_buffers_as_ch_over_n():
    """Replication-proof (round-3 VERDICT #3b): the collective-structure
    pin alone would pass on a silently fully-replicated program.  Assert
    the compiled step's per-device parameter and output buffers really
    scale as ch/n — via the compiled input shardings' shard shapes AND
    the runtime shards of the live carry/window/column buffers."""
    from emspec.parallel import ShardedStream

    n_dev = len(jax.devices())
    s = _settings(channels=n_dev, agc_global=True)
    mesh = channel_mesh()
    st = ShardedStream(s, mesh)
    per = s.channels // n_dev
    n_max, hop, rows = st.pipe.n_max, st.pipe.hop, st.pipe.rows

    block = jax.device_put(np.zeros((n_dev, hop), np.float32),
                           st._sh_block)
    # compiled parameter shardings: block AND the carry's rolling
    # window must shard to ch/n rows
    compiled = st._step.lower(st._carry, block, st.params).compile()
    (carry_sh, block_sh, _), _ = compiled.input_shardings
    assert block_sh.shard_shape((n_dev, hop)) == (per, hop)
    win_sh, inner_sh = carry_sh
    assert win_sh.shard_shape((n_dev, n_max)) == (per, n_max)
    acc_global = st._carry[1][1].shape               # (P, ch, rows)
    assert inner_sh[1].shard_shape(acc_global) \
        == (acc_global[0], per, acc_global[2])

    # runtime buffers: rolling window, carry ring, and the emitted
    # column all hold exactly one ch/n slice per device
    assert {sh.data.shape for sh in st._carry[0].addressable_shards} \
        == {(per, n_max)}
    assert {sh.data.shape for sh in st._carry[1][1].addressable_shards} \
        == {(acc_global[0], per, acc_global[2])}
    carry, (vis, rgba, _) = st._step(st._carry, block, st.params)
    st._carry = carry
    assert {sh.data.shape for sh in vis.addressable_shards} \
        == {(per, rows)}
    assert {sh.data.shape for sh in rgba.addressable_shards} \
        == {(per, rows, 4)}
    assert len(vis.addressable_shards) == n_dev
