"""emspec — streaming reassigned-spectrogram framework.

A ground-up JAX/XLA rebuild of the capabilities of effree/EM-Spec
(real-time reassigned-spectrogram visualizer; see SURVEY.md for the full
reference analysis).  Public API:

>>> from emspec import Settings, Stream, render
>>> cols = Stream(Settings()).push(samples)          # real-time path
>>> img = render(samples, Settings(mode="natural"))  # offline raster
"""

from emspec.config import (                                      # noqa: F401
    COLORMAPS, FFT_SIZES, MODE_ENHANCED, MODE_NATURAL,
    PresetStore, Settings, is_structural_change,
)

__version__ = "0.1.0"


def __getattr__(name):
    # heavy modules (jax import) load lazily so `import emspec` stays cheap
    if name == "Stream":
        from emspec.stream import Stream
        return Stream
    if name == "stream_signal":
        from emspec.stream import stream_signal
        return stream_signal
    if name == "Pipeline":
        from emspec.pipeline import Pipeline
        return Pipeline
    if name == "get_pipeline":
        from emspec.pipeline import get_pipeline
        return get_pipeline
    if name == "prewarm":
        from emspec.pipeline import prewarm
        return prewarm
    if name == "Waterfall":
        from emspec.render.waterfall import Waterfall
        return Waterfall
    if name == "EmSpecApp":
        from emspec.app import EmSpecApp
        return EmSpecApp
    if name == "ShardedPipeline":
        from emspec.parallel import ShardedPipeline
        return ShardedPipeline
    if name == "ShardedStream":
        from emspec.parallel import ShardedStream
        return ShardedStream
    if name == "channel_mesh":
        from emspec.parallel import channel_mesh
        return channel_mesh
    if name == "ch_time_mesh":
        from emspec.parallel import ch_time_mesh
        return ch_time_mesh
    if name == "TimeParallelRenderer":
        from emspec.parallel import TimeParallelRenderer
        return TimeParallelRenderer
    if name == "animate_frames":
        from emspec.render.animate import animate_frames
        return animate_frames
    if name == "write_apng":
        from emspec.render.apng import write_apng
        return write_apng
    if name == "read_apng":
        from emspec.render.apng import read_apng
        return read_apng
    raise AttributeError(f"module 'emspec' has no attribute {name!r}")


def render(samples, settings: Settings | None = None):
    """Offline convenience: audio (samples,) → RGBA image (rows, t, 4).

    Multires settings use the log-frequency display pipeline; otherwise
    the single-bank linear-frequency raster."""
    s = settings or Settings()
    if s.multires:
        from emspec.pipeline import render_image_multires
        return render_image_multires(samples, s)
    from emspec.render.raster import render_image
    return render_image(samples, s)
