"""Offline rendering sharded over the TIME axis (SURVEY.md §2.5): a long
recording's spectrogram computed N× faster on an N-device mesh — the
other parallel seam next to channel sharding (multichip_sharded.py).
Runs on an 8-device virtual CPU mesh here; on a multi-GPU host, drop
the lines that force it and channel_mesh() picks up the real cards.

Design (emspec/parallel.py TimeParallelRenderer): each device analyzes
its own column span plus a ±R frame halo (halo RECOMPUTE — boundary
deposits are regenerated locally, never communicated), and the post
chain's two constant-α EMA recurrences hand state across devices via
one all_gather of per-chunk finals + an exact affine re-basing."""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from emspec import Settings, TimeParallelRenderer, channel_mesh
from emspec.io import synth
from emspec.pipeline import Pipeline

s = Settings(mode="enhanced", multires=True, multires_sizes=(1024, 512),
             raster_height=128, hop=256)
x = np.asarray(synth.chirp(100.0, 8000.0, 2.0), np.float32)

mesh = channel_mesh(axis="t")
r = TimeParallelRenderer(s, mesh)
vis, rgba, state = r.render(x)

vis1, _, _ = Pipeline(s).process(x)
print("devices:", len(mesh.devices),
      "| columns:", vis.shape[0],
      "| sharded over", len(vis.sharding.device_set), "devices",
      "| max |Δvis| vs single-device:",
      float(np.abs(np.asarray(vis) - np.asarray(vis1)).max()))

# ---- composed (ch × t) 2-D mesh (round 5): both seams in ONE program.
# A multichannel recording shards channels AND time together — the
# offline-render-on-a-pod case (e.g. the 16-channel stress config).
# The analysis stays channel-local; with global AGC the per-column
# reference crosses the channel axis as a single pmax.
from emspec import ch_time_mesh

s2 = s.replace(channels=2, agc_global=True)
x2 = np.stack([x, np.asarray(synth.multitone([440.0], 2.0), np.float32)])
mesh2 = ch_time_mesh(n_ch=2)                       # 2 × 4 on 8 devices
vis2, _, _ = TimeParallelRenderer(s2, mesh2).render(x2)
vis2_ref, _, _ = Pipeline(s2).process(x2)
print("2-D mesh:", dict(zip(mesh2.axis_names, mesh2.devices.shape)),
      "| max |Δvis| vs single-device:",
      float(np.abs(np.asarray(vis2) - np.asarray(vis2_ref)).max()))
