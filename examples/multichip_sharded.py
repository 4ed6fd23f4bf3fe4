"""Channel sharding over a device mesh (SURVEY.md §2.5/§5.8): same
pipeline, channels spread across devices, zero code change — GSPMD
inserts the one global-AGC all-reduce.  Runs on an 8-device virtual CPU
mesh here; on a multi-GPU host, drop the lines that force the
virtual CPU mesh and channel_mesh() picks up the real cards."""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from emspec import Settings, ShardedPipeline, channel_mesh
from emspec.io import synth

mesh = channel_mesh()
s = Settings(mode="enhanced", multires=True, channels=8, agc_global=True)
sp = ShardedPipeline(s, mesh)
x = np.stack([synth.tone(220.0 * (c + 1), 0.2) for c in range(8)])
vis, rgba, state = sp.process(x)
print("devices:", len(mesh.devices), "| vis", vis.shape,
      "| sharded over", len(vis.sharding.device_set), "devices")
