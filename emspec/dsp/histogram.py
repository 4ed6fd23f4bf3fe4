"""The reassignment scatter-add: a keyed histogram over a flat cell space.

One formulation serves every device: ``jax.ops.segment_sum``, which XLA
lowers to a scatter-add (atomic adds on the GPU, so the float summation
order — and the last bits of a cell shared by several deposits — can
vary from run to run there; the CPU order is fixed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def histogram_reference(ids, vals, num_bins):
    """Scatter-add ``vals`` into ``num_bins`` cells keyed by ``ids``.

    ids:  (..., M) int32 — an id outside [0, num_bins) contributes
          nothing, whatever its value (callers encode a dropped deposit
          as id = -1 instead of masking)
    vals: (..., M) float32
    →     (..., num_bins) float32, one histogram per leading element
    """
    lead = ids.shape[:-1]

    def one(i, v):
        ok = (i >= 0) & (i < num_bins)
        # dropped ids go to a spill cell that is sliced off, and their
        # values are zeroed so a non-finite value at a dropped id cannot
        # reach any kept cell
        safe = jnp.where(ok, i, num_bins)
        masked = jnp.where(ok, v, 0.0)
        return jax.ops.segment_sum(masked, safe,
                                   num_segments=num_bins + 1)[:num_bins]

    if lead:
        b = int(np.prod(lead))
        out = jax.vmap(one)(ids.reshape(b, -1), vals.reshape(b, -1))
        return out.reshape(lead + (num_bins,))
    return one(ids.reshape(-1), vals.reshape(-1))
