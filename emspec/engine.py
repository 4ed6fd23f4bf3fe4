"""Engine choices: the one place where the pipeline picks a formulation
by device and shape.

Every op has a plain XLA formulation that runs on any backend and that
the CPU suite pins bit-exact (streaming ≡ batch, DESIGN.md §5).  A
choice here switches to another formulation only on the GPU, and only
where it was timed faster on the card at the shapes the product runs
(``python chip_smoke.py --engines``; the numbers and the card they were
taken on are in PERF.md, "Bring-up findings (H100)").  Keying on the
platform keeps the CPU pins bit-exact: the alternatives reassociate
float sums.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when the default JAX backend is a CUDA GPU."""
    return jax.default_backend() == "gpu"


def associative_ema() -> bool:
    """Batch EMA recurrences of the post chain (post/chain.py) as
    ``lax.associative_scan`` instead of the sequential ``lax.scan``.

    On the GPU the sequential scan is a device loop of ⌈t/8⌉ iterations;
    the associative form is ~2·log2(t) fused sweeps and was timed faster
    at every t from 90 to 5937 columns.  Reassociation moves f32 rounding
    by ~log2(t)·ε relative (~1e-6 at display-scale t), far under the
    display's 1/255 quantum; the sequential scan stays bit-identical to
    the per-column streaming step, which the CPU suite pins."""
    return on_gpu()
