"""Roofline accounting for the bench report.

Per display column, estimates the arithmetic (FLOPs) and device-memory
traffic (bytes) of each pipeline stage from the structural
configuration.  The harness reports achieved TFLOP/s and GB/s and their
share of the card's published peaks next to columns/sec.

These are *model* numbers (documented formulas below), not counters:
trust them for trends, not absolutes.
"""

from __future__ import annotations

import numpy as np

# Published peaks by ``jax.Device.device_kind``.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM5 part, dense rates (no sparsity) at the
# 700 W power limit; a card set below that limit cannot hold them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "f32_tflops": 67.0,
        "hbm_gbs": 3350.0,
    },
}


def peaks_for(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r} "
            f"(known: {sorted(PEAKS)})") from None


def stage_costs(pipe) -> dict:
    """Per-stage {flops, bytes} per emitted display column.

    Stage models (C = channels, per bank of size N with K kept bins
    after band-support slicing):

    * analysis (rfft): one complex N-FFT ≈ 5·N·log2(N) flops + stencil
      recombination and corrections ≈ 42·K.
    * scatter: 8 flops/deposit; traffic dominates (read the deposits,
      read-modify-write the cells).
    * merge (natural): 2 gathers + lerp per row per bank ≈ 6·rows.
    * post chain + LUT: ≈ 25 flops/row (dB log10 counted as 10) + RGBA
      out.
    """
    s = pipe.settings
    C = max(s.channels, 1)
    rows = pipe.rows
    enhanced = s.mode == "enhanced"
    stages: dict = {}

    an_flops = 0.0
    an_bytes = 0.0
    m_total = 0
    for n, (k_lo, k_hi) in zip(pipe.sizes, pipe.k_slices):
        K = k_hi - k_lo
        m_total += K
        an_flops += C * (2 * n + 5 * n * np.log2(n))
        an_bytes += C * (4 * 2 * n + 8 * (n + 3 * K))
        if enhanced:
            an_flops += C * (12 * K + 30 * K)
            an_bytes += C * 4 * 2 * K
    stages["analysis"] = {"flops": float(an_flops), "bytes": float(an_bytes)}

    if enhanced:
        S = (2 * pipe.reach + 1) * rows
        stages["scatter"] = {
            "flops": float(C * 8 * m_total),
            "bytes": float(C * (8 * m_total + 4 * S) * 2),
        }
    else:
        stages["merge"] = {
            "flops": float(C * 6 * rows * len(pipe.sizes)),
            "bytes": float(C * 4 * rows * len(pipe.sizes) * 3),
        }

    stages["post"] = {
        "flops": float(C * 25 * rows),
        "bytes": float(C * (4 * rows * 3 + 4 * rows)),
    }
    return stages


def estimate_column_cost(pipe, stages: dict | None = None) -> dict:
    """Summed FLOPs + device-memory bytes per emitted display column."""
    if stages is None:
        stages = stage_costs(pipe)
    flops = sum(st["flops"] for st in stages.values())
    bytes_ = sum(st["bytes"] for st in stages.values())
    m_total = sum(k_hi - k_lo for (k_lo, k_hi) in pipe.k_slices)
    return {"flops_per_col": flops, "bytes_per_col": bytes_,
            "deposits_per_col": int(max(pipe.settings.channels, 1) * m_total)}


def roofline_report(pipe, cols_per_sec: float, device_kind: str) -> dict:
    """Achieved rates and their share of ``device_kind``'s published
    peaks for a measured throughput, with the per-stage estimates."""
    peak = peaks_for(device_kind)
    stages = stage_costs(pipe)           # once: headline sums and the
    est = estimate_column_cost(pipe, stages)   # breakdown always reconcile
    tflops = est["flops_per_col"] * cols_per_sec / 1e12
    gbs = est["bytes_per_col"] * cols_per_sec / 1e9
    return {
        "device_kind": device_kind,
        "est_flops_per_col": round(est["flops_per_col"] / 1e6, 3),  # MFLOP
        "est_mb_per_col": round(est["bytes_per_col"] / 1e6, 4),
        "achieved_tflops": round(tflops, 3),
        "achieved_gbs": round(gbs, 2),
        "pct_f32_peak": round(100 * tflops / peak["f32_tflops"], 2),
        "pct_hbm_peak": round(100 * gbs / peak["hbm_gbs"], 2),
        "arith_intensity_flops_per_byte": round(
            est["flops_per_col"] / max(est["bytes_per_col"], 1.0), 2),
        "stages": {
            name: {"mflop_per_col": round(st["flops"] / 1e6, 3),
                   "kb_per_col": round(st["bytes"] / 1e3, 2)}
            for name, st in stages.items()
        },
    }
