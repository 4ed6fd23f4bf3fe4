"""Benchmark: prints the device, the card's power limit, and ONE JSON line
with the primary metric.

Primary metric (BASELINE.json): reassigned-spectrogram frames/sec at
8192-pt FFT on one GPU.  The reference publishes no numbers
(distribution-only repo), so ``vs_baseline`` is the ratio to the 60 fps
sustained-display north-star target.  Run the full report with
``python -m emspec bench``.  Without a GPU it exits non-zero.
"""

import json
import subprocess
import sys


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them (read
    by a child process, which never touches JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return r.stdout.strip() or f"unavailable (rc {r.returncode})"


def main() -> int:
    from emspec.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from emspec.bench.harness import primary_metric, require_gpu
    try:
        device = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(f"device: {device['platform']} {device['kind']} "
          f"x{device['count']}; nvidia-smi: {power_limit()}")
    print(json.dumps(primary_metric(quick="--quick" in sys.argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
