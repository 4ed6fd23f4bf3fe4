"""Four-step (Bailey / Cooley-Tukey) FFT as matmuls.

The four-step decomposition N = N1·N2 turns the transform into two
*small dense matmuls* (N1² and N2² DFT matrices) + one elementwise
twiddle (SURVEY.md §7 anticipated this as the "4-step decomposition"
escape hatch).  It is selectable as ``Settings.fft_impl="fourstep"``;
"auto" resolves to XLA's rfft.

With x reshaped row-major to (N1, N2), n = N2·n1 + n2, k = k1 + N1·k2:

    A[k1, n2] = Σ_{n1} x[n1, n2]·W_{N1}^{n1·k1}        (matmul over n1)
    B[k1, n2] = A[k1, n2]·W_N^{n2·k1}                  (twiddle)
    X[k1, k2] = Σ_{n2} B[k1, n2]·W_{N2}^{n2·k2}        (matmul over n2)
    out[k1 + N1·k2] = X[k1, k2]

Complex arithmetic is explicit (separate real/imag matmuls) with
``Precision.HIGHEST`` so results hold float32 accuracy — a lower
precision lets the GPU multiply in TF32, which would wreck the
reassignment corrections.

Streaming and batch agree to float32 rounding, not bitwise (matmul
accumulation order may depend on the batch shape) — asserted in
tests/test_fourstep.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# factorizations: near-square, second factor ≥ first
_FACTORS = {
    256: (16, 16),
    512: (16, 32), 1024: (32, 32), 2048: (32, 64), 4096: (64, 64),
    8192: (64, 128), 16384: (128, 128), 32768: (128, 256),
    65536: (256, 256), 131072: (256, 512), 262144: (512, 512),
}

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _tables(n: int):
    """(C1, S1, TWr, TWi, C2, S2) float32 numpy tables for size n."""
    n1, n2 = _FACTORS[n]
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    a1 = 2.0 * np.pi * np.outer(i1, i1) / n1          # (k1, n1)
    a2 = 2.0 * np.pi * np.outer(i2, i2) / n2          # (n2, k2)
    tw = 2.0 * np.pi * np.outer(i1, i2) / n           # (k1, n2)
    return (np.cos(a1).astype(np.float32), np.sin(a1).astype(np.float32),
            np.cos(tw).astype(np.float32), np.sin(tw).astype(np.float32),
            np.cos(a2).astype(np.float32), np.sin(a2).astype(np.float32))


def supported(n: int) -> bool:
    return n in _FACTORS


def _mm(a, b):
    """(..., m, k) @ (k, n) — full-precision matmul.

    All leading/batch dims fold into M: one big GEMM instead of a batched
    stack of tiny ones ((11520, 64)@(64, 64) rather than ninety
    (128, 64)@(64, 64) products).
    """
    lead = a.shape[:-1]
    out = jnp.matmul(a.reshape(-1, a.shape[-1]), b, precision=_HI)
    return out.reshape(lead + (b.shape[-1],))


def fft_fourstep(z_r: jnp.ndarray, z_i: jnp.ndarray
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full complex DFT of z = z_r + i·z_i, shape (..., n) → (..., n)."""
    n = z_r.shape[-1]
    n1, n2 = _FACTORS[n]
    lead = z_r.shape[:-1]
    xr = z_r.reshape(lead + (n1, n2))
    xi = z_i.reshape(lead + (n1, n2))
    C1, S1, TWr, TWi, C2, S2 = (jnp.asarray(t) for t in _tables(n))

    # step 1: A = (C1 − i·S1) @ x, contraction over n1 — expressed as a
    # direct dot_general over the -2 axis (einsum) so XLA chooses layouts
    # instead of materializing four explicit transposes
    def dot1(m, x):
        return jnp.einsum("kj,...jn->...kn", m, x, precision=_HI)
    Ar = dot1(C1, xr) + dot1(S1, xi)                   # C1@xr + S1@xi
    Ai = dot1(C1, xi) - dot1(S1, xr)                   # C1@xi − S1@xr

    # step 2: twiddle (k1, n2) elementwise
    Br = Ar * TWr + Ai * TWi
    Bi = Ai * TWr - Ar * TWi

    # step 3: X[k1, k2] = Σ_{n2} B[k1, n2]·(C2 − i·S2)[n2, k2]
    Xr = _mm(Br, C2) + _mm(Bi, S2)
    Xi = _mm(Bi, C2) - _mm(Br, S2)

    # step 4: out[k1 + N1·k2] → transpose (k2, k1) then flatten
    Xr = jnp.swapaxes(Xr, -1, -2).reshape(lead + (n,))
    Xi = jnp.swapaxes(Xi, -1, -2).reshape(lead + (n,))
    return Xr, Xi


def rfft_fourstep(x: jnp.ndarray) -> jnp.ndarray:
    """Real-input DFT → complex64 (..., n//2+1), matching jnp.fft.rfft.

    Classic half-size packing: even/odd samples become real/imag of one
    N/2-point complex four-step FFT, untangled by the Hermitian split —
    half the matmul work of a full-N complex transform with zero imag.
    Per-frame and batch-shape-agnostic in structure (the same caveat as
    the rest of this module: matmul rounding may differ across batch
    shapes; the bit-exact engine is fft_impl="xla")."""
    n = x.shape[-1]
    h = n // 2
    if h not in _FACTORS:                    # n == 512 → h=256 is covered;
        Xr, Xi = fft_fourstep(x, jnp.zeros_like(x))   # fallback, exact
        return jax.lax.complex(Xr[..., :h + 1], Xi[..., :h + 1])
    lead = x.shape[:-1]
    x2 = x.reshape(lead + (h, 2))
    Zr, Zi = fft_fourstep(x2[..., 0], x2[..., 1])      # N/2-point complex
    # Hermitian split at k = 0..N/2 (indices (−k) mod N/2) — concat+flip,
    # layout ops rather than a gather
    Zr_k = jnp.concatenate([Zr, Zr[..., :1]], axis=-1)  # Z(k), k=0..h
    Zi_k = jnp.concatenate([Zi, Zi[..., :1]], axis=-1)
    Zr_c = jnp.concatenate(                             # Re Z(h−k), k=0..h
        [Zr[..., :1], jnp.flip(Zr[..., 1:], -1), Zr[..., :1]], axis=-1)
    Zi_c = -jnp.concatenate(                            # Im conj(Z(h−k))
        [Zi[..., :1], jnp.flip(Zi[..., 1:], -1), Zi[..., :1]], axis=-1)
    Er = 0.5 * (Zr_k + Zr_c)
    Ei = 0.5 * (Zi_k + Zi_c)
    Or = 0.5 * (Zi_k - Zi_c)                            # −i(Z−Zc)/2, real part
    Oi = 0.5 * (Zr_c - Zr_k)
    # X(k) = E(k) + W_N^k · O(k),  W_N^k = cos − i·sin
    ang = np.pi * np.arange(h + 1) / h                  # 2πk/N
    c = jnp.asarray(np.cos(ang).astype(np.float32))
    s = jnp.asarray(np.sin(ang).astype(np.float32))
    Xr = Er + c * Or + s * Oi
    Xi = Ei + c * Oi - s * Or
    return jax.lax.complex(Xr, Xi)


def packed_pair_fft(a: jnp.ndarray, b: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """DFTs of two real signals via ONE complex four-step FFT.

    z = a + i·b; unpack by Hermitian split:
        A(k) = (Z(k) + conj(Z(N−k)))/2,  B(k) = −i·(Z(k) − conj(Z(N−k)))/2

    Returns complex64 (..., n//2+1) for each.  The packing is part of the
    numeric spec of the enhanced path: streaming and batch both pack the
    same way, so bit-exactness between them is preserved.
    """
    n = a.shape[-1]
    Zr, Zi = fft_fourstep(a, b)
    # conj(Z(N−k)) for k=0..K−1: index 0 maps to 0, else reversed —
    # as concat+flip (layout ops), not an elementwise gather
    Zr_c = jnp.concatenate([Zr[..., :1], jnp.flip(Zr[..., 1:], -1)], axis=-1)
    Zi_c = -jnp.concatenate([Zi[..., :1], jnp.flip(Zi[..., 1:], -1)], axis=-1)
    k = n // 2 + 1
    Ar = 0.5 * (Zr[..., :k] + Zr_c[..., :k])
    Ai = 0.5 * (Zi[..., :k] + Zi_c[..., :k])
    Br = 0.5 * (Zi[..., :k] - Zi_c[..., :k])
    Bi = 0.5 * (Zr_c[..., :k] - Zr[..., :k])
    return jax.lax.complex(Ar, Ai), jax.lax.complex(Br, Bi)
