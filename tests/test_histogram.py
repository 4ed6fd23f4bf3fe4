"""The reassignment scatter-add (emspec.dsp.histogram) against a plain
numpy ``np.add.at`` histogram."""

import jax.numpy as jnp
import numpy as np

from emspec.dsp.histogram import histogram_reference


def _np_hist(ids, vals, num_bins):
    """Reference: drop ids outside [0, num_bins), add the rest in float64."""
    ids = np.asarray(ids)
    vals = np.asarray(vals, np.float64)
    out = np.zeros(ids.shape[:-1] + (num_bins,))
    keep = (ids >= 0) & (ids < num_bins)
    flat = out.reshape(-1, num_bins)
    for r, (i, v, k) in enumerate(zip(ids.reshape(-1, ids.shape[-1]),
                                      vals.reshape(-1, vals.shape[-1]),
                                      keep.reshape(-1, keep.shape[-1]))):
        np.add.at(flat[r], i[k], v[k])
    return out


def test_histogram_matches_add_at():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, 5000).astype(np.int32)
    vals = rng.random(5000).astype(np.float32)
    got = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals),
                                         300))
    np.testing.assert_allclose(got, _np_hist(ids, vals, 300), rtol=1e-5)


def test_histogram_drops_out_of_range_and_negative_ids():
    ids = np.array([-1, 0, 3, 4, 7, -5, 2], np.int32)
    vals = np.array([10., 1., 2., 100., 1000., 7., 3.], np.float32)
    got = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals),
                                         4))
    np.testing.assert_array_equal(got, [1.0, 0.0, 3.0, 2.0])


def test_histogram_nonfinite_values_at_dropped_ids_contribute_nothing():
    """A NaN/Inf carried by a dropped deposit (id -1 or past the end)
    must not poison any kept cell."""
    ids = np.array([-1, 1, 9, 1, 0], np.int32)
    vals = np.array([np.nan, 2.0, np.inf, 0.5, -np.inf], np.float32)
    vals[4] = 1.0
    got = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals),
                                         3))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, [1.0, 2.5, 0.0])


def test_histogram_batched_lead_dims():
    """(..., M) ids/vals give one histogram per leading element."""
    rng = np.random.default_rng(1)
    ids = rng.integers(-3, 70, (2, 3, 400)).astype(np.int32)
    vals = rng.random((2, 3, 400)).astype(np.float32)
    got = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals),
                                         64))
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(got, _np_hist(ids, vals, 64), rtol=1e-5)


def test_histogram_conserves_in_range_energy():
    """The scatter only moves value: the total equals the sum of the
    in-range deposits."""
    rng = np.random.default_rng(2)
    ids = rng.integers(-50, 1050, 20000).astype(np.int32)
    vals = (rng.random(20000) * 1e-3).astype(np.float32)
    got = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals),
                                         1000))
    keep = (ids >= 0) & (ids < 1000)
    np.testing.assert_allclose(got.sum(), vals[keep].astype(np.float64).sum(),
                               rtol=1e-5)
