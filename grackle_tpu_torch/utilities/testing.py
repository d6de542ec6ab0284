"""Testing helpers (port of grackle_tpu/utilities/testing.py; mirror of
grackle: src/python/pygrackle/utilities/testing.py:21-56)."""

import numpy as np


def assert_rel_equal(a1, a2, decimals, err_msg="", verbose=True):
    """Assert relative equality to the given number of significant digits,
    masking NaNs present in both arrays."""
    a1 = np.asarray(a1)
    a2 = np.asarray(a2)
    # tricky NaN handling as in the reference helper
    if isinstance(a1, np.ndarray):
        assert a1.size == a2.size
        if np.any(np.isnan(a1)) and np.any(np.isnan(a2)):
            assert np.all(np.isnan(a1) == np.isnan(a2)), \
                "NaN mismatch: %s" % err_msg
            a1 = a1[~np.isnan(a1)]
            a2 = a2[~np.isnan(a2)]
    np.testing.assert_almost_equal(
        np.asarray(a1) / np.asarray(a2), 1.0, decimals,
        err_msg=err_msg, verbose=verbose,
    )


def random_logscale(log_min, log_max, size=1, random_state=None):
    if random_state is None:
        random_state = np.random.RandomState()
    log_val = (log_max - log_min) * random_state.random_sample(size) \
        + log_min
    return np.power(10, log_val)
