"""The port's generators against the JAX package's: the same seeds give
the same arrays (tolerance 0)."""

import numpy as np
import pytest

from sparse_linear_assignment_tpu.generators import (
    gen_batch_ksparse as jax_gen_batch_ksparse,
)
from sparse_linear_assignment_tpu_torch import generators


@pytest.mark.parametrize(
    "seed,b,n,m,k",
    [(0, 3, 8, 32, 4), (7, 5, 16, 64, 8), (123, 2, 24, 48, 5),
     (20261016, 4, 128, 512, 8)],
)
def test_gen_batch_ksparse_equals_jax_package(seed, b, n, m, k):
    cols, vals = generators.gen_batch_ksparse(seed, b, n, m, k)
    jcols, jvals = jax_gen_batch_ksparse(seed, b, n, m, k)
    assert cols.dtype == jcols.dtype and vals.dtype == jvals.dtype
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(vals, jvals)
    assert cols.shape == (b, n, k)
    # k distinct, sorted columns per person; integer values in range
    assert (np.diff(cols, axis=2) > 0).all()
    assert cols.min() >= 0 and cols.max() < m
    assert (vals == np.floor(vals)).all()
    assert vals.min() >= 300 and vals.max() < 1000


def test_gen_batch_ksparse_value_range_arguments():
    cols, vals = generators.gen_batch_ksparse(
        1, 2, 8, 16, 3, min_value=10.0, range_width=5.0)
    jcols, jvals = jax_gen_batch_ksparse(
        1, 2, 8, 16, 3, min_value=10.0, range_width=5.0)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(vals, jvals)
    assert vals.min() >= 10 and vals.max() < 15
