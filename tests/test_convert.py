"""Interop conformance (reference oracle: ``/root/reference/test/
test_convert.py``) — scipy and jax.experimental.sparse bridges."""
import jax.numpy as jnp
import numpy as np

from paddle_sparse_jax import (SparseTensor, from_jax_sparse, from_scipy,
                               to_jax_sparse, to_scipy)


def test_convert_scipy():
    index = jnp.asarray([[0, 0, 1, 2, 2], [0, 2, 1, 0, 1]])
    value = jnp.asarray([1, 2, 4, 1, 3])
    N = 3

    out = from_scipy(to_scipy(index, value, N, N))
    assert out[0].tolist() == index.tolist()
    assert out[1].tolist() == value.tolist()


def test_convert_jax_sparse():
    index = jnp.asarray([[0, 0, 1, 2, 2], [0, 2, 1, 0, 1]])
    value = jnp.asarray([1, 2, 4, 1, 3])
    N = 3

    out = from_jax_sparse(to_jax_sparse(index, value, N, N).sum_duplicates())
    assert out[0].tolist() == index.tolist()
    assert out[1].tolist() == value.tolist()


def test_tensor_scipy_roundtrip():
    dense = np.asarray([[0, 1.0, 0], [2, 0, 3], [0, 0, 4]])
    mat = SparseTensor.from_dense(jnp.asarray(dense))
    for layout in ("coo", "csr", "csc"):
        sp = mat.to_scipy(layout=layout)
        np.testing.assert_array_equal(sp.toarray(), dense)
        back = SparseTensor.from_scipy(sp)
        np.testing.assert_array_equal(np.asarray(back.to_dense()), dense)


def test_tensor_bcoo_roundtrip():
    dense = np.asarray([[0, 1.0, 0], [2, 0, 3], [0, 0, 4]])
    mat = SparseTensor.from_dense(jnp.asarray(dense))
    bcoo = mat.to_jax_bcoo()
    np.testing.assert_array_equal(np.asarray(bcoo.todense()), dense)
    back = SparseTensor.from_jax_bcoo(bcoo)
    np.testing.assert_array_equal(np.asarray(back.to_dense()), dense)
