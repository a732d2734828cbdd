"""The port's op library against the JAX package's: the ops whose name
starts with ``m`` to ``z`` (the rest, the coverage check and the rule
each op is held to are in ``test_torch_ops_library.py``)."""
import pytest

from test_torch_ops_library import check_against_jax, keys


@pytest.mark.parametrize("key", keys("m", "z"))
def test_op_matches_the_jax_op(key):
    check_against_jax(key)
