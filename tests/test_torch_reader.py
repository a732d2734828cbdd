"""``reader`` of the PyTorch port (its own copy of the JAX module, which
is pure Python) against the JAX package's, on the CPU: each decorator
gives the same items in the same order (``shuffle`` under one
``random.seed``), ``xmap_readers`` keeps the order when asked and relays
a mapper's error, ``buffered`` relays a reader's, ``compose`` raises
``ComposeNotAligned`` on readers of different lengths.
"""
import random

import pytest

from paddle_tpu import reader as jreader
from paddle_tpu_torch import reader as treader


def _count(n, start=0):
    def read():
        yield from range(start, start + n)
    return read


def _both(fn):
    return [list(fn(mod)()) for mod in (jreader, treader)]


@pytest.mark.parametrize("case", [
    lambda r: r.cache(_count(5)),
    lambda r: r.map_readers(lambda a, b: a * b, _count(4), _count(4, 3)),
    lambda r: r.chain(_count(2), _count(3, 10)),
    lambda r: r.compose(_count(3), r.map_readers(lambda a: (a, -a),
                                                 _count(3))),
    lambda r: r.compose(_count(3), _count(5), check_alignment=False),
    lambda r: r.firstn(_count(10), 4),
    lambda r: r.buffered(_count(7), 2),
    lambda r: r.xmap_readers(lambda a: a * 10, _count(20), 3, 4, order=True),
    lambda r: r.multiprocess_reader([_count(2), _count(2, 5)]),
])
def test_decorators_give_the_jax_items(case):
    jax_items, port_items = _both(case)
    assert port_items == jax_items


def test_shuffle_draws_as_the_jax_one():
    outs = []
    for mod in (jreader, treader):
        random.seed(3)
        outs.append(list(mod.shuffle(_count(23), 5)()))
    assert outs[0] == outs[1] and sorted(outs[1]) == list(range(23))


def test_unordered_xmap_and_the_errors():
    got = list(treader.xmap_readers(lambda a: a + 1, _count(50), 4, 8)())
    assert sorted(got) == list(range(1, 51))

    def bad(a):
        if a == 7:
            raise KeyError("mapper")
        return a

    with pytest.raises(KeyError, match="mapper"):
        list(treader.xmap_readers(bad, _count(20), 2, 4)())

    def broken():
        yield 1
        raise OSError("reader")

    with pytest.raises(OSError, match="reader"):
        list(treader.buffered(broken, 2)())
    with pytest.raises(treader.ComposeNotAligned):
        list(treader.compose(_count(3), _count(4))())
    assert issubclass(treader.ComposeNotAligned, ValueError)
