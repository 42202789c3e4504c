"""Erasure list lifecycle (spec: reference tests/test_erasure.c)."""

import numpy as np

from libpoporon_jax import Erasure
from libpoporon_jax.erasure import positions_batch


def test_lifecycle():
    e = Erasure(32)
    assert e.count == 0
    e.add_position(5)
    e.add_position(10)
    assert e.count == 2
    np.testing.assert_array_equal(e.positions, [5, 10])
    e.reset()
    assert e.count == 0


def test_growth_past_capacity():
    e = Erasure(4, initial_capacity=2)
    for i in range(100):
        e.add_position(i)
    assert e.count == 100
    np.testing.assert_array_equal(e.positions, np.arange(100))


def test_from_positions():
    e = Erasure.from_positions(32, [1, 2, 3])
    assert e.count == 3


def test_positions_batch_broadcast():
    pos, cnt = positions_batch([3, 7], e_max=4, batch=5)
    assert pos.shape == (5, 4)
    assert (cnt == 2).all()
    np.testing.assert_array_equal(pos[0], [3, 7, 0, 0])


def test_positions_batch_from_erasure():
    e = Erasure.from_positions(8, [9])
    pos, cnt = positions_batch(e, e_max=8, batch=2)
    assert pos.shape == (2, 8)
    assert (cnt == 1).all()
