"""Version/buildtime (spec: reference tests/test_basic.c)."""

import libpoporon_jax as pp


def test_version_id():
    assert pp.version_id() == 20000000


def test_buildtime():
    assert isinstance(pp.buildtime(), int)
