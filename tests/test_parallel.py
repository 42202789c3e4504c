"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

import libpoporon_jax as pp
from libpoporon_jax.config import LdpcConfig, LdpcRate
from libpoporon_jax.parallel import ShardedCodec, batch_mesh
from libpoporon_jax.parallel.mesh import shard_batch


needs_multi = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple devices"
)


@needs_multi
def test_mesh_has_8_devices():
    mesh = batch_mesh()
    assert mesh.shape["batch"] == 8


@needs_multi
def test_sharded_rs_decode():
    codec = pp.create(pp.rs_config_default())
    sc = ShardedCodec(codec)
    rng = np.random.default_rng(0)
    B = 24  # not divisible by 8 — exercises padding
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(codec.encode(data).parity)
    bad = data.copy()
    bad[:, 17] ^= 0x3C
    res = sc.decode(bad, parity)
    assert np.asarray(res.ok).shape == (B,)
    assert bool(np.asarray(res.ok).all())
    np.testing.assert_array_equal(np.asarray(res.data), data)


@needs_multi
def test_sharded_matches_single_device():
    codec = pp.create(pp.rs_config_default())
    sc = ShardedCodec(codec)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (16, 223), dtype=np.uint8)
    parity = np.asarray(codec.encode(data).parity)
    bad = data.copy()
    bad[:, 3] ^= 0x77
    r_sharded = sc.decode(bad, parity)
    r_local = codec.decode(bad, parity)
    np.testing.assert_array_equal(np.asarray(r_sharded.data), np.asarray(r_local.data))
    np.testing.assert_array_equal(np.asarray(r_sharded.ok), np.asarray(r_local.ok))


@needs_multi
def test_ldpc_shard_map_step_with_psum_stats():
    codec = pp.create(LdpcConfig(block_size=32, rate=LdpcRate.RATE_1_2))
    sc = ShardedCodec(codec)
    rng = np.random.default_rng(2)
    B = 16
    info = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    parity = np.asarray(codec._ldpc.encode(info))
    cw = np.concatenate([info, parity], axis=1)
    bad = cw.copy()
    bad[:, 5] ^= 0x08
    ok, out, iters, stats = sc.ldpc_decode_step(bad)
    assert stats["converged"] == B
    np.testing.assert_array_equal(np.asarray(out), cw)


@needs_multi
def test_dryrun_multichip_entrypoint():
    import sys
    sys.path.insert(0, ".")
    import __graft_entry__ as g
    g.dryrun_multichip(len(jax.devices()))


@needs_multi
def test_stats_axis_name_contract():
    """ber_stats/iteration_histogram: axis_name must be bound (psum) or
    None (local); a wrong axis name raises instead of silently
    reporting per-shard statistics as global ones."""
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from libpoporon_jax.parallel import ber_stats, iteration_histogram
    from libpoporon_jax.parallel.mesh import batch_mesh

    mesh = batch_mesh()
    ref = np.zeros((16, 8), np.int32)
    out = ref.copy()
    out[:, 0] = 1                         # 16 bit errors over 128 bits

    # local mode (outside any collective scope)
    st = ber_stats(jnp.asarray(ref), jnp.asarray(out), axis_name=None)
    assert int(st["errors"]) == 16 and int(st["total"]) == 128

    # psum mode inside shard_map: per-shard errors sum to the global 16
    @partial(jax.shard_map, mesh=mesh, in_specs=(P("batch"), P("batch")),
             out_specs=P())
    def global_stats(r, o):
        s = ber_stats(r, o, axis_name="batch")
        return jnp.stack([s["errors"], s["total"]])

    g = np.asarray(global_stats(jnp.asarray(ref), jnp.asarray(out)))
    assert g[0] == 16 and g[1] == 128

    # wrong axis name: raises (NameError from jax), never silently local
    @partial(jax.shard_map, mesh=mesh, in_specs=(P("batch"), P("batch")),
             out_specs=P())
    def wrong_axis(r, o):
        s = ber_stats(r, o, axis_name="no_such_axis")
        return jnp.stack([s["errors"], s["total"]])

    with pytest.raises(Exception):
        np.asarray(wrong_axis(jnp.asarray(ref), jnp.asarray(out)))

    # histogram in both modes
    it = jnp.asarray(np.arange(16) % 4, jnp.int32)
    h = np.asarray(iteration_histogram(it, 4, axis_name=None))
    assert h.sum() == 16

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("batch"),), out_specs=P())
    def ghist(i):
        return iteration_histogram(i, 4, axis_name="batch")

    hg = np.asarray(ghist(it))
    assert hg.sum() == 16 and (hg == h).all()
