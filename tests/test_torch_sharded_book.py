"""The port's sharded single-curve book and ``distributed.py`` on the CPU:
``shard_book``, ``make_sharded_book_fn`` and ``make_pershard_aggregate_fn``
across two gloo processes (``torch_dist_cases.book_ranks``) on the quick
start's 20 OIS tiled x4 with seeded coupon and notional scales, against
the JAX package's functions on a 2-device virtual CPU mesh (its
``make_pershard_aggregate_fn`` takes the whole book's aggregate, the
port's each rank's shard's) and against the port's single-device
``make_book_fn``; ``shard_book`` refuses a trade count that does not
divide; ``init_distributed`` is a no-op without an address or torchrun's
environment, refuses an address without a world size and rank, and
returns False at world 1 (making the group, or finding it) and True at
world 2, as the JAX function does;
``book_mesh`` is 1-D on one host; ``run_ranks`` fails at once when a rank
fails while another waits in a collective.

Tolerances: against JAX, the JAX package's own
(``tests/test_parallel_book.py:131-138``: total PV rtol 1e-12, delta rtol
1e-10, gamma rtol 1e-8 atol 1e-10; gamma symmetric rtol 1e-10 atol
1e-12); against the port's single-device function 1e-12 x max|ref| (f64
sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as tdist
from jax.sharding import Mesh

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import adrates_tpu.parallel.book as jbook
import adrates_torch.parallel.book as tbook
import torch_dist_cases as dc
from adrates_torch.parallel import distributed
from adrates_torch.utils import LibError

WORLD = 2


@pytest.fixture(scope="module")
def ranks():
    return dc.run_ranks(WORLD, dc.book_ranks, timeout_s=600)


@pytest.fixture(scope="module")
def jax_out():
    curve, _, tiled = dc.book_case("adrates_tpu")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("book",))
    rates = jnp.asarray(curve.swap_rates)
    shocks = jnp.asarray(dc.book_shocks())
    sharded = jbook.make_sharded_book_fn(curve._plan, curve._interp_type,
                                         mesh)(
        rates, jbook.shard_book(tiled, mesh), shocks)
    pershard = jbook.make_pershard_aggregate_fn(
        curve._plan, curve._interp_type, mesh)(
        rates, jbook.aggregate_book(tiled), shocks)
    return {name: {k: np.asarray(v) for k, v in out.items()}
            for name, out in (("sharded", sharded), ("pershard", pershard))}


@pytest.fixture(scope="module")
def port_ref():
    curve, _, tiled = dc.book_case("adrates_torch")
    fn = tbook.make_book_fn(curve._plan, curve._interp_type, device="cpu")
    out = fn(np.asarray(curve.swap_rates), tiled,
             tbook.aggregate_book(tiled), dc.book_shocks())
    return dict(total_pv=out["pvs"].sum(dim=1).numpy(),
                delta=out["delta"].numpy(), gamma=out["gamma"].numpy())


@pytest.mark.parametrize("name", ["sharded", "pershard"])
def test_matches_jax(ranks, jax_out, name):
    got, ref = ranks[0][name], jax_out[name]
    np.testing.assert_allclose(got["total_pv"], ref["total_pv"], rtol=1e-12)
    np.testing.assert_allclose(got["delta"], ref["delta"], rtol=1e-10)
    np.testing.assert_allclose(got["gamma"], ref["gamma"], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("name", ["sharded", "pershard"])
@pytest.mark.parametrize("key", ["total_pv", "delta", "gamma"])
def test_matches_single_device(ranks, port_ref, name, key):
    got, ref = ranks[0][name][key], port_ref[key]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["sharded", "pershard"])
def test_every_rank_holds_the_result_and_gamma_is_symmetric(ranks, name):
    for r in ranks[1:]:
        for k, v in ranks[0][name].items():
            np.testing.assert_array_equal(r[name][k], v)
    g = ranks[0][name]["gamma"]
    np.testing.assert_allclose(g, g.transpose(0, 2, 1), rtol=1e-10,
                               atol=1e-12)


def test_shard_book_slices_and_refuses_an_uneven_book(ranks):
    _, _, tiled = dc.book_case("adrates_torch")
    for r in ranks:
        assert r["trades"] == tiled.num_trades // WORLD
        assert r["odd_raises"]
        assert r["dims"] == ["book"]


def test_init_distributed_is_a_noop_alone(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not tdist.is_initialized()
    assert distributed.init_distributed() is False
    assert not tdist.is_initialized()


def test_init_distributed_needs_world_and_rank_with_an_address():
    with pytest.raises(LibError):
        distributed.init_distributed(address="127.0.0.1:1", device="cpu")
    assert not tdist.is_initialized()


def test_init_distributed_at_world_1_makes_a_group_and_returns_false(
        tmp_path):
    """An explicit world of 1 makes its group but is no multi-process
    runtime, so the call returns False, as the JAX function's
    ``jax.process_count() > 1``; a second call returns False and keeps
    the group. The group is destroyed here, so no other test sees it."""
    assert not tdist.is_initialized()
    try:
        first = distributed.init_distributed(
            address=f"file://{tmp_path}/store", world_size=1, rank=0,
            backend="gloo")
        group = tdist.group.WORLD
        assert first is False
        assert tdist.is_initialized() and tdist.get_world_size() == 1
        again = distributed.init_distributed(
            address=f"file://{tmp_path}/other", world_size=1, rank=0,
            backend="gloo")
        assert again is False
        assert tdist.group.WORLD is group and tdist.get_world_size() == 1
        assert not (tmp_path / "other").exists()
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    assert not tdist.is_initialized()


def test_init_distributed_at_world_2_returns_true(tmp_path):
    """Two spawned ranks: True with the group already active and True
    after making a new one."""
    out = dc.run_ranks(WORLD, dc.init_ranks, (f"file://{tmp_path}/store",),
                       timeout_s=120)
    assert out == [dict(again=True, fresh=True, size=WORLD)] * WORLD


def test_book_mesh_needs_a_group():
    with pytest.raises(LibError):
        distributed.book_mesh()


def test_sharded_book_pvs_go_through_k1_on_the_shard(ranks):
    """Each rank's call swept its own trades once through
    ``kernels.pvs_sweep`` (the CPU twin here, so counted by a wrapper)."""
    for r in ranks:
        assert r["k1_calls"] == [r["trades"]]


def test_run_ranks_fails_fast_on_a_failed_rank():
    """A rank that raises while another waits in a collective fails the
    world at once with the failing rank's traceback, the waiting rank
    terminated."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*ValueError"):
        dc.run_ranks(WORLD, dc.failing_rank, timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_collectives_take_non_contiguous_tensors(ranks):
    """``all_reduce`` sums a transposed tensor over the ranks;
    ``all_gather`` concatenates transposed parts of different sizes in
    rank order."""
    want = WORLD * np.arange(6.0).reshape(2, 3).T
    gathered = np.concatenate([np.full((r + 1, 3), float(r))
                               for r in range(WORLD)])
    for r in ranks:
        np.testing.assert_array_equal(r["reduced_t"], want)
        np.testing.assert_array_equal(r["gathered_t"], gathered)
