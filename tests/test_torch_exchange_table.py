"""B4's launch tables (``ops/cuda_exchange.plan_card_sweeps`` and
``exchange_plan``), on the CPU.

The card runs one B4 launch per card and sweep, from a table with one
row per (quantity, shard) that card holds. The planner is pure, so its
tables are checked here with plain integers: the rows, the neighbours
(``mesh_neighbor``), the unit (the widest that divides every pointer and
every cell row of the table) and, through a numpy model of the kernel's
copy applied to the shards' bytes, the result (bitwise equal to the
twin ``exchange_axis_plain``). The plan cache returns the same plan for
the same buffers and a new one when a buffer is replaced.
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch import Dim3, Method, Radius
from stencil_tpu_torch.ops import cuda_exchange as cx
from stencil_tpu_torch.parallel.cuda_exchange import (
    exchange_shard_cuda, start_exchange_shard_cuda)
from stencil_tpu_torch.parallel.exchange import (dispatch_exchange,
                                                 exchange_shard)
from stencil_tpu_torch.parallel.mesh import mesh_neighbor

DIM = {0: 2, 1: 1, 2: 0}


def _shards(mesh, local, r_lo, r_hi, dtype, seed):
    """Padded shards of one quantity, radius (r_lo, r_hi) on every axis."""
    shape = tuple(n + r_lo + r_hi for n in local)
    g = np.random.default_rng(seed)
    n = mesh[0] * mesh[1] * mesh[2]
    return [(torch.from_numpy(g.standard_normal(shape)) * 1000).to(dtype)
            for _ in range(n)]


def _plan(fields, cards, axis, r_lo, r_hi, counts):
    return cx.plan_card_sweeps(
        [[t.data_ptr() for t in s] for s in fields],
        [tuple(s[0].shape) for s in fields],
        [s[0].element_size() for s in fields], cards, axis, r_lo, r_hi,
        counts)


def _apply(plan, fields):
    """The kernel's copy, in numpy, over the shards' bytes: for every
    row, both slabs, every run and unit of the run."""
    mem = {t.data_ptr(): t.view(torch.uint8).numpy().reshape(-1)
           for s in fields for t in s}
    for cs in plan:
        for row in cs.rows:
            e = dict(zip(cx.ENTRY_FIELDS, row))
            for side, dst in (("lo", e["right"]), ("hi", e["left"])):
                run = e[f"{side}_run"] * cs.unit
                for k in range(e["runs"]):
                    s0 = (e[f"{side}_src_off"] + k * e["stride"]) * cs.unit
                    d0 = (e[f"{side}_dst_off"] + k * e["stride"]) * cs.unit
                    mem[dst][d0:d0 + run] = mem[e["src"]][s0:s0 + run]


CASES = [
    # mesh, local (z, y, x), r_lo, r_hi, dtypes of the quantities, cards
    ((1, 2, 2), (4, 6, 8), 1, 1, [torch.float32], ["a"] * 4),
    ((1, 2, 2), (5, 6, 7), 2, 1, [torch.float32] * 8, ["a", "b", "a", "b"]),
    ((2, 2, 1), (3, 4, 6), 1, 2, [torch.float64, torch.float32], ["a"] * 4),
    ((1, 2, 4), (8, 4, 5), 3, 3, [torch.float32] * 8,
     ["a", "a", "b", "b", "c", "c", "d", "d"]),
    ((1, 2, 4), (6, 5, 3), 0, 2, [torch.bfloat16, torch.int16], ["a"] * 8),
]


@pytest.mark.parametrize("mesh,local,r_lo,r_hi,dtypes,cards", CASES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_plan_has_one_row_per_quantity_and_shard_of_each_card(
        mesh, local, r_lo, r_hi, dtypes, cards, axis):
    counts = Dim3(*mesh)
    fields = [_shards(mesh, local, r_lo, r_hi, dt, 70 + q)
              for q, dt in enumerate(dtypes)]
    plan = _plan(fields, cards, axis, r_lo, r_hi, counts)
    assert [cs.card for cs in plan] == list(dict.fromkeys(cards))
    seen = []
    for cs in plan:
        assert len(cs.rows) == len(cs.keys)
        for (q, i), row in zip(cs.keys, cs.rows):
            assert cards[i] == cs.card
            e = dict(zip(cx.ENTRY_FIELDS, row))
            s = fields[q]
            assert e["src"] == s[i].data_ptr()
            assert e["right"] == s[mesh_neighbor(i, counts, axis, 1)].data_ptr()
            assert e["left"] == s[mesh_neighbor(i, counts, axis, -1)].data_ptr()
            shape, size = tuple(s[i].shape), s[i].element_size()
            geo = cx._geometry(shape, size, axis, r_lo, r_hi, cx.widest_unit(
                int(np.prod(shape[DIM[axis] + 1:])) * size))
            scale = geo["unit"] // cs.unit
            for k in cx.ENTRY_FIELDS[3:]:
                want = geo[k] * (1 if k == "runs" else scale)
                assert e[k] == want, (k, e[k], want)
            seen.append((q, i))
        # the widest unit that divides every pointer and cell row
        vals = [p for row in cs.rows for p in row[:3]]
        vals += [int(np.prod(fields[q][0].shape[DIM[axis] + 1:]))
                 * fields[q][0].element_size() for q, _ in cs.keys]
        assert all(v % cs.unit == 0 for v in vals)
        assert cs.unit == 16 or any(v % (2 * cs.unit) for v in vals)
        assert cs.most == max(r["runs"] * max(r["lo_run"], r["hi_run"])
                              for r in (dict(zip(cx.ENTRY_FIELDS, row))
                                        for row in cs.rows))
    assert sorted(seen) == [(q, i) for q in range(len(dtypes))
                            for i in range(counts.flatten())]


@pytest.mark.parametrize("mesh,local,r_lo,r_hi,dtypes,cards", CASES)
def test_plan_applied_by_a_model_of_the_kernel_equals_the_twin(
        mesh, local, r_lo, r_hi, dtypes, cards):
    """Every sweep of the tables, copied unit by unit in numpy, leaves
    every shard of every quantity bitwise equal to the twin's sweeps."""
    counts = Dim3(*mesh)
    fields = [_shards(mesh, local, r_lo, r_hi, dt, 80 + q)
              for q, dt in enumerate(dtypes)]
    want = [[t.clone() for t in s] for s in fields]
    for axis in (0, 1, 2):
        _apply(_plan(fields, cards, axis, r_lo, r_hi, counts), fields)
        for s in want:
            cx.exchange_axis_plain(s, axis, r_lo, r_hi, counts)
    for q, (got, ref) in enumerate(zip(fields, want)):
        for i, (a, b) in enumerate(zip(got, ref)):
            assert torch.equal(a, b), (q, i)


def test_unit_narrows_to_the_least_aligned_pointer():
    shape = (6, 6, 8)
    ptrs = [[4096, 8192, 12288, 16384]]
    plan = cx.plan_card_sweeps(ptrs, [shape], [4], ["a"] * 4, 1, 1, 1,
                               Dim3(1, 2, 2))
    assert plan[0].unit == 16
    ptrs[0][2] += 4                      # one shard 4 bytes off
    plan = cx.plan_card_sweeps(ptrs, [shape], [4], ["a"] * 4, 1, 1, 1,
                               Dim3(1, 2, 2))
    assert plan[0].unit == 4
    # on two cards, only the table that touches shard 2 narrows: along y
    # it pairs with shard 3, along z with shard 0
    plan = cx.plan_card_sweeps(ptrs, [shape], [4], ["a", "a", "b", "b"],
                               1, 1, 1, Dim3(1, 2, 2))
    assert [cs.unit for cs in plan] == [16, 4]
    plan = cx.plan_card_sweeps(ptrs, [shape], [4], ["a", "b", "a", "b"],
                               2, 1, 1, Dim3(1, 2, 2))
    assert [cs.unit for cs in plan] == [4, 16]


def test_planner_refuses_a_wrong_shard_count_and_32_bit_overflow():
    with pytest.raises(ValueError, match="shards"):
        cx.plan_card_sweeps([[0, 16, 32]], [(4, 4, 4)], [4], ["a"] * 4, 0,
                            1, 1, Dim3(1, 2, 2))
    with pytest.raises(ValueError, match="2\\^31"):
        cx.plan_card_sweeps([[0, 4]], [(2048, 2048, 1024)], [4], ["a"] * 2,
                            2, 1, 1, Dim3(1, 1, 2))


def test_plan_cache_hits_for_the_same_buffers_and_rebuilds_for_new_ones():
    counts = Dim3(1, 2, 2)
    sweeps = [(0, 1, 1), (1, 1, 1), (2, 1, 1)]
    fields = [_shards((1, 2, 2), (4, 4, 4), 1, 1, torch.float32, 90 + q)
              for q in range(3)]
    plan = cx.exchange_plan(fields, sweeps, counts)
    assert len(plan.launches) == 3
    assert all(len(per_card) == 1 for per_card in plan.launches)
    assert cx.exchange_plan([list(s) for s in fields], sweeps, counts) is plan
    assert not plan.cuda and plan.args == []
    old = fields[1][2]
    fields[1][2] = old.clone()          # a buffer replaced
    new = cx.exchange_plan(fields, sweeps, counts)
    assert new is not plan
    rows = [row for cs in new.launches[0] for row in cs.rows]
    assert fields[1][2].data_ptr() in [r[0] for r in rows]
    assert old.data_ptr() not in [r[0] for r in rows]
    assert cx.exchange_plan(fields, sweeps, counts) is new
    # another sweep order, another mesh: other keys
    assert cx.exchange_plan(fields, sweeps[::-1], counts) is not new
    # a view with the same pointer but other strides is another buffer
    t = fields[0][0]
    fields[0][0] = t.transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cx.exchange_plan(fields, sweeps, counts)


def test_cpu_exchange_goes_to_the_twin_and_launches_nothing():
    """On CPU shards the whole exchange (every quantity, every sweep, the
    one-shard axis too) runs the twin: no launch, no plan, and the halos
    equal the slab copy's."""
    counts = Dim3(1, 2, 2)
    rad = Radius.constant(2)
    fields = [_shards((1, 2, 2), (4, 6, 5), 2, 2, dt, 95 + q)
              for q, dt in enumerate((torch.float32, torch.float64))]
    want = [[t.clone() for t in s] for s in fields]
    cx.reset_launch_counts()
    cx._PLANS.clear()
    fut = start_exchange_shard_cuda(fields, rad, counts)
    fut.wait()
    exchange_shard_cuda(fields[0], rad, counts)
    for s in want:
        exchange_shard(s, rad, counts)
        exchange_shard(s, rad, counts)
    assert cx.LAUNCHES["exchange_axis"] == 0
    assert len(cx._PLANS) == 0
    for got, ref in zip(fields, want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    d = {"a": [t.clone() for t in want[0]]}
    dispatch_exchange(d, rad, counts, Method.PallasDMA)
    assert cx.LAUNCHES["exchange_axis"] == 0
