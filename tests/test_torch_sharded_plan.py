"""The launch plan of the node-sharded scan (``kernels._sharded_launch_plan``):
which (batch row, shard) pairs each card's launch covers at every step,
and which offer copies cross cards.  Pure bookkeeping on ``torch.device``
objects: no card is needed."""

import pytest
import torch

from nomad_tpu_torch.ops import kernels as k

P = 16
CARDS = [torch.device("cuda", i) for i in range(4)]


def rows_of(devices, batch):
    """The devices of a mesh's batch rows (``sharding.make_mesh``'s
    layout: row i holds devices[i·per:(i+1)·per])."""
    per = len(devices) // batch
    return [devices[i * per:(i + 1) * per] for i in range(batch)]


@pytest.mark.parametrize("n_dev", [4, 8])
def test_virtual_mesh_is_one_launch_a_step_and_no_copy(n_dev):
    groups = rows_of([CARDS[0]] * n_dev, 2)
    plan = k._sharded_launch_plan(groups, P)
    assert len(plan.launches) == P + 1
    pairs = tuple((i, j) for i in range(2) for j in range(n_dev // 2))
    for step in range(P + 1):
        assert plan.launches[step] == ((CARDS[0], pairs),)
        assert plan.copies[step] == ()
    assert sum(len(s) for s in plan.launches) == P + 1


def test_every_card_mesh_copies_only_between_cards():
    groups = rows_of(CARDS, 2)  # rows [0, 1] and [2, 3]
    plan = k._sharded_launch_plan(groups, P)
    for step in range(P):
        assert sorted(d.index for d, _ in plan.launches[step]) == [0, 1, 2, 3]
        for dev, pairs in plan.launches[step]:
            assert pairs == ((dev.index // 2, dev.index % 2),)
    # The last step only writes the result: the rows' first shards.
    assert [d.index for d, _ in plan.launches[P]] == [0, 2]
    both_ways = {(0, 1, 0, 0, 1), (1, 0, 0, 1, 2), (2, 3, 1, 0, 1),
                 (3, 2, 1, 1, 2)}
    for step in range(P - 1):
        got = {(s.index, d.index, i, lo, hi)
               for s, d, i, lo, hi in plan.copies[step]}
        assert got == both_ways
    last = {(s.index, d.index, i, lo, hi)
            for s, d, i, lo, hi in plan.copies[P - 1]}
    assert last == {(1, 0, 0, 1, 2), (3, 2, 1, 1, 2)}
    assert plan.copies[P] == ()
    for step in range(P + 1):
        assert all(s != d for s, d, *_ in plan.copies[step])
    launches = [sum(1 for s in plan.launches for d, _ in s if d == c)
                for c in CARDS]
    assert launches == [P + 1, P, P + 1, P]


def test_mixed_mesh_copies_runs_of_shards():
    # Two batch rows, each on one card: nothing crosses a card.
    mixed = [CARDS[0], CARDS[0], CARDS[1], CARDS[1]]
    plan = k._sharded_launch_plan(rows_of(mixed, 2), P)
    assert all(c == () for c in plan.copies)
    assert plan.launches[0] == ((CARDS[0], ((0, 0), (0, 1))),
                                (CARDS[1], ((1, 0), (1, 1))))
    # One batch row over both cards: each card's two shards go to the
    # other card in one copy; the last step's only to the first shard's.
    plan = k._sharded_launch_plan(rows_of(mixed, 1), P)
    assert plan.launches[0] == ((CARDS[0], ((0, 0), (0, 1))),
                                (CARDS[1], ((0, 2), (0, 3))))
    assert plan.launches[P] == ((CARDS[0], ((0, 0), (0, 1))),)
    for step in range(P - 1):
        assert plan.copies[step] == ((CARDS[0], CARDS[1], 0, 0, 2),
                                     (CARDS[1], CARDS[0], 0, 2, 4))
    assert plan.copies[P - 1] == ((CARDS[1], CARDS[0], 0, 2, 4),)
    # Interleaved shards: one copy per run of consecutive shards.
    inter = [[CARDS[0], CARDS[1], CARDS[1], CARDS[0]]]
    plan = k._sharded_launch_plan(inter, 2)
    assert plan.copies[0] == ((CARDS[0], CARDS[1], 0, 0, 1),
                              (CARDS[1], CARDS[0], 0, 1, 3),
                              (CARDS[0], CARDS[1], 0, 3, 4))


def test_more_pairs_than_a_launch_holds_take_more_launches():
    n = k.SHARDED_MAX_PAIRS + 4
    plan = k._sharded_launch_plan([[CARDS[0]] * n], 1)
    assert [len(p) for _, p in plan.launches[0]] == [k.SHARDED_MAX_PAIRS, 4]
    # Only the launch holding shard 0 runs the last step.
    assert [len(p) for _, p in plan.launches[1]] == [k.SHARDED_MAX_PAIRS]
    assert plan.copies == ((), ())
