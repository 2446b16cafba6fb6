"""The traffic generator: a seed gives the same schedule and prompts,
two seeds differ in order and tokens but not in the work they send."""

import numpy as np
import pytest

from bench import traffic_gen
from conftest import tiny_traffic


def sig(reqs):
    return [(p.index, p.prompt_len, p.max_new, p.due) for p in reqs]


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_same_seed_same_schedule(loop):
    t = tiny_traffic(loop)
    a, b = traffic_gen.plan(t, 10.0, 2 ** 31 + 12345), \
        traffic_gen.plan(t, 10.0, 2 ** 31 + 12345)
    assert sig(a) == sig(b)
    assert all(np.array_equal(traffic_gen.prompt_tokens(p, 256, 7),
                              traffic_gen.prompt_tokens(q, 256, 7))
               for p, q in zip(a, b))


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_two_seeds_differ_in_order_not_in_work(loop):
    t = tiny_traffic(loop)
    a, b = traffic_gen.plan(t, 10.0, 1), traffic_gen.plan(t, 10.0, 2)
    assert sig(a) != sig(b)
    assert sorted((p.prompt_len, p.max_new) for p in a) != \
        [(p.prompt_len, p.max_new) for p in a] or len(a) < 3
    assert sorted(p.prompt_len for p in a) == sorted(p.prompt_len for p in b)
    assert sorted(p.max_new for p in a) == sorted(p.max_new for p in b)
    ta = traffic_gen.prompt_tokens(a[0], 256, 1)
    tb = traffic_gen.prompt_tokens(a[0], 256, 2)
    assert not np.array_equal(ta, tb)


def test_open_loop_gaps_are_one_draw_reordered():
    t = tiny_traffic("open")
    a, b = traffic_gen.plan(t, 10.0, 1), traffic_gen.plan(t, 10.0, 2)
    assert len(a) == len(b) > 100  # 20 a second for 10 seconds
    assert all(0.0 < p.due < 10.0 for p in a)
    assert all(x.due < y.due for x, y in zip(a, a[1:]))
    ga = np.diff([0.0] + [p.due for p in a] + [10.0])
    gb = np.diff([0.0] + [p.due for p in b] + [10.0])
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), atol=1e-9)


def test_poisson_arrivals_is_the_programs():
    times = traffic_gen.poisson_arrivals(5.0, 100.0, seed=3)
    rng = np.random.default_rng(3)
    t, want = 0.0, []
    while True:
        t += rng.exponential(0.2)
        if t >= 100.0:
            break
        want.append(t)
    assert times == want
    assert 400 < len(times) < 600


def test_lengths_within_bounds():
    rng = np.random.default_rng(0)
    x = traffic_gen.draw_lengths({"dist": "lognormal", "median": 256,
                                  "sigma": 0.8, "min": 32, "max": 1024},
                                 5000, rng)
    assert x.min() >= 32 and x.max() <= 1024
    assert 230 < np.median(x) < 285
    u = traffic_gen.draw_lengths({"dist": "uniform", "min": 64, "max": 192},
                                 5000, rng)
    assert u.min() == 64 and u.max() == 192


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_every_block_sends_the_same_work_whatever_the_seed(loop):
    t = tiny_traffic(loop)
    a, b = traffic_gen.plan(t, 10.0, 11), traffic_gen.plan(t, 10.0, 12)
    k = t["order_block"]
    assert [p.max_new for p in a] != [p.max_new for p in b]
    for i in range(0, len(a), k):
        assert sorted((p.prompt_len, p.max_new) for p in a[i:i + k]) == \
            sorted((p.prompt_len, p.max_new) for p in b[i:i + k])


def test_block_permutation_moves_indices_only_inside_their_block():
    rng = np.random.default_rng(0)
    p = traffic_gen.block_permutation(rng, 23, 5)
    assert sorted(p) == list(range(23))
    assert all(i // 5 == j // 5 for i, j in enumerate(p))
    assert list(traffic_gen.block_permutation(rng, 0, 5)) == []
