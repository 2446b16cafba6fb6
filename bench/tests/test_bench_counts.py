"""The yardstick's operation and byte counts against counts worked out by
hand at small shapes."""

import pytest

from bench import counts


def brute_pairs(n, window=None, offset=0):
    total = 0
    for i in range(n):
        q = i + offset  # the query's key position
        for j in range(q + 1):
            if window is None or j > q - window:
                total += 1
    return total


@pytest.mark.parametrize("n,window,offset", [
    (1, None, 0), (8, None, 0), (8, 4, 0), (8, 8, 0), (8, 9, 0), (5, 3, 2),
    (6, 4, 10), (17, 5, 3), (64, 16, 0), (3, 1, 0)])
def test_attn_pairs_against_a_loop(n, window, offset):
    assert counts.attn_pairs(n, window, offset) == \
        brute_pairs(n, window, offset)


def test_window_counted_causally_not_as_the_block():
    # 8 queries in a window of 4: 1 + 2 + 3 + 4 + 4 * 4 = 26 pairs, where
    # the program's count s * min(s, w) gives 32.
    assert counts.attn_pairs(8, 4) == 26
    # inside the window, half the block and the diagonal: 4096 * 4097 / 2
    assert counts.attn_pairs(4096, 4096) == 4096 * 4097 // 2


def test_flash_cost_by_hand():
    # 4 rows, 2 q heads over 1 kv head of 8: pairs 10; FLOPs 4 * 2 * 8 * 10;
    # bytes: q and o 4 * 2 * 8 each, k and v 4 * 1 * 8 each, 2 bytes each.
    flops, nbytes = counts.flash_cost(4, 2, 1, 8)
    assert flops == 640.0
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)


def test_decode_cost_by_hand():
    # two sequences of 3 and 5 keys, 4 q / 2 kv heads of 16
    flops, nbytes = counts.decode_cost([3, 5], 4, 2, 16)
    assert flops == 4 * 4 * 16 * 8
    assert nbytes == 2 * 16 * (2 * 2 * 8 + 2 * 4 * 2)


def test_bound_is_the_larger_term():
    assert counts.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def dims(family):
    m = dict(family=family, n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
             dh=4, d_ff=16, vocab=10, window=None, gated=family == "moe",
             n_experts=4, top_k=2)
    return m


def test_matmul_params_by_hand():
    # dense GELU: attention 8*8 + 2*8*4 + 8*8 = 192, MLP 2*8*16 = 256,
    # two layers, and the head 8 * 10.
    assert counts.matmul_params(dims("dense")) == 2 * (192 + 256) + 80
    # moe: router 8*4, two of four experts of 3*8*16 each.
    assert counts.matmul_params(dims("moe")) == \
        2 * (192 + 32 + 2 * 384) + 80


def test_prefill_and_decode_flops_by_hand():
    m = dims("dense")
    p = counts.matmul_params(m)
    # 3 tokens: 2p a token, attention 6 pairs x 4 x 2 heads x 4 on 2 layers
    assert counts.prefill_flops(m, 3) == 2 * p * 3 + 2 * 4 * 2 * 4 * 6
    assert counts.decode_flops(m, 7) == 2 * p + 2 * 4 * 2 * 4 * 7
    m["window"] = 4
    assert counts.decode_flops(m, 7) == 2 * p + 2 * 4 * 2 * 4 * 4
    assert counts.prefill_flops(m, 6) == \
        2 * p * 6 + 2 * 4 * 2 * 4 * (1 + 2 + 3 + 4 + 4 + 4)
