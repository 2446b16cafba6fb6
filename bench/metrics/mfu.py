"""Model FLOPs of every prompt prefilled and every token decoded in the
window (2 a matmul parameter a token, attention counted causally within
the window, ``bench.counts``), over the window's seconds times the card's
bf16 peak, in percent."""

from bench import counts


def read(rec):
    m, t0, t1 = rec["m"], rec["t0"], rec["t1"]
    flops = 0.0
    for s in rec["sent"]:
        n = s.planned.prompt_len
        for j, t in enumerate(s.times):
            if t0 <= t <= t1:
                flops += (counts.prefill_flops(m, n) if j == 0
                          else counts.decode_flops(m, n + j))
    return 100.0 * flops / ((t1 - t0) * counts.PEAK_FLOPS)
