"""The least time the H100 could take for the benchmark's work.

Counted from the work and not from the program: a count reads only the
cell's shapes (log_h, log_rate; num_vars, C and the live evaluations of
each round) and the twiddles as the plain reference computes them
(reference/ntt128.py: which stages multiply, and whether all of a stage's
twiddles lie in GF(2^32)).  It never reads the program's tables, routes,
flags or launch counts.  Each input byte is read once and each output
byte written once.

A bound is the larger of the operations over INT_OPS_PER_S and the bytes
over BYTES_PER_S.  The operations are those of bit-sliced GF(2) circuits
on 32-bit words, covered by three-input LOP3 instructions
(:func:`tower_mul_ops`).
"""

from __future__ import annotations

from .reference import ntt128

# Integer logic on the int32 pipe: 132 SMs x 64 lanes x 1.98 GHz.  The
# data sheet gives no int32 logic rate, so it is derived from the SM's
# layout.  HBM3: 3.35 TB/s.  Both at the card's 700 W limit.
INT_OPS_PER_S = 1.67e13
BYTES_PER_S = 3.35e12
ELEMENT_BYTES = 16              # a GF(2^128) element


def tower_mul_ops(h: int) -> int:
    """Operations of one bit-sliced GF(2^(2^h)) multiply (32 products).
    The circuit (two-input AND and XOR gates, 13,448 at h = 7, 1,388 at
    h = 5) is covered by three-input LOP3 operations: a gate folds into a
    gate that reads it while the fold still reads at most three values, and
    a gate is issued only if an output or an issued gate reads it.  The
    cover is greedy: the card can reach the count, which is not proven
    least."""
    n_in, gates = 2 << h, []

    def gate(a, b):
        gates.append((a, b))
        return n_in + len(gates) - 1

    def alpha(x):
        if len(x) == 1:
            return list(x)
        half = len(x) // 2
        t = alpha(x[half:])
        return x[half:] + [gate(x[i], t[i]) for i in range(half)]

    def mul(a, b):
        if len(a) == 1:
            return [gate(a[0], b[0])]
        half = len(a) // 2
        sa = [gate(a[i], a[half + i]) for i in range(half)]
        sb = [gate(b[i], b[half + i]) for i in range(half)]
        z0, z2 = mul(a[:half], b[:half]), mul(a[half:], b[half:])
        zm, z2a = mul(sa, sb), alpha(z2)
        lo = [gate(z0[i], z2[i]) for i in range(half)]
        return lo + [gate(gate(zm[i], lo[i]), z2a[i]) for i in range(half)]

    w = 1 << h
    out = mul(list(range(w)), list(range(w, 2 * w)))
    reads = []
    for a, b in gates:
        r = {a, b}
        for c in (a, b):
            if c >= n_in and c in r:
                folded = (r - {c}) | reads[c - n_in]
                if len(folded) <= 3:
                    r = folded
        reads.append(r)
    issued, todo = set(), [g for g in out if g >= n_in]
    while todo:
        g = todo.pop()
        if g not in issued:
            issued.add(g)
            todo.extend(c for c in reads[g - n_in] if c >= n_in)
    return len(issued)


MUL128_OPS, MUL32_OPS = tower_mul_ops(7), tower_mul_ops(5)


def bound_ms(ops: float, nbytes: float) -> float:
    return max(ops / INT_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3


def ntt128_bound_ms(log_h: int, log_rate: int, rows=None) -> float:
    """One GF(2^128) transform of 2^log_h points at rate 2^-log_rate:
    each stage whose twiddles are not all 0 multiplies every pair of its
    2^(log_h+log_rate) outputs once, as four GF(2^32) products where all
    its twiddles lie in GF(2^32) and as one GF(2^128) product otherwise;
    the input read and the output written once."""
    if rows is None:
        rows = ntt128.twiddle_rows(log_h, log_rate)
    pair_batches = 1 << (log_h + log_rate - 6)     # 32 pairs a batch
    ops = sum(pair_batches * (4 * MUL32_OPS if sub else MUL128_OPS)
              for live, sub in ntt128.stage_work(rows, log_h, log_rate)
              if live)
    nbytes = ELEMENT_BYTES * ((1 << log_h) + (1 << (log_h + log_rate)))
    return bound_ms(ops, nbytes)


def sumcheck_round_bounds_ms(comp: int, n: int) -> tuple[float, float]:
    """(round, fold) of a GF(2^128) sumcheck round over n live
    evaluations a column: the round multiplies (C - 1) (C + 1) times a
    pair and reads the C columns; the fold multiplies C times a pair,
    reads the C columns and writes their halves."""
    pairs = n // 2
    col_bytes = ELEMENT_BYTES * n
    rnd = bound_ms(pairs * (comp - 1) * (comp + 1) * MUL128_OPS / 32,
                   comp * col_bytes)
    fold = bound_ms(comp * pairs * MUL128_OPS / 32,
                    comp * col_bytes + comp * col_bytes // 2)
    return rnd, fold


def sumcheck_protocol_bound_ms(comp: int, num_vars: int) -> float:
    """Every round's round and fold bound, and the last message's (the
    product of one evaluation a column)."""
    total = 0.0
    for r in range(num_vars):
        total += sum(sumcheck_round_bounds_ms(comp, 1 << (num_vars - r)))
    total += bound_ms((comp - 1) * MUL128_OPS / 32, comp * ELEMENT_BYTES)
    return total
