"""prover_readback_ms: host ms a protocol spends in the program's
``sumcheck.readback`` spans: each round's copy of its batch sums to the
host, which waits for the round and fold kernels queued before it."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_host_ms(win, "sumcheck.readback")
