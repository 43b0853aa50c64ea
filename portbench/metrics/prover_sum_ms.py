"""prover_sum_ms: host ms a protocol spends in the program's
``sumcheck.message_sum`` spans: each round's untranspose and XOR of its
batch sums into the message on the host."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_host_ms(win, "sumcheck.message_sum")
