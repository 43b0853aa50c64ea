"""exchange_wait_ms: device ms a transform's stream waits for the halves
of the shard exchanged on the cross-device stages: the program's
``sharded.exchange_wait`` spans (an event pair around each half's wait).
The harness reports the slowest rank's."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_ms(win, "sharded.exchange_wait")
