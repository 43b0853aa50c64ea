"""cross_mul_ms: device ms a transform spends on the cross-device stages'
products: the program's ``sharded.cross_mul`` spans (each half's twiddle
expanded, ``mul_tiles`` and the XOR combine).  The harness reports the
slowest rank's."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_ms(win, "sharded.cross_mul")
