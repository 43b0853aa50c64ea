"""ntt_copy_ms: device ms a call spends in the program's
``ntt.coset_copy`` span: the copy of the batch's columns into the chain's
in-place buffer, once a coset."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_ms(win, "ntt.coset_copy")
