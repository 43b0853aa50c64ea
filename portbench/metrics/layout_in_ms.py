"""layout_in_ms: device ms a transform of ``AdditiveNTT128.apply`` spends
in the program's ``ntt.layout_in`` span: the bit-slicing transpose of the
compact words (with their move to the device, none here: the columns are
resident)."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_ms(win, "ntt.layout_in")
