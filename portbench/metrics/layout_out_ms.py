"""layout_out_ms: device ms a transform of ``AdditiveNTT128.apply`` spends
in the program's ``ntt.layout_out`` span: the untranspose of the
bit-sliced codeword into compact words."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_ms(win, "ntt.layout_out")
