"""setup_tables_s: host seconds of the set-up in the program's
``setup.tables`` spans: the twiddle rows (``precompute_subspace_evals``)
and the transform's tables built on the host and moved to the device."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_setup_s(win, "setup.tables")
