"""setup_build_s: host seconds of the set-up in the program's
``setup.build`` span: the CUDA kernels' library built with nvcc, or
loaded where the checkout has it already (0 where no library was loaded,
as on the CPU)."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_setup_s(win, "setup.build")
