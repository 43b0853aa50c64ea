"""prover_launch_ms: host ms a protocol spends launching its kernels: the
program's ``sumcheck.round_launch`` spans (the round kernel's checks, its
point matrices, the zeroed sums and the launch) and
``sumcheck.fold_launch`` spans (the challenge's words and the fold's
launch), over the window's unprofiled protocols."""

from portbench import program_spans

program_spans.arm()


def read(win):
    parts = [program_spans.program_host_ms(win, name)
             for name in ("sumcheck.round_launch", "sumcheck.fold_launch")]
    return None if None in parts else sum(parts)
