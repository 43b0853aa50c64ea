"""prover_idle_ms: device-idle ms a profiled protocol that falls inside
one of the program's spans (the torch.profiler trace of the window's
first part: the device's busy intervals against the ranges the spans
open, on the profiler's clock).  The rest of the protocol's idle time is
the caller's: its challenges, the state copy's launch, the loop.  Nothing
without device records."""

from portbench import program_spans

program_spans.arm()


def read(win):
    got = program_spans.idle_in_spans_ms(win)
    return None if got is None else got[0]
