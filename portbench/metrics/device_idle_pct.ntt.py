"""device_idle_pct.ntt: the share of the traced part of the window in
which the card ran no kernel, copy or set (torch.profiler's device
timeline), in percent.  Nothing without device records."""

from portbench import trace


def read(win):
    return trace.idle_pct(win.summary)
