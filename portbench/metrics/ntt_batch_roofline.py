"""ntt_batch_roofline: the bound of the columns a call transforms
(portbench/roofline.py, one transform's bound from its shapes and the
reference's twiddles, times the columns) over the device ms of the
program's ``ntt.chain`` span, the coset copy and the stage-group chain,
in percent.  The columns are the span's own ``columns`` count, so a
program that counts none gives nothing to read."""

from portbench import program_spans, roofline

program_spans.arm()


def read(win):
    columns = program_spans.program_count(win, "ntt.chain", "columns")
    ms = program_spans.program_ms(win, "ntt.chain")
    if not columns or not ms:
        return None
    cfg = win.config
    return 100.0 * columns * roofline.ntt128_bound_ms(
        cfg["log_h"], cfg["log_rate"]) / ms
