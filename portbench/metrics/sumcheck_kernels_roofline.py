"""sumcheck_kernels_roofline: the sum of every round's round and fold
bound (portbench/roofline.py, from num_vars, C and the live evaluations)
over the device ms a protocol spends in the round and fold kernels, in
percent.  The kernels' ms: torch.profiler's kernel records by name over
the protocols of the profiled part, per protocol; nothing where the
profiler recorded none."""

from portbench import roofline

KERNELS = ("sumcheck_round_kernel", "sumcheck_fold_kernel")


def read(win):
    ms = win.profiled_kernel_ms(KERNELS)
    if ms is None:
        return None
    cfg = win.config
    return 100.0 * roofline.sumcheck_protocol_bound_ms(
        cfg["composition_size"], cfg["num_vars"]) / ms
