"""prover_host_ms: a protocol's ms (the event pair around each window
call outside the profiled part) less the device ms it spends in the round
and fold kernels (torch.profiler's kernel records by name, per protocol
of the profiled part): the prover's host loop with the kernels' launches,
its copies back to the host, the challenges and the state copy at the
start."""

KERNELS = ("sumcheck_round_kernel", "sumcheck_fold_kernel")


def read(win):
    kernels = win.profiled_kernel_ms(KERNELS)
    protocol = win.mean_entry_ms()
    if kernels is None or protocol is None:
        return None
    return protocol - kernels
