"""Random stage-group tables for the card checks of csrc/stage_group.cu
(tests/test_torch_cuda.py and chip_smoke.py phase 4).  Imports no JAX."""

import numpy as np

from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.utils.bits import to_torch


def random_group_tables(rng, k: int, include_low: bool, width: int, device):
    """(mtile, minst, lanes) for one group, planes 0..width-1 random and the
    rest zero: width 128 takes the general route, width 32 (random GF(2^32)
    twiddles, varying in every plane and lane) the CHUNK32 one."""
    def table(n):
        t = np.zeros((n, cf.W), np.uint32)
        t[:, :width] = rng.integers(0, 1 << 32, (n, width), dtype=np.uint32)
        return t

    tabs = (table(k + 5 * include_low), table(k + 5 * include_low),
            table(5) if include_low else None)
    if cf.subfield_tables(*tabs) != (width <= cf.SUB_PLANES):
        raise AssertionError("random tables flagged on the wrong route")
    return [None if t is None else to_torch(t, device) for t in tabs]
