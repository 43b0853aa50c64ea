"""Order-carrying NTT data wrapper.

The reference tracks element order as DATA, not as a per-call flag:
``NTTData<E>{order, data, size}`` with ``DataOrder{IN_ORDER,
BIT_REVERSED}`` (src/ulvt/ntt/nttconf.cuh:9-21), and ``apply`` REJECTS a
mis-ordered input instead of silently transforming garbage
(additive_ntt.cuh:206-208 returns false; gpuntt.cuh:180 labels radix-2
output IN_ORDER).  This is the port's equivalent: a tiny wrapper the NTT
classes accept and return, so order bookkeeping survives across call
boundaries.

Same class as binius_ntt_tpu/ntt/nttdata.py.  Plain arrays and tensors
remain accepted everywhere — the wrapper is additive API surface.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

__all__ = ["DataOrder", "NTTData"]


class DataOrder(enum.Enum):
    IN_ORDER = 0
    BIT_REVERSED = 1


@dataclasses.dataclass
class NTTData:
    data: Any
    order: DataOrder = DataOrder.IN_ORDER
