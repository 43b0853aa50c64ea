"""binius_ntt_tpu_torch — the PyTorch/CUDA port of binius_ntt_tpu for Hopper.

The JAX package binius_ntt_tpu is the reference; this package computes the
same bits with torch for the glue and hand-written CUDA kernels (csrc/,
built for sm_90a by nvcc at first use) for the hot path.  It never imports
jax.

Ported so far: the bit-sliced GF(2^128) additive NTT (AdditiveNTT128, the
fused stage-group path and the per-stage path with the butterfly kernels
of ntt/cuda_kernels.py) with its host foundations, the standalone
bit-sliced multiply (ntt/cuda_kernels.mul_tiles), the compact tower
multiply above 32 bits (fields/tower_compact.py, with its kernel
mul_compact_tiles), the bit-sliced
GF(2^128) sumcheck prover (Sumcheck, with its round and challenge-fold
kernels in sumcheck/cuda_round.py and the host verifier in
sumcheck/verifier.py), and the compact GF(2^32) additive NTT
(AdditiveNTT, with the lane-group transpose and stage-group kernels of
ntt/cuda_fused32.py on its fused path, the SWAR multiply of
fields/tower_simd.py on its compact path, and the scalar oracle in
ntt/reference.py), and the prime-field paths: the radix-2 BB31 NTT
(NTTRadix2, with the stage-group kernel of ntt/cuda_fused_bb31.py) and the
QM31 sumcheck prover (PrimeFieldSumcheck, with its round and fold kernels
in sumcheck/cuda_prime_round.py).

Every entry point runs on ``cuda:0`` unless the caller passes another
``device``; off the card pass ``device="cpu"`` to run the kernels' plain
torch versions.
"""

from .fields import bitsliced, tower_compact, tower_scalar, tower_simd
from .layout.bitslicing import bitslice_transpose, bitslice_untranspose
from .ntt.additive import AdditiveNTT
from .ntt.additive_bitsliced import AdditiveNTT128
from .ntt.nttdata import DataOrder, NTTData
from .ntt.radix2 import NTTRadix2
from .sumcheck.prime_field import PrimeFieldSumcheck
from .sumcheck.prover import Sumcheck

__all__ = [
    "AdditiveNTT",
    "AdditiveNTT128",
    "DataOrder",
    "NTTData",
    "NTTRadix2",
    "PrimeFieldSumcheck",
    "Sumcheck",
    "bitslice_transpose",
    "bitslice_untranspose",
    "bitsliced",
    "tower_compact",
    "tower_scalar",
    "tower_simd",
]

__version__ = "0.1.0"
