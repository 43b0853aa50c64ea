"""QM31 sumcheck transcripts minted by the JAX package, held against the port.

A transcript is the full protocol of ``PrimeFieldSumcheck``: the round
polynomial of every round, (3, 4) words p(0), p(1), p(2), then the (2, 4)
column values left after the last fold, all as little-endian uint32 words;
``PRIME_TRANSCRIPT_MD5`` holds the MD5 of those bytes.  Inputs and
challenges come from one mt19937 stream reduced mod P = 2^31 - 1,
``mt19937_stream(seed(num_vars), 8 * 2^num_vars + 4 * num_vars) % P``:
the first 8 * 2^num_vars words are the (2, 2^num_vars, 4) evaluations, the
rest the challenges.

The digests were minted on the CPU by the JAX package
(``binius_ntt_tpu.sumcheck.prime_field.PrimeFieldSumcheck``) with

    python tests/test_torch_prime_sumcheck_golden.py

This module imports no JAX at module level: chip_smoke.py loads it by path
on a machine that has PyTorch but no JAX, and checks the num_vars-20
transcript on the card.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

P = (1 << 31) - 1

PRIME_TRANSCRIPT_MD5 = {
    14: "9278a3c3dcf63d6740c215166cc56da1",
    20: "2be62a74d7d96f672a4da55181992efc",
}


def seed(num_vars: int) -> int:
    return 3100 + num_vars


def protocol_inputs(num_vars: int, mt19937_stream):
    """((2, 2^num_vars, 4) evaluations, (num_vars, 4) challenges), uint32
    canonical mod P."""
    n = 8 << num_vars
    vals = mt19937_stream(seed(num_vars), n + 4 * num_vars) % np.uint32(P)
    return (vals[:n].reshape(2, 1 << num_vars, 4),
            vals[n:].reshape(num_vars, 4))


def transcript(prover, challenges) -> list:
    """Run the whole protocol on ``prover`` (either package's
    PrimeFieldSumcheck): the (3, 4) points of every round, then the (2, 4)
    values left after the last fold."""
    messages = []
    for ch in challenges:
        messages.append(np.asarray(prover.round_messages()))
        prover.fold(ch)
    messages.append(np.asarray(prover.state_dict()["evals"])[:, 0])
    return messages


def transcript_md5(messages) -> str:
    h = hashlib.md5()
    for m in messages:
        h.update(np.asarray(m, dtype="<u4").tobytes())
    return h.hexdigest()


def _jax_transcript(num_vars: int) -> str:
    from binius_ntt_tpu.sumcheck.prime_field import PrimeFieldSumcheck
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    evals, challenges = protocol_inputs(num_vars, mt19937_stream)
    return transcript_md5(transcript(
        PrimeFieldSumcheck(evals, use_pallas=False), challenges))


def test_port_plain_transcript_matches_jax_at_14():
    """Recompute the num_vars-14 digest with JAX, and run the port's
    protocol (plain versions, on the CPU) against it and the host check."""
    from binius_ntt_tpu_torch.sumcheck.prime_field import (
        PrimeFieldSumcheck, check_transcript)
    from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

    want = PRIME_TRANSCRIPT_MD5[14]
    assert _jax_transcript(14) == want
    evals, challenges = protocol_inputs(14, mt19937_stream)
    messages = transcript(PrimeFieldSumcheck(evals, device="cpu"),
                          challenges)
    check_transcript(messages[:-1], challenges, messages[-1])
    assert transcript_md5(messages) == want


def _mint() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    for num_vars in (14, 20):
        print(f"    {num_vars}: \"{_jax_transcript(num_vars)}\",", flush=True)


if __name__ == "__main__":
    _mint()
