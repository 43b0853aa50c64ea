"""Sumcheck transcripts minted by the JAX package, held against the port.

A transcript is the full GF(2^128) protocol of ``Sumcheck``: for every round
its sum and its points, then the sum left after the last fold, all as
little-endian uint32 words; ``SUMCHECK_TRANSCRIPT_MD5`` holds the MD5 of
those bytes.  Inputs and challenges come from one mt19937 stream,
``mt19937_stream(seed(num_vars, comp), n + 4 * num_vars)`` with
``n = 4 * 2^num_vars * comp`` (the convention of tests/test_sumcheck.py):
the first n words are the compact evaluations, the rest the challenges.

The digests were minted on the CPU by the JAX package
(``binius_ntt_tpu.sumcheck.prover.Sumcheck``) with

    python tests/test_torch_sumcheck_golden.py

This module imports no JAX at module level: chip_smoke.py loads it by path
on a machine that has PyTorch but no JAX, and checks the num_vars-20
transcripts on the card.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest

SUMCHECK_TRANSCRIPT_MD5 = {
    14: {2: "46d215169485401c4037e03bfbe4ffc3",
         3: "43ed7649611cb62bf95dd9632cca3c8d",
         4: "0e240fa8f7d28e4790f327ea84b2fc06"},
    20: {2: "4f17c0b31d4a668bfe9c1176786321dd",
         3: "5d82974011448eb98652799e8bf1b33f",
         4: "db13bd66d4fec5e1819a590c465817e9"},
}


def seed(num_vars: int, comp: int) -> int:
    return 1000 + 10 * num_vars + comp


def protocol_inputs(num_vars: int, comp: int, mt19937_stream):
    """(compact evaluation words, (num_vars, 4) challenge words), uint32."""
    n = 4 * (1 << num_vars) * comp
    vals = mt19937_stream(seed(num_vars, comp), n + 4 * num_vars)
    return vals[:n], vals[n:].reshape(num_vars, 4)


def transcript(prover, challenges) -> list:
    """Run the whole protocol on ``prover`` (either package's Sumcheck):
    one (sum, points) per round, then the (sum, points) after the last
    fold."""
    messages = []
    for ch in challenges:
        messages.append(prover.round_messages())
        prover.move_to_next_round(ch)
    messages.append(prover.round_messages())
    return messages


def transcript_md5(messages) -> str:
    """MD5 of every round's sum and points, then the final sum, as
    little-endian uint32 words."""
    h = hashlib.md5()
    for sm, pts in messages[:-1]:
        h.update(np.asarray(sm, dtype="<u4").tobytes())
        h.update(np.asarray(pts, dtype="<u4").tobytes())
    h.update(np.asarray(messages[-1][0], dtype="<u4").tobytes())
    return h.hexdigest()


def _jax_transcript(num_vars: int, comp: int) -> str:
    from binius_ntt_tpu.sumcheck.prover import Sumcheck
    from binius_ntt_tpu.utils.mt19937 import mt19937_stream

    words, challenges = protocol_inputs(num_vars, comp, mt19937_stream)
    return transcript_md5(transcript(Sumcheck(words, comp, num_vars),
                                     challenges))


@pytest.mark.parametrize("comp", [2, 3, 4])
def test_port_plain_transcript_matches_jax_at_14(comp):
    """Recompute a num_vars-14 digest with JAX, and run the port's
    protocol (plain versions, on the CPU) against it and the verifier."""
    from binius_ntt_tpu_torch.sumcheck import verifier
    from binius_ntt_tpu_torch.sumcheck.prover import Sumcheck
    from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

    want = SUMCHECK_TRANSCRIPT_MD5[14][comp]
    assert _jax_transcript(14, comp) == want
    words, challenges = protocol_inputs(14, comp, mt19937_stream)
    messages = transcript(Sumcheck(words, comp, 14, device="cpu"), challenges)
    verifier.check_transcript(messages, challenges, comp + 1)
    assert transcript_md5(messages) == want


def _mint() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    for num_vars in (14, 20):
        row = {comp: _jax_transcript(num_vars, comp) for comp in (2, 3, 4)}
        print(f"    {num_vars}: {row},", flush=True)


if __name__ == "__main__":
    _mint()
