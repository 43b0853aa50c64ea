"""Batched GF(2^128) additive NTT cells: ``AdditiveNTT128.apply_sliced`` of
binius_ntt_tpu_torch on a batch of bit-sliced columns a call.

Configuration keys: log_h, log_rate, batch (the columns a call
transforms, Binius's NTTShape 2^log_z), columns (the columns the card
holds, with their codewords, while it commits them; a whole number of
batches).  Traffic keys as in drivers/ntt128.py, whose ``apply_sliced``
traffic this kind takes (sample, warm_calls).

Inputs are made on the device from the seed, columns / batch tensors of
(batch, 2^log_h / 32, 128).  Call i transforms batch i mod (columns /
batch), and each batch's newest codewords stay on the card until the next
call on that batch replaces them.  The check keeps ``sample`` outputs of
the window drawn from the seed (drivers/ntt128.Sampler) and compares every
word of every column of each with the plain reference
(reference/ntt128_batch.py) once the window has closed.
"""

from __future__ import annotations

import torch

from ..reference import ntt128 as reference
from ..reference import ntt128_batch, tower
from . import ntt128

RATE = ntt128.RATE
LATENCY = ntt128.LATENCY
Sampler = ntt128.Sampler


def batches(config) -> int:
    """Batches the card holds: columns / batch."""
    if config["columns"] % config["batch"]:
        raise ValueError(f"ntt128_batch: {config['columns']} columns are "
                         f"not whole batches of {config['batch']}")
    return config["columns"] // config["batch"]


def rate(config, calls: int, window_s: float) -> float:
    """Butterflies of every column the window transformed, a second."""
    return (calls * config["batch"] * ntt128.butterflies(config)
            / window_s * 1e-9)


def make_inputs(config, traffic, seed: int, device, rank: int = 0,
                world: int = 1) -> list[torch.Tensor]:
    if traffic["entry"] != "apply_sliced":
        raise ValueError(f"ntt128_batch: the batched entry is "
                         f"apply_sliced, not {traffic['entry']}")
    shape = (config["batch"], (1 << config["log_h"]) // 32, 128)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                          device=device, generator=gen)
            for _ in range(batches(config))]


# drivers/ntt128.py's: one input a call, here a batch, whose newest
# codewords it keeps
Program = ntt128.Program


def control_answers(config, traffic, inputs, seed: int) -> dict:
    """The reference in the program's place with every product taken in
    GF(2^32) (both operands cut to their low 32 bits): one answer a
    batch, as the calls 0 .. batches - 1 would give."""
    rows = reference.twiddle_rows(config["log_h"], config["log_rate"])
    return {k: ntt128_batch.ntt_sliced_batch(
                x, config["log_h"], config["log_rate"], rows,
                tower.mul_planes_gf32)
            for k, x in enumerate(inputs)}


def check(config, traffic, inputs, answers: dict, seed: int):
    """Every word of every column of each kept output ({call: output};
    call i transformed batch i mod batches) against the reference's.
    Returns (checks {name: (value, op, limit)}, compared, failed)."""
    rows = reference.twiddle_rows(config["log_h"], config["log_rate"])
    wrong, failed = 0, 0
    for i, out in sorted(answers.items()):
        want = ntt128_batch.ntt_sliced_batch(
            inputs[i % len(inputs)], config["log_h"], config["log_rate"],
            rows, tower.mul_planes)
        bad = (int((out != want).sum()) if out.shape == want.shape
               else want.numel())
        del want
        wrong += bad
        failed += bad > 0
    checks = {"outputs_compared": (len(answers), ">=", 1),
              "wrong_words": (wrong, "<=", 0)}
    return checks, len(answers), failed
