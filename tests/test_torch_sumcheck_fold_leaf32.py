"""The GF(2^128) sumcheck fold kernel's arithmetic, on the CPU.

csrc/sumcheck_fold.cu folds lo ^ w * (lo ^ up) with the in-place product of
csrc/tower_leaf32.cuh, nine GF(2^32) leaves.  The challenge w is one field
element for the whole launch and each of its planes is all ones or all
zeros, so its nine leaf operands are a table that a block forms once: word
i of leaf l is all ones where the XOR of the challenge words in chunk subset
GROUPED[l] has bit i set.  These tests hold that parity rule to the leaves
summed from the challenge's planes, and a torch transliteration of the
kernel's fold (xh = lo ^ up, the in-place product with the table as its
second operand, then lo ^) to ``fold_plain`` and to the JAX package's
``_fold_kernel_tiled`` and ``_fold_small``.  Every comparison is exact (word
equality).  The kernel itself runs in tests/test_torch_cuda.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.layout import bitslicing as lay_jax
from binius_ntt_tpu.sumcheck import prover as prover_jax
from binius_ntt_tpu_torch import _build
from binius_ntt_tpu_torch.layout.bitslicing import repeat_value_bitsliced
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch
from test_torch_sumcheck_round_leaf32 import (grouped_order,
                                              in_place_multiply, sum_chunks)

ONES = 0xFFFFFFFF
# challenges by name: seeded ones, then 0, 1, all ones and one inside
# GF(2^32) (chunks 1-3 zero)
CHALLENGES = {
    **{f"seed{s}": np.random.default_rng(s).integers(0, 1 << 32, 4,
                                                     dtype=np.uint32)
       for s in (11, 12, 13)},
    "zero": [0, 0, 0, 0], "one": [1, 0, 0, 0],
    "all_ones": [ONES] * 4, "gf2_32": [0x9E3779B9, 0, 0, 0]}


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                                dtype=np.uint32)


def leaf_table(challenge) -> dict[int, torch.Tensor]:
    """The kernel's table, by chunk subset: (32,) int32 words, word i all
    ones where bit i of the XOR of the challenge words in the subset is
    set."""
    words = [int(w) for w in cr.challenge_words(challenge)]
    table = {}
    for s in grouped_order():
        v = 0
        for c in range(4):
            if (s >> c) & 1:
                v ^= words[c]
        table[s] = torch.tensor([-((v >> i) & 1) for i in range(32)],
                                dtype=torch.int32)
    return table


def fold_model(evals: torch.Tensor, challenge, rows: int,
               lanes: int = 32) -> torch.Tensor:
    """csrc/sumcheck_fold.cu's fold in torch, on a copy of evals: every
    thread's xh = lo ^ up, multiplied in place by the table's leaves, and
    lo ^ xh written over lo (in-word: up = lo >> lanes/2, every lane)."""
    out = evals.clone()
    if rows == 1:
        lo = out[:, :1]
        up = lsr(lo, lanes // 2)
    else:
        half = rows // 2
        lo, up = out[:, :half], out[:, half:rows]
    table = leaf_table(challenge)
    lo.copy_(lo ^ in_place_multiply(lo ^ up, table.__getitem__))
    return out


def _live_rows(b: int) -> list[int]:
    """Every row count of a protocol over b batches, then counts whose
    half is not a multiple of the kernel's 64-thread block."""
    live = [b >> k for k in range(b.bit_length() - 1)]
    return live + [r for r in (70, b - 2) if 2 <= r < b]


# ---- the challenge's leaf table ------------------------------------------

@pytest.mark.parametrize("name", list(CHALLENGES))
def test_table_is_the_challenge_s_leaves(name):
    """The parity rule gives each leaf's operand: the XOR of the
    challenge's broadcast planes over the leaf's chunk subset."""
    challenge = CHALLENGES[name]
    planes = repeat_value_bitsliced(cr.challenge_words(challenge), 128)
    chunks = planes.reshape(4, 32)
    table = leaf_table(challenge)
    assert sorted(table) == sorted(grouped_order())
    for s, words in table.items():
        assert torch.equal(words, sum_chunks(chunks, s)), s
        assert set(words.tolist()) <= {0, -1}


@pytest.mark.parametrize("name", ["seed11", "one", "all_ones", "gf2_32"])
def test_table_product_is_the_multiply(name):
    """The in-place product with the table as second operand equals the
    product with the challenge's planes gathered."""
    challenge = CHALLENGES[name]
    a = to_torch(_words(20, (3, 5, 128)))
    planes = repeat_value_bitsliced(cr.challenge_words(challenge), 128)
    table = leaf_table(challenge)
    assert torch.equal(in_place_multiply(a, table.__getitem__),
                       in_place_multiply(a, planes.expand(a.shape)))


# ---- the fold ------------------------------------------------------------

@pytest.mark.parametrize("num_vars,comp", [
    (8, 1), (8, 2), (8, 3), (8, 4), (10, 1), (10, 2), (10, 3), (10, 4),
    (12, 2)])
def test_fold_model_matches_plain_and_jax(num_vars, comp):
    b = (1 << num_vars) // 32
    state = _words(200 + num_vars + comp, (comp, b, 128))
    ch = _words(300 + num_vars + comp, (4,))
    coeff = jnp.asarray(lay_jax.repeat_value_bitsliced(ch, 128))
    x = to_torch(state)
    for rows in _live_rows(b):
        got = fold_model(x, ch, rows)
        assert torch.equal(got, cr.fold_plain(x.clone(), ch, rows)), rows
        want = np.asarray(prover_jax._fold_kernel_tiled(
            jnp.asarray(state), coeff, jnp.int32(rows)))
        assert np.array_equal(to_numpy(got), want), rows


@pytest.mark.parametrize("comp", [1, 2, 4])
def test_in_word_fold_model_matches_the_jax_tail(comp):
    """rows = 1 at lanes 32 .. 2, each fold on the last one's output:
    against fold_plain and the JAX package's _fold_small, every lane."""
    cols = _words(400 + comp, (comp, 128))
    x = to_torch(cols.copy())[:, None, :]                  # (C, 1, 128)
    lanes = 32
    while lanes >= 2:
        ch = _words(500 + lanes, (4,))
        got = fold_model(x, ch, 1, lanes)
        cols = prover_jax._fold_small(
            cols, lay_jax.repeat_value_bitsliced(ch, 128), lanes)
        assert np.array_equal(to_numpy(got[:, 0]), cols), lanes
        assert torch.equal(got, cr.fold_plain(x, ch, 1, lanes)), lanes
        lanes //= 2


@pytest.mark.parametrize("rows,lanes", [(8, 32), (2, 32), (1, 32), (1, 2)])
def test_fold_model_at_challenges_zero_and_one(rows, lanes):
    """w = 0 leaves lo as it is; w = 1 makes lo the upper operand."""
    x = to_torch(_words(600 + rows + lanes, (2, 8, 128)))
    lo = x[:, :max(rows // 2, 1)]
    up = lsr(lo, lanes // 2) if rows == 1 else x[:, rows // 2:rows]
    assert torch.equal(fold_model(x, CHALLENGES["zero"], rows, lanes), x)
    got = fold_model(x, CHALLENGES["one"], rows, lanes)
    assert torch.equal(got[:, :lo.shape[1]], up)
    assert torch.equal(got[:, lo.shape[1]:], x[:, lo.shape[1]:])


# ---- the build's report ----------------------------------------------------

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120sumcheck_fold_kernelILb0EEEvPjxxxijjjj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120sumcheck_fold_kernelILb0EEEvPjxxxijjjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 250 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120sumcheck_fold_kernelILb1EEEvPjxxxijjjj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120sumcheck_fold_kernelILb1EEEvPjxxxijjjj
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_kernel_usage_names_a_template_instantiation():
    """A name with the start of the mangled template arguments picks one
    instantiation; the bare name the first."""
    row = ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
           " | Used 250 registers, used 1 barriers")
    in_word = ("8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
               "loads | Used 255 registers, used 1 barriers")
    assert _build.kernel_usage("sumcheck_fold_kernelILb0E", PTXAS_LOG) == row
    assert _build.kernel_usage("sumcheck_fold_kernelILb1E",
                               PTXAS_LOG) == in_word
    assert _build.kernel_usage("sumcheck_fold_kernel", PTXAS_LOG) == row
    assert _build.kernel_usage("sumcheck_round_kernel", PTXAS_LOG) == ""
