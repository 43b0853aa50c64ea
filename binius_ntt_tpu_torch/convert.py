"""Carry the JAX package's state across to the port.

Neither the transform nor the prover has weights.  The transform's state is
the twiddle rows and the per-group parity-mask tables: ``tables_from_jax``
turns the tuple that ``binius_ntt_tpu.ntt.pallas_fused.build_tables``
returns into the port's ``cuda_fused.build_tables`` form, so a test can
feed both packages the same tables; ``tables32_from_jax`` does the same
for the GF(2^32) transform's ``pallas_fused32.build_tables32``, and
``per_stage_tables_from_jax`` takes the per-stage tables of a JAX
``AdditiveNTT128(..., use_fused=False)``.  The sumcheck prover's state is
its
round and its folded evaluations: ``sumcheck_state_from_jax`` turns the
dict of ``binius_ntt_tpu.sumcheck.prover.Sumcheck.state_dict()`` into the
port's, so a protocol begun in JAX can finish in the port.  The prime-field
paths: ``radix2_twiddles_from_jax`` takes the bit-reversed Montgomery
twiddle table of a JAX ``NTTRadix2`` (its ``_tw_mont``), and
``prime_sumcheck_state_from_jax`` the dict of a JAX
``PrimeFieldSumcheck.state_dict()``.  The sharded paths:
``sharded_tables_from_jax`` takes the JAX ``build_tables_sharded``
output, and ``sharded_sumcheck_state_from_jax`` /
``sharded_prime_sumcheck_state_from_jax`` the dicts of the JAX
``ShardedSumcheck`` / ``ShardedPrimeFieldSumcheck.state_dict()``, which
resume on a port mesh of any size.  This module imports no JAX: each
array goes through ``np.asarray``.
"""

from __future__ import annotations

import numpy as np

from .ntt.cuda_fused import subfield_tables
from .utils.bits import to_torch

__all__ = ["tables_from_jax", "tables32_from_jax", "per_stage_tables_from_jax",
           "sumcheck_state_from_jax", "radix2_twiddles_from_jax",
           "prime_sumcheck_state_from_jax", "sharded_tables_from_jax",
           "sharded_sumcheck_state_from_jax",
           "sharded_prime_sumcheck_state_from_jax"]


def tables_from_jax(jax_tables, device=None):
    """(t0, k, include_low, mtile, minst, lanes, zero_flags) per group, JAX
    arrays -> the port's (..., zero_flags, chunk32) with int32 tensors on
    ``device``, chunk32 decided from the arrays
    (``cuda_fused.subfield_tables``)."""
    out = []
    for (t0, k, include_low, mtile, minst, lanes, zero_flags) in jax_tables:
        arrays = [None if t is None else np.asarray(t)
                  for t in (mtile, minst, lanes)]
        out.append((int(t0), int(k), bool(include_low),
                    *(None if a is None else to_torch(a, device)
                      for a in arrays),
                    tuple(bool(z) for z in zero_flags),
                    subfield_tables(*arrays)))
    return tuple(out)


def sharded_tables_from_jax(jax_tables, device=None):
    """(t0, k, include_low, mtile, minst, lanes, zero_flags, dtab) per group
    of the JAX ``pallas_fused.build_tables_sharded`` -> the port's
    ``cuda_fused.build_tables_sharded`` form (..., zero_flags, chunk32,
    dtab), chunk32 decided from all four arrays."""
    out = []
    for (t0, k, include_low, mtile, minst, lanes, zero_flags,
         dtab) in jax_tables:
        arrays = [None if t is None else np.asarray(t)
                  for t in (mtile, minst, lanes, dtab)]
        out.append((int(t0), int(k), bool(include_low),
                    *(None if a is None else to_torch(a, device)
                      for a in arrays[:3]),
                    tuple(bool(z) for z in zero_flags),
                    subfield_tables(*arrays), to_torch(arrays[3], device)))
    return tuple(out)


def tables32_from_jax(jax_tables, device=None):
    """(t0, k, include_low, tabs) per group of the JAX
    ``pallas_fused32.build_tables32``, tabs a dict of arrays plus ``zero``
    -> the same tuple with int32 tensors on ``device``
    (``cuda_fused32.build_tables32`` form)."""
    out = []
    for (t0, k, include_low, tabs) in jax_tables:
        port = {name: to_torch(np.asarray(v), device)
                for name, v in tabs.items() if name != "zero"}
        port["zero"] = tuple(bool(z) for z in tabs["zero"])
        out.append((int(t0), int(k), bool(include_low), port))
    return tuple(out)


def per_stage_tables_from_jax(jax_ntt, device=None):
    """The per-stage tables of a JAX ``AdditiveNTT128(h, r,
    use_pallas=False, use_fused=False)`` (``_high_tables``,
    ``_low_batch_tables``, ``_low_lane_planes``) -> the port's (high,
    low_batch, low_lanes) dicts of int32 tensors on ``device``, the form of
    ``additive_bitsliced.per_stage_tables`` and ``apply_per_stage``."""
    return tuple(
        {int(s): to_torch(np.asarray(t, dtype=np.uint32), device)
         for s, t in tables.items()}
        for tables in (jax_ntt._high_tables, jax_ntt._low_batch_tables,
                       jax_ntt._low_lane_planes))


def sumcheck_state_from_jax(d: dict, device=None) -> dict:
    """A JAX ``Sumcheck.state_dict()`` -> the port's state dict, with the
    evaluation arrays as int32 tensors on ``device`` (resume with
    ``binius_ntt_tpu_torch.sumcheck.prover.Sumcheck.from_state_dict``)."""
    out = {k: int(d[k]) for k in ("num_vars", "composition_size", "round")}
    for k in ("device_evals", "host_evals"):
        out[k] = (None if d[k] is None
                  else to_torch(np.asarray(d[k], dtype=np.uint32), device))
    return out


def radix2_twiddles_from_jax(ntt_jax, device=None):
    """A JAX ``NTTRadix2``'s (n/2,) bit-reversed Montgomery twiddles ->
    an int32 tensor on ``device`` (the ``tw`` of the port's
    ``cuda_fused_bb31`` group functions)."""
    return to_torch(np.asarray(ntt_jax._tw_mont, dtype=np.uint32), device)


def prime_sumcheck_state_from_jax(d: dict, device=None) -> dict:
    """A JAX ``PrimeFieldSumcheck.state_dict()`` -> the port's, with the
    (2, rows, 4) evaluations as an int32 tensor on ``device`` (resume with
    ``binius_ntt_tpu_torch.sumcheck.prime_field.PrimeFieldSumcheck
    .from_state_dict``)."""
    return {"round": int(d["round"]),
            "evals": to_torch(np.asarray(d["evals"], dtype=np.uint32),
                              device)}


def _sharded_state(d: dict, keys, tail_from_jax, device) -> dict:
    out = {k: int(d[k]) for k in keys}
    out["evals"] = (None if d["evals"] is None
                    else to_torch(np.asarray(d["evals"], dtype=np.uint32),
                                  device))
    out["tail"] = (None if d["tail"] is None
                   else tail_from_jax(d["tail"], device))
    return out


def sharded_sumcheck_state_from_jax(d: dict, device=None) -> dict:
    """A JAX ``ShardedSumcheck.state_dict()`` -> the port's: the global
    evaluations as an int32 tensor on ``device``, or the single-device
    tail's state through :func:`sumcheck_state_from_jax` (resume with
    ``parallel.sumcheck_sharded.ShardedSumcheck.from_state_dict``)."""
    return _sharded_state(d, ("num_vars", "composition_size", "round"),
                          sumcheck_state_from_jax, device)


def sharded_prime_sumcheck_state_from_jax(d: dict, device=None) -> dict:
    """A JAX ``ShardedPrimeFieldSumcheck.state_dict()`` -> the port's, the
    tail through :func:`prime_sumcheck_state_from_jax` (resume with
    ``parallel.prime_sharded.ShardedPrimeFieldSumcheck
    .from_state_dict``)."""
    return _sharded_state(d, ("round",), prime_sumcheck_state_from_jax,
                          device)
