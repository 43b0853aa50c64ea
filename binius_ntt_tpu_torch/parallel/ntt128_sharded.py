"""Bit-sliced GF(2^128) additive NTT over the shards of a 1-D mesh.

Port of binius_ntt_tpu/parallel/ntt128_sharded.py.  The batch axis (n/32
bit-sliced batches of every coset) is block-sharded: shard d holds batches
[d Sb, (d+1) Sb) of each coset, as a (C, Sb, 128) int32 tensor of its own.
Stage s pairs batches 2^(s-5) apart:

  * 2^(s-5) >= Sb (the top log_d stages): the partner batch lives on shard
    d ^ 2^(s-5)/Sb.  The shards exchange whole shards (``mesh.exchange``)
    and each computes its half of the butterfly with one product, w * v:
    the u side's v is what it received, the v side's its own.  The
    twiddle is one 128-bit value a (coset, shard), expanded into planes
    and materialised to the operand's (N, 128) shape for
    ``cuda_kernels.mul_tiles``.  Each shard goes in OVERLAP_HALVES halves,
    each exchanged as a tensor of its own: every half's transfer is issued
    before the first multiply, and half i is waited for just before its
    own multiply, so on a process group half i+1 is still in flight while
    half i is multiplied (on a LocalMesh nothing is in flight);
  * the other stages are shard-local.  By default (``use_fused``) they run
    as the single-device stage-group chain (``cuda_fused.stage_group``) on
    the shard's batches, with the tables of ``build_tables_sharded`` and
    each shard's ``dplanes``: the device bits of every twiddle's
    indicator, XORed into the twiddle.  With ``use_fused=False`` they run
    one stage at a time, every product through ``mul_tiles``, with the
    per-stage tables sliced at the shard's offset.

The output is the single-device ``AdditiveNTT128.apply_sliced``'s: cosets
* nb rows, coset-major.  On a CUDA device every product and group is a
kernel launch; on the CPU the wrappers run their plain versions.

Spans (utils/timing.py, when on): ``sharded.apply_shards``, in it
``sharded.cross_stages`` (with the exchanges and bytes sent in its body
as counts, from the mesh's counters) and in that, for every half,
``sharded.exchange_wait`` (the wait for the half to arrive: on the
card, how long the stream stalls for it) and ``sharded.cross_mul`` (its
twiddle, product and XOR); ``setup.tables`` over the tables' build.
"""

from __future__ import annotations

import torch

from ..ntt import cuda_fused as cf
from ..ntt import cuda_kernels as ck
from ..ntt.additive import precompute_subspace_evals
from ..ntt.additive_bitsliced import HEIGHT, IPV, W, per_stage_tables
from ..fields.tower_simd import MASKS
from ..utils.bits import lsr, u32
from ..utils.timing import span

__all__ = ["ShardedAdditiveNTT128", "OVERLAP_HALVES", "shard_dplanes"]

# Each cross-device stage exchanges a shard in this many halves, so that on
# a process group one half's multiply runs while the next half is still in
# flight (cross_stages); the bytes exchanged stay one shard a stage.  1
# disables.
OVERLAP_HALVES = 2


def shard_dplanes(dtab: torch.Tensor, d: int) -> torch.Tensor:
    """Shard d's twiddle correction for ``cuda_fused.stage_group``: row d of
    every stage of a group's dtab (n_stages, 2^log_d, 4) as (n_stages, 128)
    all-ones/zeros bit-planes."""
    return ck._expand_bits(dtab[:, d]).contiguous()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as (N, 128) contiguous rows, mul_tiles' operand (a reshape of a
    strided or broadcast view may stay a view)."""
    return t.reshape(-1, W).contiguous()


class ShardedAdditiveNTT128:
    """Additive NTT over GF(2^128), bit-sliced, sharded over ``mesh``
    (parallel/mesh.py); the tables live on ``mesh.device``."""

    def __init__(self, log_h: int, log_rate: int, mesh,
                 use_fused: bool = True):
        if not 0 <= log_rate <= 4:
            raise ValueError("log_rate must be in [0, 4]")
        self.log_h = log_h
        self.log_rate = log_rate
        self.mesh = mesh
        n_dev = mesh.size
        self.log_d = n_dev.bit_length() - 1
        nb = (1 << log_h) // 32
        if log_h < 5 or nb < 2 * n_dev:
            raise ValueError(f"log_h {log_h} gives {nb} batches: need >= 2 "
                             f"batches a shard ({n_dev} shards)")
        self.use_fused = bool(use_fused)
        self.nb = nb
        self.sb = nb // n_dev
        with span("setup.tables"):
            self._build_tables()

    def _build_tables(self) -> None:
        log_h, log_rate, mesh = self.log_h, self.log_rate, self.mesh
        dev = mesh.device
        rows = precompute_subspace_evals(log_h, log_rate, HEIGHT)
        cross_lo = log_h - self.log_d          # first cross-device stage

        # shard-local stages: stage groups with a correction a shard, or
        # the per-stage tables
        self.groups = ()
        self.dplanes = {}
        if self.use_fused:
            self.groups = cf.build_tables_sharded(rows, log_h, log_rate,
                                                  self.log_d, dev)
            self.dplanes = {d: tuple(shard_dplanes(g[8], d)
                                     for g in self.groups)
                            for d in mesh.shards}
            stages = range(cross_lo, log_h)
        else:
            stages = range(log_h)
        self.high, self.low_batch, self.low_lanes = per_stage_tables(
            rows, log_h, log_rate, dev, stages=stages)

        # cross-device stages: each (stage, shard)'s twiddle planes, one a
        # coset, (C, 128)
        cosets = 1 << log_rate
        self._cross = {}
        for s in range(log_h - 1, cross_lo - 1, -1):
            bit = s - cross_lo           # the partner is shard d ^ 2^bit
            for d in mesh.shards:
                block = d >> (bit + 1)
                ind = torch.tensor([(c << (log_h - 1 - s)) | block
                                    for c in range(cosets)], device=dev)
                self._cross[s, d] = ck._expand_bits(self.high[s][ind])

    # ---- data in and out ----------------------------------------------

    def shard_input(self, data: torch.Tensor) -> dict:
        """data (nb, 128) int32 bit-sliced -> {d: (C, Sb, 128)} for the
        shards this process owns, each a new tensor on the mesh's device
        (the transform works on it in place)."""
        if (data.dtype != torch.int32 or data.dim() != 2
                or tuple(data.shape) != (self.nb, W)):
            raise ValueError(f"apply_sliced: expected ({self.nb}, {W}) "
                             f"int32, got {tuple(data.shape)} {data.dtype}")
        cosets, sb = 1 << self.log_rate, self.sb
        data = data.to(self.mesh.device)
        return {d: data[d * sb:(d + 1) * sb].repeat(cosets, 1)
                .view(cosets, sb, W) for d in self.mesh.shards}

    def gather_output(self, xs: dict) -> torch.Tensor:
        """The shards' outputs -> the (C * nb, 128) transform, on every
        process (one all_gather under a process group)."""
        parts = self.mesh.all_gather(xs)
        return torch.cat(parts, dim=1).reshape(-1, W)

    def apply_sliced(self, data: torch.Tensor) -> torch.Tensor:
        """data: (2^log_h/32, 128) int32 bit-sliced IN_ORDER input (left
        unchanged).  Returns the (2^(log_h+log_rate)/32, 128) output in the
        single-device order, on every process."""
        return self.gather_output(self.apply_shards(self.shard_input(data)))

    # ---- the transform -------------------------------------------------

    def apply_shards(self, xs: dict) -> dict:
        """The transform on sharded data, {d: (C, Sb, 128)} in, the same out
        (the local stages work in place)."""
        with span("sharded.apply_shards", self.mesh.device):
            xs = self.cross_stages(xs)
            for d in self.mesh.shards:
                if self.use_fused:
                    self.local_groups(xs[d], d)
                else:
                    xs[d] = self.local_stages(xs[d], d)
            return xs

    def cross_stages(self, xs: dict) -> dict:
        """The top log_d stages: one exchange a stage (in OVERLAP_HALVES
        tensors a shard) and one w * v product a half on every shard, each
        half's product as soon as that half has arrived."""
        if self.log_d == 0:
            return xs
        mesh = self.mesh
        sent, sent_bytes = mesh.exchanges, mesh.exchange_bytes
        with span("sharded.cross_stages", mesh.device) as sp:
            out = self._cross_stages(xs)
            sp.add("exchanges", mesh.exchanges - sent)
            sp.add("exchange_bytes", mesh.exchange_bytes - sent_bytes)
        return out

    def _cross_stages(self, xs: dict) -> dict:
        sb, log_h, mesh = self.sb, self.log_h, self.mesh
        cross_lo = log_h - self.log_d
        nh = OVERLAP_HALVES if sb % OVERLAP_HALVES == 0 else 1
        hb = sb // nh
        parts = {d: [x[:, i * hb:(i + 1) * hb].contiguous()
                     for i in range(nh)] for d, x in xs.items()}
        for s in range(log_h - 1, cross_lo - 1, -1):
            bit = s - cross_lo
            pending = mesh.exchange_async(parts, 1 << bit)
            new = {}
            for d in mesh.shards:
                i_am_v = (d >> bit) & 1
                w = self._cross[s, d]
                new[d] = []
                for p, arrived in zip(parts[d], pending[d]):
                    with span("sharded.exchange_wait", mesh.device):
                        recv = arrived.wait()   # the later halves fly on
                    # one product serves both sides: the u side needs w *
                    # recv, the v side w * its own half
                    with span("sharded.cross_mul", mesh.device):
                        v = p if i_am_v else recv
                        wp = _rows(w[:, None, :].expand(p.shape))
                        m = ck.mul_tiles(wp, _rows(v)).view(p.shape)
                        new[d].append((recv ^ m) ^ p if i_am_v else p ^ m)
            parts = new
        return {d: torch.cat(parts[d], dim=1) if nh > 1 else parts[d][0]
                for d in mesh.shards}

    def local_groups(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """Shard d's local stages as stage groups, in place."""
        for g, dpl in zip(self.groups, self.dplanes[d]):
            t0, k, low, mtile, minst, lanes, zero, chunk32, _ = g
            cf.stage_group(x, mtile, minst, lanes, t0=t0, k=k,
                           include_low=low, zero_flags=zero, chunk32=chunk32,
                           dplanes=dpl)
        return x

    def local_stages(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """Shard d's local stages one at a time (``use_fused=False``)."""
        cosets, sb, nb = 1 << self.log_rate, self.sb, self.nb
        for s in range(self.log_h - self.log_d - 1, 4, -1):
            db = 1 << (s - 5)
            gl, gg = sb // (2 * db), nb // (2 * db)
            w4 = self.high[s].view(cosets, gg, IPV)[:, d * gl:(d + 1) * gl]
            v5 = x.view(cosets, gl, 2, db, W)
            u, v = v5[:, :, 0], v5[:, :, 1]
            wp = ck._expand_bits(w4)[:, :, None, :].expand(u.shape)
            u ^= ck.mul_tiles(_rows(wp), _rows(v)).view(u.shape)
            v ^= u
        for s in range(min(self.log_h - 1, 4), -1, -1):
            a4 = self.low_batch[s].view(cosets, nb, IPV)[:, d * sb:(d + 1)
                                                         * sb]
            wp = ck._expand_bits(a4) ^ self.low_lanes[s]
            shift = 1 << s
            umask = MASKS[s]
            vmask = u32(umask << shift)
            un = x ^ ck.mul_tiles(_rows(wp),
                                  _rows(lsr(x, shift))).view(x.shape)
            x = (un & umask) | ((x ^ (un << shift)) & vmask)
        return x
