"""cross_stages_ms: device ms a transform spends in
``ShardedAdditiveNTT128.cross_stages``, the top log2(ranks) stages: the
NCCL exchanges of whole shards and the ``mul_tiles`` products.  The
harness reports the slowest rank's."""

SPANS = ("binius_ntt_tpu_torch.parallel.ntt128_sharded:"
         "ShardedAdditiveNTT128.cross_stages",)


def read(win):
    return win.mean_span_ms(SPANS[0])
