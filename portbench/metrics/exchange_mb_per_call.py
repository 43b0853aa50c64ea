"""exchange_mb_per_call: MB (1e6 bytes) a rank sends a transform in the
shard exchanges of its cross-device stages: the ``exchange_bytes`` count
the program's ``sharded.cross_stages`` span takes from the mesh's
counter.  Fixed by the shapes: one whole shard a cross-device stage."""

from portbench import program_spans

program_spans.arm()


def read(win):
    got = program_spans.program_count(win, "sharded.cross_stages",
                                      "exchange_bytes")
    return None if got is None else got / 1e6
