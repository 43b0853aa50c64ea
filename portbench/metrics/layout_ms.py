"""layout_ms: device ms a transform of ``AdditiveNTT128.apply`` spends
outside its call into ``apply_sliced``: the bit-slicing layout transforms
of layout/bitslicing.py and the upload-free reshapes around them.  From
the event pairs around each window call and around apply_sliced."""

SPANS = ("binius_ntt_tpu_torch.ntt.additive_bitsliced:"
         "AdditiveNTT128.apply_sliced",)


def read(win):
    inner = win.spans.get(SPANS[0], {})
    its = [i for i in win.span_iterations() if i in inner]
    if not its:
        return None
    return sum(win.entry_ms[i] - inner[i] for i in its) / len(its)
