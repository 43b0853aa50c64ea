"""ntt_kernels_roofline: the transform's bound (portbench/roofline.py,
from its shapes and the reference's twiddles) over the device ms of its
call into ``cuda_fused.apply_fused``, the whole stage-group chain with
the copy into the cosets, in percent."""

from portbench import roofline

SPANS = ("binius_ntt_tpu_torch.ntt.cuda_fused:apply_fused",)


def read(win):
    ms = win.mean_span_ms(SPANS[0])
    if not ms:
        return None
    cfg = win.config
    return 100.0 * roofline.ntt128_bound_ms(cfg["log_h"], cfg["log_rate"]) / ms
