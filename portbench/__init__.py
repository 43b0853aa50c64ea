"""The benchmark of binius_ntt_tpu_torch on the H100 (see run.py)."""
