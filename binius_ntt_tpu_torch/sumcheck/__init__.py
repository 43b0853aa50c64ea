"""Subpackage of binius_ntt_tpu_torch."""
