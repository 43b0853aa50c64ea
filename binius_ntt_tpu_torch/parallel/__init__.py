"""The sharded paths: a 1-D mesh of D shards (parallel/mesh.py) under the
GF(2^128) and GF(2^32) additive NTTs and the GF(2^128) and QM31 sumcheck
provers.  Port of binius_ntt_tpu/parallel/."""
