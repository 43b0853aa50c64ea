"""Plain references of the benchmark: GF(2^128) tower arithmetic, the
additive NTT and the sumcheck prover, in Python integers and plain torch
operations.  Nothing here imports the program under test."""
