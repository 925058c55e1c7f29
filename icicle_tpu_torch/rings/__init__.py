"""The babykoala ring Z_q, its RNS form and R_q = Z_q[X]/(X^64 + 1)
(counterpart of icicle_tpu/rings/)."""
