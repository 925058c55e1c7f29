"""Host-side utilities (counterpart of icicle_tpu/utils/)."""
