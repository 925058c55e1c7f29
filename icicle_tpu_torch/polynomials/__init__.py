from icicle_tpu_torch.polynomials.polynomial import Polynomial

__all__ = ["Polynomial"]
