"""Leveled logger (reference: include/icicle/utils/log.h ICICLE_LOG_*)."""

import logging
import os

logger = logging.getLogger("icicle_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[ICICLE-TORCH] [%(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("ICICLE_TPU_LOG_LEVEL", "WARNING").upper())
