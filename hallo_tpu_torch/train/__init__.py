"""Training (counterpart of hallo_tpu/train): the stage-2 step and trainer."""
