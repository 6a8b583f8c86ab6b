"""Plain PyTorch references of the codec and its train step, independent of
the program: they import nothing of ``vrvq_tpu_torch``."""
