"""GAN training of the codec (counterpart of ``vrvq_tpu/train``)."""
