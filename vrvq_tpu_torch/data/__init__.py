"""The training data pipeline: wav excerpts drawn by index, batches, and the
transforms applied on the device (counterpart of ``vrvq_tpu/data``)."""
