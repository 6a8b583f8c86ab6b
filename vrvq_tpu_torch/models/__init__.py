"""Models of the port: the VBR quantizer and DAC_VRVQ."""
