"""DSP ops of the receive step (planar or complex64 IQ, float32)."""
