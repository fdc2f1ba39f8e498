"""DSP ops of the receive step (planar complex, float32)."""
