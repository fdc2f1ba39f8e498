"""DSP ops of the reference's receive chain (a frozen copy of the port's
``ops``, planar float32)."""
