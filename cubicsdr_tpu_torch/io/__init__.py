"""IQ source policy."""
