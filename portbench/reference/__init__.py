"""The benchmark's plain float32 reference (imports ``torch`` only)."""
