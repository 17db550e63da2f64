"""Models ported so far: the DLRM (RM1/RM2)."""
