"""The per-file filter stage."""
