"""Host-side parallelism helpers."""
