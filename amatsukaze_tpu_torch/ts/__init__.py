"""Transport-stream side of the port: so far the QP-map container that
feeds the deblock post filter."""
