"""Plain-tensor ops of the port."""
