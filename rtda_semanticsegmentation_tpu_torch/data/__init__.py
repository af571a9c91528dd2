"""Label semantics shared by the port's CLIs."""
