"""Model configs (the port keeps its own copies; see ``registry``)."""
