"""Request kinds, one module each, found by name (``harness.load_module``)."""
