"""Command-line tools of the port (counterparts of ``tools/``)."""
