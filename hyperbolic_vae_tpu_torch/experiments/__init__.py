"""Command-line experiments of the port (counterparts of ``experiments/``)."""
