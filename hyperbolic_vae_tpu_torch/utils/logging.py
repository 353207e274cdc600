"""Coloured console logging.

Port of ``hyperbolic_vae_tpu/utils/logging.py`` (the reference's
``hyperbolic_vae/util.py``). The JAX package's other utility,
``utils/config.py::enable_compilation_cache``, is XLA's compile cache and
has no counterpart: the port's kernels are built once into ``_build/``.
"""

from __future__ import annotations

import logging

_COLORS = {
    "DEBUG": "\033[36m",       # cyan
    "INFO": "\033[32m",        # green
    "WARNING": "\033[33m",     # yellow
    "ERROR": "\033[31m",       # red
    "CRITICAL": "\033[1;31m",  # bold red
}
_RESET = "\033[0m"


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        return f"{color}{msg}{_RESET}" if color else msg


def configure_handler_for_script(level: str = "INFO") -> None:
    """Put a coloured stream handler on the root logger, as every
    reference script does by hand."""
    root = logging.getLogger()
    root.setLevel(level)
    handler = logging.StreamHandler()
    handler.setFormatter(
        ColoredFormatter("%(asctime)s %(name)s %(funcName)s %(levelname)s %(message)s")
    )
    root.addHandler(handler)
