"""Device compute: frame filters, orthorectification, PIV correlation."""

from . import piv, windows

__all__ = ["piv", "windows"]
