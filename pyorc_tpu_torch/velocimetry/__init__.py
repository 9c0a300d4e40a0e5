"""PIV pipeline engine (device-streaming replacement for the reference's ffpiv wrapper)."""

from .engine import get_piv

__all__ = ["get_piv"]
