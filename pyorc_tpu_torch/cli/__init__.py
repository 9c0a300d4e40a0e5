"""Command-line interface: camera-config and velocimetry commands."""
