"""Launchers of the port: ``steps.make_decode_step`` and ``serve``."""
