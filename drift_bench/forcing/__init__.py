"""Forcing-file writers: one module a writer, named by a configuration's
``forcing`` entries."""
