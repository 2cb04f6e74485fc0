"""Utilities: the model zip format."""
