"""Runtime layers."""
