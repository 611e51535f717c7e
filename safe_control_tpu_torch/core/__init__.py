"""Core types and robot specification."""
