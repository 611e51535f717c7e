"""Barrier functions."""
