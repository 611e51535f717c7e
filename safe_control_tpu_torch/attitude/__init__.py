"""Attitude (yaw side-channel) controllers for the integrator models."""
