"""Perception: the occupancy-grid sensing footprint and FoV detection."""
