"""The tracking loop: the functional tracker step and its host-side controller."""
