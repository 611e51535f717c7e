"""MPC solvers."""
