"""The benchmark's plain reference: a frozen copy of the math that the
benchmarked cells run, in plain PyTorch.

It imports neither JAX, the JAX package, nor the PyTorch port: the models
(DynamicUnicycle2D, KinematicBicycle2D with the DPCBF barrier), the barrier
geometry, the augmented-Lagrangian Gauss-Newton MPC-CBF solve that the fused
kernel (B3) runs, the CBF-QP with its ADMM sweep (B2), equilibration and
polish, and the tracking step's state machine, obstacle selection, nominal
input, collision oracle and the moving obstacles.  Every function takes a
``spec`` namespace of plain floats built from a configuration file.
"""
