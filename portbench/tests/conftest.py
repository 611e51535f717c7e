"""The benchmark's tests: on the CPU, one thread (the plain paths' batched
solves), with the repository's root importable."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
torch.set_num_threads(1)
