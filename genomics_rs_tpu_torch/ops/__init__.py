"""Device operations: Gotoh fills, traceback walks, substitution scores.

Each kernel module keeps a hand-written CUDA kernel (``csrc/``) and
its plain PyTorch version side by side; the wrapper picks by the
device of the tensors it is given.
"""
