# The port's kernels: hand-written CUDA for Hopper under csrc/, each with a
# plain PyTorch version beside it and a device-dispatching wrapper in
# ops.py.  Kernel sources build at first launch (build.py), never at import.
from repro_torch.kernels import ops, ref  # noqa: F401
