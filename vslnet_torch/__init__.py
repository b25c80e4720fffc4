"""vslnet_torch: the PyTorch + CUDA port of vslnet_tpu for NVIDIA Hopper.

The serving path, from request to span: data helpers, the VSLNet model,
hand-written CUDA kernels for its hot blocks (ops/kernels.py, csrc/), the
`Localizer` and the stdlib HTTP server. The training path: dropout,
backward kernels behind autograd Functions, the losses, the optimizer and
the `Trainer` (train/). Importing the package imports no
JAX and builds nothing: the CUDA library is compiled and loaded at the
first kernel launch.
"""

__version__ = "0.1.0"
