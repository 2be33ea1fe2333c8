"""PixelSSL on PyTorch and CUDA: the port of ``pixelssl_tpu`` to one NVIDIA
H100.

The JAX package beside this one is the reference; each module here keeps
the file name of its counterpart there. This package imports ``torch``,
``numpy`` and ``scipy`` only. Importing it builds no kernel: the CUDA
sources under ``csrc/`` are compiled with ``nvcc`` the first time a kernel
meets a CUDA tensor.
"""

from .version import __version__

from . import utils
from . import nn
from . import ops
from . import models
from . import task_template
from . import tasks
from . import ssl_algorithm
from . import harness
from .runner import create_parser, run_script
