"""pilosa_tpu_torch: the PyTorch/CUDA port of pilosa_tpu.

The same bitmap index — roaring-format storage (byte-compatible with
pilosa_tpu's data directories), PQL, the index/field/view/shard model —
with its bitplanes held as torch tensors in device memory and its counts
computed by CUDA kernels written for Hopper (ops/kernels.py,
csrc/bitplane_kernels.cu). Entry points run on the card unless the caller
asks for the CPU: ``Holder(path)`` needs a CUDA device, ``Holder(path,
device="cpu")`` runs the same code on the CPU with the kernels' plain
PyTorch twins.

This package imports torch and numpy, never jax and never pilosa_tpu.
"""

__version__ = "0.1.0"

from .core.holder import Holder
from .core.index import IndexOptions
from .core.field import FieldOptions
from .core.row import Row
from .executor import ExecOptions, Executor, ValCount
from .pql.parser import parse as parse_pql

__all__ = [
    "Holder",
    "IndexOptions",
    "FieldOptions",
    "Row",
    "ExecOptions",
    "Executor",
    "ValCount",
    "parse_pql",
    "__version__",
]
