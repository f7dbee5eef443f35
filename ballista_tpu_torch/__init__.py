"""ballista_tpu_torch: the Ballista-TPU query engine ported to PyTorch and CUDA.

A second package beside the JAX reference package ``ballista_tpu``. The host
layers (SQL, logical plans, optimizer, physical host operators) are kept as
this package's own copies; the device layer (``ops/``) runs on PyTorch
tensors, with hand-written CUDA kernels for what the reference ran as Pallas
TPU kernels (``csrc/``). Device selection is explicit: an
``ExecutionContext`` runs on ``torch.device("cuda")`` unless it is given
``device="cpu"``, and never falls back to the CPU on its own.
"""

BALLISTA_TPU_TORCH_VERSION = "0.1.0"

from ballista_tpu_torch.errors import BallistaError  # noqa: E402,F401
