"""uvic_tpu_torch — the PyTorch/CUDA port of ``uvic_tpu``: the ocean model
with its biogeochemistry and the coupled earth segment (EMBM atmosphere,
sea ice, land).

Same layout and names as ``uvic_tpu``; tensors are ``torch`` tensors on
one explicit device.  The hot spots that ``uvic_tpu`` wrote as Pallas
kernels for the TPU are CUDA C++ kernels for Hopper (``csrc/``), built
with ``nvcc`` at first use; each has a plain PyTorch version beside it,
which the wrappers take for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``.

Matmuls run in full float32 on the card: climate dynamics integrate
rounding noise over ~1e5 steps, and the products on the hot path (zonal
filter rows, vertical integrals feeding the barotropic solve) are
small.  A year-3 NaN of the earth configuration traced to reduced
matmul precision (``uvic_tpu/__init__.py``), so TF32 is switched off
here for matmuls and convolutions alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raises when there is no card and the caller
    did not ask for another device explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


__version__ = "0.1.0"
