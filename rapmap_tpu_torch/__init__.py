"""rapmap_tpu_torch: the PyTorch/CUDA port of tpu-quasimap.

A second package beside `rapmap_tpu` (the JAX reference, which it never
imports). Host-side index code is a copy of the reference's numpy/C++
modules; the device engine is plain PyTorch on tensors with an explicit
`device`, and the reference's Pallas kernel is a hand-written CUDA kernel
(`csrc/`). Entry points run on the CUDA card unless the caller asks for the
CPU, where every kernel wrapper uses its plain PyTorch version.
"""

from rapmap_tpu_torch.version import __version__  # noqa: F401
