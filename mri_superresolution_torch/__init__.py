"""mri_superresolution_torch — the PyTorch/CUDA port of the MRI
super-resolution framework, for one NVIDIA H100.

It serves the parity ``unet`` (``UNetSuperRes``, bf16 compute on fp32
params) through ``infer.InferenceEngine``. The three hot operations of that
path run as hand-written CUDA kernels (``kernels/``, sources in ``csrc/``):
fused GroupNorm+LeakyReLU, the narrow-Cout 3x3 conv and the fused SSIM.
Each kernel keeps a plain PyTorch version beside it, which the wrapper uses
for CPU tensors only.

The package imports torch and nothing of JAX. Importing a module neither
initialises CUDA nor imports triton; kernels are built at first use.
"""

__version__ = "0.1.0"
