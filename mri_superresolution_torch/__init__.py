"""mri_superresolution_torch — the PyTorch/CUDA port of the MRI
super-resolution framework, for one NVIDIA H100.

It serves every model family of ``models/families.py``, the JAX package's
four and SwinIR's classical 2x network (bf16 compute on fp32 params; the
table says which export, and ``models/quant_forward.py`` and
``parallel/spatial.py`` which run int8 and row-sharded), through
``infer.InferenceEngine``, in bf16 or, with ``quant="int8"``, as the int8
post-training-quantized forward of ``models/quant_forward.py``, and trains
them (``train.trainer.train``, ``python -m
mri_superresolution_torch.cli.train``: L1 + SSIM and the VGG19 perceptual
term, torch-style Adam, the JAX package's checkpoints). The hot operations
of those paths run as hand-written CUDA kernels (``kernels/``, sources in
``csrc/``): fused GroupNorm+LeakyReLU and its backward, the narrow-Cout
3x3 conv, the fused SSIM, the fused LeakyReLU+int8 quantize, a conv's bias
epilogue and SwinIR's shifted-window attention; the roll/stencil probe of
``tools/roll_probe.py`` has three more. Each kernel keeps a plain PyTorch
version beside it, which the wrapper uses for CPU tensors only.

The package imports torch and nothing of JAX. Importing a module neither
initialises CUDA nor imports triton; kernels are built at first use.
"""

__version__ = "0.1.0"
