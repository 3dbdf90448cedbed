"""The epilogue kernel's wrapper and operator (``kernels/bias_epilogue.py``)
and EDSR's choice of path (``models/edsr.py``), on the CPU: the plain
version is the fp32 formula, the operator's fake implementation gives the
output's shape, dtype and layout, the wrapper refuses what the kernel does
not take, and EDSR takes the kernel only with grad off on a CUDA input,
keeping today's PyTorch ops, bit for bit, everywhere else. The kernel
itself is held to the plain version on the card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from mri_superresolution_torch import kernels
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer import InferenceEngine
from mri_superresolution_torch.infer.export import (export_artifact,
                                                    load_artifact)
from mri_superresolution_torch.kernels.bias_epilogue import (
    bias_epilogue_plain, serves)
from mri_superresolution_torch.models import build_model, edsr
from mri_superresolution_torch.models.unet import CL, _conv
from mri_superresolution_torch.ops.functional import pixel_shuffle

torch.set_num_threads(2)

VARIANTS = {"bias": {}, "relu": {"relu": True},
            "residual": {"residual": True, "scale": 1.0},
            "scaled": {"residual": True, "scale": 0.1}}


def _cl(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(
        memory_format=CL)


def _args(variant, dtype, shape=(2, 16, 5, 7)):
    y, r = _cl(shape, dtype, 0), _cl(shape, dtype, 1)
    b = torch.randn(shape[1], generator=torch.Generator().manual_seed(2))
    kw = dict(VARIANTS[variant])
    if kw.pop("residual", False):
        kw["residual"] = r
    return y, b, kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_operator_on_cpu_is_the_fp32_formula(variant, dtype):
    """The operator's CPU implementation: ``[r +] scale * act(y + b)``, each
    step an fp32 operation, rounded once to y's dtype, channels_last."""
    y, b, kw = _args(variant, dtype)
    got = torch.ops.mri_sr.bias_epilogue(
        y, b, kw.get("residual"), kw.get("relu", False), kw.get("scale", 1.0))
    t = y.float() + b[None, :, None, None]
    if kw.get("relu"):
        t = torch.where(t < 0, torch.zeros_like(t), t)
    t = t * torch.tensor(kw.get("scale", 1.0), dtype=torch.float32)
    if "residual" in kw:
        t = kw["residual"].float() + t
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, t.to(dtype))
    assert torch.equal(got, bias_epilogue_plain(y, b, **kw))


@pytest.mark.parametrize("variant", ["bias", "scaled"])
def test_wrapper_in_place_writes_y(variant):
    y, b, kw = _args(variant, torch.bfloat16)
    want = bias_epilogue_plain(y, b, **kw)
    out = kernels.bias_epilogue(y, b, inplace=True, **kw)
    assert out is y and torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_gives_shape_dtype_and_layout(dtype):
    """The fake implementation (what ``torch.export`` traces) on CUDA
    tensors that hold no memory: y's shape and dtype, channels_last."""
    with FakeTensorMode():
        y = torch.empty(3, 64, 9, 11, dtype=dtype, device="cuda",
                        memory_format=CL)
        r = torch.empty_like(y)
        b = torch.empty(64, device="cuda")
        out = torch.ops.mri_sr.bias_epilogue(y, b, r, True, 0.5)
        assert out.shape == y.shape and out.dtype == dtype
        assert out.device.type == "cuda"
        assert out.is_contiguous(memory_format=CL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    y, b, _ = _args("bias", torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        kernels.bias_epilogue(y.contiguous(), b)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.bias_epilogue(_cl((1, 12, 4, 4), torch.bfloat16, 0),
                              torch.zeros(12))
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.bias_epilogue(y.half(), b)
    with pytest.raises(ValueError, match="bias"):
        kernels.bias_epilogue(y, b.bfloat16())
    with pytest.raises(ValueError, match="residual"):
        kernels.bias_epilogue(y, b, residual=y.float())
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.bias_epilogue(y, b.clone().requires_grad_())


@pytest.mark.parametrize("grad,device,c,dtype,want", [
    (False, "cuda", 64, torch.bfloat16, True),
    (False, "cuda", 16, torch.float32, True),
    (True, "cuda", 64, torch.bfloat16, False),
    (False, "cpu", 64, torch.bfloat16, False),
    (False, "cuda", 12, torch.bfloat16, False),
    (False, "cuda", 64, torch.float16, False)])
def test_edsr_takes_the_kernel_only_when_serving_on_the_card(
        grad, device, c, dtype, want):
    """The choice from what the forward can observe: grad mode, the
    input's device, the width and the compute dtype."""
    with FakeTensorMode():
        x = torch.empty(2, 1, 8, 8, device=device)
        with torch.set_grad_enabled(grad):
            assert edsr._fused(x, c, dtype) is want


def _edsr(dtype, blocks=2, f=16, seed=0):
    """An EDSR whose every parameter carries seeded noise (the zero-init
    conv1 weights and zero biases too)."""
    m = build_model(ModelConfig(model_type="edsr", base_filters=f,
                                num_blocks=blocks), dtype=dtype,
                    generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return m


def _todays_forward(m, x):
    """EDSR's forward as the PyTorch ops compose it without the kernel:
    each conv with its bias, ``F.relu``, ``x + res_scale * y``, the skip."""
    dt = m.dtype
    x = x.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
    head = _conv(x, m.head.weight, dt, m.head.bias, padding=1)
    y = head
    for i in range(m.num_blocks):
        blk = getattr(m, f"block{i}")
        z = F.relu(_conv(y, blk.conv0.weight, dt, blk.conv0.bias, padding=1))
        z = _conv(z, blk.conv1.weight, dt, blk.conv1.bias, padding=1)
        y = y + blk.res_scale * z
    y = _conv(y, m.body_out.weight, dt, m.body_out.bias, padding=1)
    y = _conv(y + head, m.tail.weight, dt, m.tail.bias, padding=1)
    return torch.sigmoid(pixel_shuffle(y, 2).float()).permute(0, 2, 3, 1)


class _Calls:
    def __init__(self, monkeypatch):
        self.n = 0
        real = edsr.bias_epilogue

        def counting(*a, **k):
            self.n += 1
            return real(*a, **k)
        monkeypatch.setattr(edsr, "bias_epilogue", counting)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_edsr_on_cpu_or_with_grad_keeps_todays_ops(grad, dtype, monkeypatch):
    """On the CPU, and with grad on, EDSR's forward calls no epilogue and
    gives today's values bit for bit."""
    calls = _Calls(monkeypatch)
    m = _edsr(dtype)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 12, 10, 1), np.float32))
    with torch.set_grad_enabled(grad):
        got = m(x)
        want = _todays_forward(m, x)
    assert calls.n == 0
    assert got.requires_grad == grad
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edsr_fused_composition_on_cpu(dtype, monkeypatch):
    """The fused path's wiring, run here by its plain versions: with the
    device test waived, a forward without grad calls the epilogue
    2 * num_blocks + 2 times, and gives today's output within the
    rounding of where the bias is added (fp32: 1e-5; bf16: a few ulp of
    the trunk's activations, far inside the serving budget)."""
    monkeypatch.setattr(edsr, "_fused", lambda x, f, dt: (
        not torch.is_grad_enabled() and serves(f, dt)))
    calls = _Calls(monkeypatch)
    m = _edsr(dtype, blocks=3)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 12, 10, 1), np.float32))
    with torch.no_grad():
        got = m(x)
        assert calls.n == 2 * 3 + 2
        want = _todays_forward(m, x)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    with torch.enable_grad():
        m(x)
    assert calls.n == 2 * 3 + 2


@pytest.mark.parametrize("fused", [False, True])
def test_edsr_artifact_round_trip(fused, tmp_path, monkeypatch):
    """An EDSR serving artifact (``torch.export``, symbolic batch) loads
    and serves the engine's output; with the kernel's path taken while
    tracing (the device test waived, as on the card) the program holds the
    operator at each of the 2 * num_blocks + 2 sites and runs it by its CPU
    implementation."""
    if fused:
        monkeypatch.setattr(edsr, "_fused", lambda x, f, dt: (
            not torch.is_grad_enabled() and
            serves(f, dt)))
    cfg = ModelConfig(model_type="edsr", base_filters=8, num_blocks=2)
    sd = _edsr(torch.float32, f=8).state_dict()
    path = str(tmp_path / "edsr.mrisrt")
    export_artifact(path, sd, cfg, [(16, 24)], bf16=False)
    art = load_artifact(path, device="cpu")
    prog = next(iter(art._programs.values()))
    ops = [str(n.target) for n in prog.graph.nodes
           if n.op == "call_function"]
    assert ops.count("mri_sr.bias_epilogue.default") == (6 if fused else 0)
    x = np.random.default_rng(2).random((3, 16, 24)).astype(np.float32)
    eng = InferenceEngine(cfg, sd, bf16=False, device="cpu")
    np.testing.assert_allclose(art.upscale_batch(x), eng.upscale_batch(x),
                               rtol=1e-5, atol=1e-6)
