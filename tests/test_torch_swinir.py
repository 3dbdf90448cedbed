"""SwinIR (``models/swinir.py``) against its plain fp32 reference
(``tests/swinir_reference.py``, written from the published
``network_swinir.py``) on the CPU at a tiny size: the forward, one L1 +
SSIM step's gradients, the window attention's plain version, the mask and
the relative index, planted faults that the comparison must catch, the
paths that refuse the family, its checkpoints and its defaults."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import swinir_reference as ref
from mri_superresolution_torch import config as cfg_mod
from mri_superresolution_torch.config import LossConfig, ModelConfig
from mri_superresolution_torch.infer import InferenceEngine, load_engine
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import FAMILIES, build_model
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.weights import swinir_widths

# the module (the package's ``kernels.window_attention`` is the function)
wa = importlib.import_module("mri_superresolution_torch.kernels."
                             "window_attention")
torch.set_num_threads(2)

TINY = ModelConfig(model_type="swinir", base_filters=24, num_blocks=2,
                   swin_depth=2, swin_heads=3, window_size=4, num_feat=16)
REF_CFG = {"embed_dim": 24, "layers": 2, "depth": 2, "heads": 3, "window": 4}
BENCH_CFG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "swinir-classical-x2.json"
# fp32 agreement of the port and the reference, relative to the output's
# largest magnitude: the same operations in another order
RTOL = 1e-4


def _params(seed=0, std=0.3):
    """The tiny model's state_dict, every tensor moved by N(0, std) so
    that no part is at its init (LN scales 1, tables and biases 0)."""
    sd = build_model(TINY, generator=torch.Generator().manual_seed(seed)
                     ).state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    return {k: v + std * torch.randn(v.shape, generator=g)
            for k, v in sd.items()}


def _model(p, dtype=torch.float32):
    m = build_model(TINY, dtype=dtype)
    m.load_state_dict(p, strict=True)
    return m


def _x(shape, seed=3):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _gap(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("hw", [(16, 16), (18, 14)])
def test_forward_matches_reference_fp32(hw):
    """At 16 x 16, and at 18 x 14, which takes the reflect pad to 20 x 16
    and the crop back."""
    p = _params()
    x = _x((2,) + hw + (1,))
    with torch.no_grad():
        got = _model(p)(x)
        want = ref.forward(p, x, REF_CFG)
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 1)
    assert _gap(got, want) < RTOL


def test_bf16_forward_is_near_the_reference():
    p = _params()
    x = _x((2, 16, 16, 1))
    with torch.no_grad():
        got = _model(p, torch.bfloat16)(x)
        want = ref.forward(p, x, REF_CFG)
    assert got.dtype == torch.float32
    assert _gap(got, want) < 0.05


def test_gradients_of_one_l1_ssim_step_match_reference():
    """The port's loss (L1 + SSIM 0.3, the trainer's) of the port's fp32
    forward, and the reference's written-out loss of its own forward:
    the same loss, and every leaf's gradient within 1e-4 of the largest
    leaf gradient's norm."""
    p = _params(std=0.05)
    x = _x((2, 16, 16, 1))
    hr = _x((2, 32, 32, 1), seed=4)
    model = _model(p)
    loss, _ = CombinedLoss(LossConfig())(model(x), hr)
    names = [k for k, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want_loss = ref.l1_ssim_loss(ref.forward(leaves, x, REF_CFG), hr)
    want = dict(zip(leaves, torch.autograd.grad(want_loss, list(
        leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-5)
    assert set(got) == set(want)
    top = max(float(g.norm()) for g in want.values())
    for k in want:
        assert float((got[k] - want[k]).norm()) <= 1e-4 * top, k
    assert float(want["layers.0.residual_group.blocks.1.attn."
                      "relative_position_bias_table"].norm()) > 0


@pytest.mark.parametrize("shape, heads, ws, shift", [
    ((2, 16, 16, 24), 3, 4, 2), ((1, 8, 24, 12), 2, 4, 0),
    ((1, 16, 24, 36), 3, 8, 4)])
def test_window_attention_plain_matches_reference(shape, heads, ws, shift):
    g = torch.Generator().manual_seed(5)
    b, h, w, c = shape
    qkv = torch.randn(b, h, w, 3 * c, generator=g)
    table = torch.randn((2 * ws - 1) ** 2, heads, generator=g)
    got = wa.window_attention_plain(qkv, table, heads, ws, shift)
    want = ref.attention_from_qkv(qkv, table, heads, ws, shift)
    assert got.shape == want.shape == (b, h, w, c)
    assert _gap(got, want) < 1e-5
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(wa.window_attention(qkv, table, heads, ws, shift),
                       got)


def test_window_attention_takes_wider_rows():
    """qkv in rows of 112 for C = 36 (3C = 108) and the output in rows of
    40: the first 36 output channels are the packed rows' attention, the
    rest zeros, whatever qkv holds past 3C."""
    g = torch.Generator().manual_seed(6)
    qkv = torch.randn(1, 16, 24, 112, generator=g)
    table = torch.randn(49, 3, generator=g)
    got = wa.window_attention(qkv, table, 3, 4, 2, 36, 40)
    want = wa.window_attention(qkv[..., :108].contiguous(), table, 3, 4, 2)
    assert got.shape == (1, 16, 24, 40)
    assert torch.equal(got[..., :36], want)
    assert not got[..., 36:].any()


def test_the_kernel_serves_the_published_widths():
    bf = torch.bfloat16
    assert wa.serves(180, 6, 8, 4, bf) and wa.serves(180, 6, 8, 0, bf)
    assert not wa.serves(180, 6, 8, 4, torch.float32)      # bf16 only
    assert not wa.serves(180, 6, 8, 2, bf)                 # shift 0 or 4
    assert not wa.serves(24, 3, 4, 2, bf)                  # window 8
    assert not wa.serves(90, 6, 8, 4, bf)                  # odd head size
    assert not wa.serves(396, 6, 8, 4, bf)                 # head size 66


@pytest.mark.parametrize("h, w, ws, shift", [
    (16, 16, 4, 2), (8, 24, 8, 4), (32, 40, 8, 4), (12, 8, 4, 2)])
def test_mask_and_index_match_the_published_construction(h, w, ws, shift):
    """The port's masks and indices, from coordinates, against the
    published ``calculate_mask`` slices and ``relative_position_index``;
    and a few entries by hand."""
    mask = wa.region_mask(h, w, ws, shift)
    assert torch.equal(mask, ref.calculate_mask(h, w, ws, shift))
    idx = wa.relative_index(ws)
    assert torch.equal(idx, ref.relative_position_index(ws))
    n = ws * ws
    # dy = dx = 0 on the diagonal; query (0, 0) against key (ws-1, ws-1)
    assert set(idx.diagonal().tolist()) == {(ws - 1) * (2 * ws - 1) + ws - 1}
    assert int(idx[0, n - 1]) == 0
    assert int(idx[n - 1, 0]) == (2 * ws - 1) ** 2 - 1
    # the first window lies in one region (where the frame is more than
    # a window high and wide); the last mixes all of them
    assert mask[0].any() == (h == ws or w == ws)
    last = mask[-1]
    assert last[0, n - 1] == -100.0 and last[0, 1] == 0.0
    assert int((last == 0).sum()) == (ws - shift) ** 2 * (ws - shift) ** 2 \
        + 2 * ((ws - shift) * shift) ** 2 + shift ** 4


# C = 36 in 3 heads: rows of 40, qkv of 112, the MLP's 72 already whole
WIDE = ModelConfig(model_type="swinir", base_filters=36, num_blocks=2,
                   swin_depth=2, swin_heads=3, window_size=4, num_feat=16)


def _todays_forward(m, x):
    """The unpadded forward as the module ran it before the served path
    took 16-byte rows: every op on C-wide tokens, the weights cast to the
    compute dtype, PyTorch's LayerNorm."""
    from mri_superresolution_torch.models.unet import _conv
    from mri_superresolution_torch.ops.functional import pixel_shuffle
    import torch.nn.functional as F
    dt, w = m.dtype, m.window

    def ln(t, n):
        return F.layer_norm(t, n.normalized_shape, n.weight.to(t.dtype),
                            n.bias.to(t.dtype), n.eps)

    def lin(t, li):
        return F.linear(t, li.weight.to(t.dtype), li.bias.to(t.dtype))

    def conv(t, cv):
        return _conv(t, cv.weight, dt, cv.bias, padding=1)

    _, h0, w0, _ = x.shape
    x = x.permute(0, 3, 1, 2).float()
    ph, pw = (-h0) % w, (-w0) % w
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="reflect")
    x = x.to(dt).contiguous(memory_format=torch.channels_last)
    f = conv(x, m.conv_first).permute(0, 2, 3, 1)
    t = ln(f, m.patch_embed.norm)
    for layer in m.layers:
        y = t
        for b in layer.residual_group.blocks:
            a = b.attn
            qkv = lin(ln(y, b.norm1), a.qkv)
            o = wa.window_attention(qkv, a.relative_position_bias_table,
                                    a.heads, a.window, b.shift)
            y = y + lin(o, a.proj)
            y = y + lin(F.gelu(lin(ln(y, b.norm2), b.mlp.fc1)), b.mlp.fc2)
        t = t + conv(y.permute(0, 3, 1, 2), layer.conv).permute(0, 2, 3, 1)
    t = ln(t, m.norm)
    y = (f + conv(t.permute(0, 3, 1, 2), m.conv_after_body).permute(
        0, 2, 3, 1)).permute(0, 3, 1, 2)
    y = F.leaky_relu(conv(y, m.conv_before_upsample[0]), 0.01)
    y = pixel_shuffle(conv(y, m.upsample[0]), 2)
    y = conv(y, m.conv_last)
    return y[:, :, :2 * h0, :2 * w0].float().permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_cpu_and_grad_forwards_keep_todays_ops_bit_for_bit(dtype, grad):
    """Off the served path (the CPU; grad on or off; fp32 or bf16) the
    forward runs the unpadded ops it always ran, to the bit."""
    torch.manual_seed(0)
    m = build_model(WIDE, dtype=dtype,
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    x = _x((2, 18, 14, 1))
    with torch.set_grad_enabled(grad):
        assert not m.served(x)
        got = m(x)
        want = _todays_forward(m, x)
    assert got.requires_grad == grad
    assert torch.equal(got, want)


def test_padded_ops_keep_the_first_outputs_and_zero_the_pad():
    """Each linear and conv with its weight zero-padded to 16-byte rows of
    inputs and outputs: the first outputs equal the unpadded op's in fp32,
    the pad outputs are exactly 0."""
    from mri_superresolution_torch.models import swinir as sw
    m = build_model(WIDE, generator=torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    blk = m.layers[0].residual_group.blocks[0]
    x = torch.randn(2, 8, 8, 36, generator=g)
    xp = torch.nn.functional.pad(x, (0, 4))
    h = torch.randn(2, 8, 8, 72, generator=g)
    for lin, inp, pinp in ((blk.attn.qkv, x, xp), (blk.attn.proj, x, xp),
                           (blk.mlp.fc1, x, xp), (blk.mlp.fc2, h, h)):
        got = sw._linear(pinp, lin, True)
        want = sw._linear(inp, lin, False)
        n = lin.out_features
        assert got.shape[-1] == sw.row_width(n, True) == -(-n // 8) * 8
        torch.testing.assert_close(got[..., :n], want, rtol=1e-6, atol=1e-6)
        assert not got[..., n:].any()
    for conv, inp, pinp in ((m.layers[0].conv, x, xp),
                            (m.conv_after_body, x, xp)):
        got = sw._conv_tokens(pinp, conv, torch.float32, True)
        want = sw._conv_tokens(inp, conv, torch.float32, False)
        assert got.shape[-1] == 40
        torch.testing.assert_close(got[..., :36], want, rtol=1e-5, atol=1e-5)
        assert not got[..., 36:].any()
    up = m.conv_before_upsample[0]                 # Cp in, num_feat out
    got = sw._conv_to(xp.permute(0, 3, 1, 2), up, torch.float32, 16)
    want = sw._conv_to(x.permute(0, 3, 1, 2), up, torch.float32, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # no padding where the shapes agree: the cast alone, as before
    assert sw.padded(up.weight, up.weight.shape, torch.float32) is up.weight


def test_padded_forward_equals_the_unpadded_one_in_fp32():
    """The served path's arithmetic on the CPU (plain LayerNorm and
    attention over 16-byte rows): the whole forward within fp32 rounding
    of the unpadded one, at C = 36 (rows of 40) and at C = 24 (rows
    already whole)."""
    for cfg in (WIDE, TINY):
        m = build_model(cfg, generator=torch.Generator().manual_seed(10))
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
            x = _x((2, 18, 14, 1))
            got = m._forward(x, True)
            want = m._forward(x, False)
        assert _gap(got, want) < 1e-5, cfg.base_filters


def _no_shift(monkeypatch, model):
    for layer in model.layers:
        for blk in layer.residual_group.blocks:
            monkeypatch.setattr(blk, "shift", 0)


FAULTS = {
    "no_shift": _no_shift,
    "no_mask": lambda mp, m: mp.setattr(
        wa, "region_mask", lambda h, w, ws, s, device=None: torch.zeros(
            (h // ws) * (w // ws), ws * ws, ws * ws, device=device)),
    "roll_reversed": lambda mp, m: mp.setattr(
        wa, "_roll", lambda x, s: torch.roll(x, (-s, -s), (1, 2))),
    "bias_index_transposed": lambda mp, m: mp.setattr(
        wa, "relative_index", lambda ws, device=None: ref
        .relative_position_index(ws).t().contiguous().to(device)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_comparison(monkeypatch, fault):
    """Each fault in the port's attention moves its output far outside
    the tolerance the sound port meets."""
    p = _params()
    x = _x((2, 16, 16, 1))
    model = _model(p)
    FAULTS[fault](monkeypatch, model)
    with torch.no_grad():
        got = model(x)
        want = ref.forward(p, x, REF_CFG)
    assert _gap(got, want) > 100 * RTOL, fault


def test_int8_row_sharding_and_export_refuse_the_family(tmp_path):
    from mri_superresolution_torch.infer.export import export_artifact
    p = _params()
    with pytest.raises(ValueError, match="not 'swinir'"):
        InferenceEngine(TINY, p, device="cpu", quant="int8")
    with pytest.raises(ValueError, match="not 'swinir'"):
        InferenceEngine(TINY, p, device="cpu", spatial_shards=2,
                        num_devices=2)
    with pytest.raises(ValueError, match="not 'swinir'"):
        export_artifact(str(tmp_path / "a.mrisrt"), p, TINY, [(16, 16)],
                        bf16=False, platforms=("cpu",))
    assert not (tmp_path / "a.mrisrt").exists()


def test_defaults_are_the_benchmark_configs_widths():
    cfg = json.loads(BENCH_CFG.read_text())
    mc = ModelConfig(model_type="swinir")
    assert (mc.swin_depth, mc.swin_heads, mc.window_size, mc.mlp_ratio,
            mc.num_feat) == (cfg["depth"], cfg["num_heads"],
                             cfg["window_size"], cfg["mlp_ratio"],
                             cfg["num_feat"])
    assert FAMILIES["swinir"].cli_widths == {
        "base_filters": cfg["base_filters"], "num_blocks": cfg["num_blocks"]}
    assert (cfg["base_filters"], cfg["num_blocks"]) == (180, 6)
    # no sidecar carries the Swin widths: the weights' shapes do
    assert not set(cfg_mod.SWIN_FIELDS) & set(cfg_mod.to_dict(mc))
    assert not set(cfg_mod.SWIN_FIELDS) & set(cfg_mod.to_dict(
        cfg_mod.TrainConfig(model=mc))["model"])


@pytest.mark.parametrize("cli", ["infer", "infer_volume", "serve",
                                 "export_serving", "train"])
def test_clis_default_to_the_published_widths(cli):
    mod = importlib.import_module(f"mri_superresolution_torch.cli.{cli}")
    need = {"infer": ["--input", "a", "--output", "b"],
            "infer_volume": ["--input", "a", "--output", "b"],
            "serve": [], "export_serving": ["--out", "a"],
            "train": ["--full_res_dir", "a", "--low_res_dir", "b"]}[cli]
    sw = mod.parse_args(need + ["--model_type", "swinir"])
    unet = mod.parse_args(need)
    assert sw.base_filters == 180 and unet.base_filters in (32, 64)
    if cli == "train":
        assert (sw.num_blocks, unet.num_blocks) == (6, 8)


def test_widths_read_from_a_state_dict():
    assert swinir_widths(_params()) == {
        "in_channels": 1, "out_channels": 1, "base_filters": 24,
        "num_blocks": 2, "swin_depth": 2, "swin_heads": 3, "window_size": 4,
        "mlp_ratio": 2.0, "num_feat": 16}


def test_checkpoints_load_and_serve(tmp_path):
    """The port's .ckpt round trip, and a published-style .pth (``params``
    with the two buffers a block) served through ``load_engine``, which
    reads every width from the shapes."""
    from mri_superresolution_torch.config import InferConfig
    p = _params()
    base = str(tmp_path / "final_model_swinir")
    ckpt.save_checkpoint(base, p, meta={"config": {"model": {
        "model_type": "swinir"}}})
    got, _ = ckpt.load_params_any(base + ".ckpt", "swinir")
    assert set(got) == set(p)
    for k in p:
        assert torch.equal(got[k], p[k]), k
    published = dict(p)
    for i in range(2):
        for j in range(2):
            pre = f"layers.{i}.residual_group.blocks.{j}.attn"
            published[f"{pre}.relative_position_index"] = \
                ref.relative_position_index(4)
            published[f"layers.{i}.residual_group.blocks.{j}.attn_mask"] = \
                ref.calculate_mask(16, 16, 4, 2) if j % 2 else \
                torch.zeros(1)
    pth = tmp_path / "pub"
    pth.mkdir()
    torch.save({"params": published}, pth / "best_model_swinir.pth")
    eng = load_engine(InferConfig(model=ModelConfig(model_type="swinir"),
                                  checkpoint_dir=str(pth), bf16=False),
                      device="cpu")
    assert (eng.model_cfg.base_filters, eng.model_cfg.window_size) == (24, 4)
    x = _x((2, 16, 16))
    y = eng.upscale_batch(x.numpy())
    with torch.no_grad():
        want = ref.forward(p, x[..., None], REF_CFG)[..., 0].clamp(0, 1)
    np.testing.assert_allclose(y, want.numpy(), atol=1e-4)


def test_training_resumes_at_the_checkpoints_widths(tmp_path):
    """The tiny model trained one epoch, then resumed from a config that
    names only its family, embed and groups (the train CLI's): the Swin
    widths come from the checkpoint's weights, and the run goes on."""
    from mri_superresolution_torch import native
    from mri_superresolution_torch.config import TrainConfig
    from mri_superresolution_torch.train import trainer
    from mri_superresolution_torch.utils.phantom import phantom_batch
    hr = phantom_batch(np.random.default_rng(1), 8, 32)
    lr = phantom_batch(np.random.default_rng(1), 8, 16)
    for sub, imgs in (("hr", hr), ("lr", lr)):
        (tmp_path / sub).mkdir()
        for i, img in enumerate(imgs):
            native.imwrite_gray(str(tmp_path / sub / f"sub-{i // 2:02d}_T1w_"
                                    f"s{i:03d}.png"),
                                np.round(img * 255).astype(np.uint8))

    def cfg(model, epochs, resume):
        return TrainConfig(
            full_res_dir=str(tmp_path / "hr"), low_res_dir=str(tmp_path / "lr"),
            model=model, batch_size=4, epochs=epochs, seed=3, bf16=False,
            checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "log"),
            resume=resume)

    trainer.train(cfg(TINY, 1, False), device="cpu")
    first = ckpt.load_checkpoint(str(tmp_path / "ck" /
                                     "final_model_swinir.ckpt"))
    assert first[2]["step"] > 0
    assert not set(cfg_mod.SWIN_FIELDS) & set(first[2]["config"]["model"])
    named = ModelConfig(model_type="swinir", base_filters=24, num_blocks=2)
    trainer.train(cfg(named, 2, True), device="cpu")
    second = ckpt.load_checkpoint(str(tmp_path / "ck" /
                                      "final_model_swinir.ckpt"))
    assert second[2]["step"] > first[2]["step"]
    assert swinir_widths(second[0]) == swinir_widths(first[0])
