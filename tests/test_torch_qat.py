"""Quantization-aware training (``--qat``) in the port, on the CPU, case
for case with the JAX package's tests/test_qat.py (its spatial cases wait
for ROADMAP A14), and against the JAX package: the STE and fake-quant
primitives, the fakequant forward of every family (its output, batch
statistic and foreground flag), its STE gradients, one QAT train step,
the percentile calibration, and QAT checkpoints with their calibration
sidecars read by the other package.

Sizes: base filters 16, 32^2 inputs (16^2 -> 32^2 pairs for the CLI).
Tolerances of the cross-package checks, all fp32 (each is stated where it
is asserted):
- the primitives are elementwise fp32 and agree bit for bit;
- edsr's and simple's fakequant outputs agree to 1e-6;
- the unets' cannot agree elementwise, in either package against itself.
  Their fp32 GroupNorm statistics differ by ~1e-5 relative between the
  packages (the calib forward's amax: 7e-6), which moves a few activations
  across a quantizer's rounding boundary; each flipped code shifts its
  GroupNorm group, which flips more codes at the next site, and through
  20 sites the quantization noise is drawn anew. JAX's own output moves
  by a mean of 1.2e-2 when its weights move by 1e-6 relative. So the
  unets are held to JAX's own spread: the test draws that 1e-6 weight
  noise (seeded), and the port must lie within twice JAX's distance to
  itself (output mean) or within 3e-2 of its cosine (gradients). The
  first two sites' statistics, before the cascade, agree to 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.ops import quant as jquant
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_tpu.train import trainer as jtrain
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import train as cli
from mri_superresolution_torch.config import (InferConfig, LossConfig,
                                              ModelConfig)
from mri_superresolution_torch.infer import load_engine
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.ops.quant import (fake_quant_act,
                                                 fake_quant_kernel, int8_conv,
                                                 quantize_tensor, ste,
                                                 weight_qparams)
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

FAMILIES = ["unet", "unet_tpu", "edsr", "simple"]
N_QAT_SITES = {"unet": 20, "unet_tpu": 20, "edsr": 18, "simple": 2}
FIRST_SITE = {"unet": "inc.conv1", "unet_tpu": "inc.conv1", "edsr": "head",
              "simple": "extract"}


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def _model(model_type, seed=0):
    """A port model of ``model_type`` at base filters 16, seeded."""
    return build_model(ModelConfig(model_type=model_type, base_filters=16),
                       generator=torch.Generator().manual_seed(seed))


def _sd(model_type, seed=0):
    return _model(model_type, seed).state_dict()


_JAX_PARAMS = {}


def _jax_params(model_type):
    """JAX's init of ``model_type`` (numpy leaves), and the port's
    state_dict of the same weights."""
    if model_type not in _JAX_PARAMS:
        m = jax_build_model(JaxModelConfig(model_type=model_type,
                                           base_filters=16),
                            dtype=jnp.float32)
        p = jax.tree_util.tree_map(np.asarray, m.init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 1)))["params"])
        _JAX_PARAMS[model_type] = (m, p, state_dict_from_jax(p, model_type))
    return _JAX_PARAMS[model_type]


def _t(x):
    return torch.from_numpy(np.array(x))


def _nudged(params, seed=1, rel=1e-6):
    """``params`` with seeded relative noise ``rel``: JAX's own spread."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a * (1 + rel * r.standard_normal(a.shape)).astype(
            np.float32), params)


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ------------------------------------------------------------- primitives

def test_ste_forward_is_quantized_gradient_is_identity():
    x = torch.tensor([-1.0, 0.3, 2.0], requires_grad=True)
    y = ste(x, torch.round(x))
    (y ** 2).sum().backward()
    # forward round(x), backward the identity: grad = 2 * round(x)
    np.testing.assert_array_equal(y.detach().numpy(), [-1.0, 0.0, 2.0])
    np.testing.assert_allclose(x.grad.numpy(), [-2.0, 0.0, 4.0], rtol=1e-6)


def test_ste_in_bf16_gives_q_as_jax_does(rng):
    """JAX's ``x + stop_gradient(q - x)`` in bf16, against the port's copy
    of the expression (two bf16 roundings in eager PyTorch): both give q
    exactly on these inputs, x over [-4, 4] and q its fake-quantized value
    (the two operands lie within a factor 2 of each other or q is 0, so
    q - x is exact in bf16)."""
    x = (rng.standard_normal((4, 8, 16, 16)) * 2).astype(np.float32)
    s = (np.abs(x).max(axis=(0, 2, 3)) / 127.0).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q = fake_quant_act(xb, torch.from_numpy(s))
    got = ste(xb, q)
    xj = jnp.asarray(x).astype(jnp.bfloat16).transpose(0, 2, 3, 1)
    qj = jquant.fake_quant_act(xj, jnp.asarray(s))
    want = jax.jit(jquant.ste)(xj, qj)
    np.testing.assert_array_equal(
        np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2),
        got.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), q.float().numpy())


def test_fake_quant_primitives_match_jax_bit_for_bit(rng):
    x = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
    w = rng.normal(size=(12, 8, 3, 3)).astype(np.float32)
    s = (np.abs(x).max(axis=(0, 2, 3)) / 127.0).astype(np.float32)
    s[3] = 1e-30                                  # saturates every code
    got_a = fake_quant_act(_t(x), _t(s)).numpy()
    want_a = np.asarray(jquant.fake_quant_act(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(s)))
    np.testing.assert_array_equal(got_a, want_a.transpose(0, 3, 1, 2))
    w[5] = 0.0                                    # an all-zero Cout
    got_k = fake_quant_kernel(_t(w), _t(s)).numpy()
    want_k = np.asarray(jquant.fake_quant_kernel(
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(s)))
    np.testing.assert_array_equal(got_k, want_k.transpose(3, 2, 0, 1))


def test_fake_quant_site_matches_int8_conv(rng):
    """conv(fake_quant_act(x), fake_quant_kernel(w)) equals the int8
    serving conv (folded scales, s8 x s8 -> s32) up to the order of the
    fp32 sums: QAT trains against the arithmetic int8 serves."""
    x = _t(rng.normal(size=(2, 8, 16, 16)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    k = _t(rng.normal(size=(12, 8, 3, 3)).astype(np.float32))
    s_a = x.abs().amax(dim=(0, 2, 3)) / 127.0
    want = int8_conv(quantize_tensor(x, s_a), *weight_qparams(k, s_a),
                     padding=1, out_dtype=torch.float32)
    got = torch.nn.functional.conv2d(fake_quant_act(x, s_a),
                                     fake_quant_kernel(k, s_a), padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_fake_quant_zero_channel_guard():
    x = torch.zeros((1, 3, 4, 4))
    k = torch.zeros((2, 3, 3, 3))
    s = torch.ones(3)
    assert torch.isfinite(fake_quant_act(x, s)).all()
    assert torch.isfinite(fake_quant_kernel(k, s)).all()


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("model_type", FAMILIES)
def test_fakequant_forward_tracks_int8_forward(model_type, rng):
    """The QAT forward and the int8 forward share the scales, so their
    outputs track: per site they are equal up to summation order (above);
    through the net, one-code rounding flips move them within the PTQ
    noise bound of the JAX test (mean 0.05). The first site's input is the
    image in both, so its batch statistic is the calib forward's."""
    sd = _sd(model_type)
    x = _t(rng.random((2, 32, 32, 1), np.float32))
    amax = qf.calib_amax(sd, x, model_type, torch.float32)
    assert len(amax) == N_QAT_SITES[model_type] and qf.OUT_SITE not in amax
    assert {k: tuple(v.shape) for k, v in amax.items()} == \
        qf.amax_template(sd, model_type)
    scales = qf.scales_from_amax({k: v.numpy() for k, v in amax.items()})
    with torch.no_grad():
        y_int8 = qf.build_int8_forward(sd, scales, model_type,
                                       torch.float32)(sd, x)
        y_fq, batch_amax, any_fg = qf.build_fakequant_forward(
            model_type, torch.float32)(sd, amax, x)
    assert bool(any_fg) and set(batch_amax) == set(amax)
    assert float((y_fq - y_int8).abs().mean()) < 0.05
    first = FIRST_SITE[model_type]
    np.testing.assert_allclose(batch_amax[first].numpy(),
                               amax[first].numpy(), rtol=1e-6)


def test_fakequant_gradients_flow_to_all_conv_kernels(rng):
    model = _model("unet")
    x = _t(rng.random((1, 32, 32, 1), np.float32))
    amax = qf.calib_amax(model.state_dict(), x, "unet", torch.float32)
    y, _, _ = qf.build_fakequant_forward("unet", torch.float32)(
        model.state_dict(keep_vars=True), amax, x)
    ((y - 0.8) ** 2).mean().backward()
    norms = {n: float(p.grad.abs().sum()) for n, p in model.named_parameters()
             if p.dim() == 4}
    assert len(norms) == 21                     # 20 sites and the head
    zero = [n for n, v in norms.items() if v == 0.0]
    assert not zero, f"the STE blocked the gradient at {zero}"


def test_fakequant_foreground_routing(rng):
    """Samples below the foreground rule keep full-precision activations
    and stay out of the statistic; a batch of none records zeros and
    any_fg False; gradients through a mixed batch stay finite; the
    foreground samples' outputs are an all-foreground batch's."""
    model = _model("unet")
    sd = model.state_dict()
    fg = rng.random((3, 32, 32, 1), np.float32)
    blank = rng.random((1, 32, 32, 1)).astype(np.float32) * 0.02
    mixed = _t(np.concatenate([blank, fg]))
    hr = _t(rng.random((4, 64, 64, 1), np.float32))
    amax = qf.calib_amax(sd, _t(fg), "unet", torch.float32)
    fq = qf.build_fakequant_forward("unet", torch.float32)
    with torch.no_grad():
        y_mixed, a_mixed, fg_mixed = fq(sd, amax, mixed)
        y_fg, a_fg, _ = fq(sd, amax, _t(fg))
        _, a_bg, fg_bg = fq(sd, amax, torch.zeros((2, 32, 32, 1)))
    assert bool(fg_mixed) and not bool(fg_bg)
    for k in amax:
        np.testing.assert_allclose(a_mixed[k].numpy(), a_fg[k].numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(a_bg[k].numpy(),
                                      np.zeros_like(amax[k].numpy()))
    np.testing.assert_allclose(y_mixed[1:].numpy(), y_fg.numpy(), rtol=1e-5,
                               atol=1e-6)
    y, _, _ = fq(model.state_dict(keep_vars=True), amax, mixed)
    (y - hr).abs().mean().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def _state(model_type="unet", amax=None, wd=0.0):
    m = _model(model_type)
    return trainer.TrainState(m, trainer.make_optimizer(m.parameters(), 1e-3,
                                                        wd), 0, None, amax)


def _batch(lr, hr):
    return {"hr": _t(hr), "lr": _t(lr),
            "weight": torch.ones(lr.shape[0])}


def test_qat_training_with_blank_slices_stays_finite(rng):
    """Batches with black and near-black slices (volume edges) train
    finitely under QAT; with the port's rule an all-zero LR image weighs 0
    in the unets (``trainer.informative``), which composes with QAT's
    foreground routing."""
    n = 16
    x = rng.random((n, 32, 32, 1), np.float32)
    x[4] = 0.0
    x[5] *= 0.02
    x[8] *= 0.03
    hr = rng.random((n, 64, 64, 1), np.float32)
    st = _state(wd=1e-5)
    st.qat_amax = qf.calib_amax(st.model.state_dict(), _t(x[4:12]), "unet",
                                torch.float32)
    step = trainer.build_train_step(
        CombinedLoss(LossConfig(ssim_weight=0.3)), qat_fwd=qf.
        build_fakequant_forward("unet", torch.float32), qat_decay=0.9)
    for i in range(4):
        sel = slice(4 * i, 4 * i + 4)
        m = step(st, _batch(x[sel], hr[sel]), 1e-3)
        assert np.isfinite(float(m["loss"])), f"step {i} diverged"
    assert all(torch.isfinite(p).all() for p in st.model.parameters())
    assert all(torch.isfinite(a).all() and (a >= 0).all()
               for a in st.qat_amax.values())


def test_qat_train_step_updates_running_amax(rng):
    x = rng.random((4, 32, 32, 1), np.float32)
    hr = rng.random((4, 64, 64, 1), np.float32)
    st = _state()
    sd0 = {k: v.clone() for k, v in st.model.state_dict().items()}
    amax0 = qf.calib_amax(sd0, _t(x), "unet", torch.float32)
    st.qat_amax = dict(amax0)
    fq = qf.build_fakequant_forward("unet", torch.float32)
    step = trainer.build_train_step(CombinedLoss(LossConfig(ssim_weight=0.3)),
                                    qat_fwd=fq, qat_decay=0.9)
    metrics = step(st, _batch(x, hr), 1e-3)
    assert np.isfinite(float(metrics["loss"]))
    # new = 0.9 old + 0.1 batch, the batch statistic the fakequant forward
    # records (quantized activations, not the calib forward's)
    with torch.no_grad():
        _, batch_amax, _ = fq(sd0, amax0, _t(x))
    for k, old in amax0.items():
        want = 0.9 * old.numpy() + 0.1 * batch_amax[k].numpy()
        np.testing.assert_allclose(st.qat_amax[k].numpy(), want, rtol=1e-5)
        assert (st.qat_amax[k] >= 0).all()
    assert max(float((st.model.state_dict()[k] - v).abs().max())
               for k, v in sd0.items()) > 0


def test_qat_grad_accum_equivalence(rng):
    """grad_accum composes with QAT: each microbatch quantizes with the
    step's running amax, and the recombined statistic is the full batch's
    max. The JAX test's invariants: metrics within 1e-3, the amax within
    one code (2e-2), every weight within Adam's first-step cap (2.2 lr)
    and under 15% of the elements past 5e-5 + 2e-3 |w|."""
    x = rng.random((4, 32, 32, 1), np.float32)
    hr = rng.random((4, 64, 64, 1), np.float32)
    amax0 = qf.calib_amax(_sd("unet"), _t(x), "unet", torch.float32)
    fq = qf.build_fakequant_forward("unet", torch.float32)

    def run(accum):
        st = _state(amax=dict(amax0))
        step = trainer.build_train_step(
            CombinedLoss(LossConfig(ssim_weight=0.3)), grad_accum=accum,
            qat_fwd=fq, qat_decay=0.9)
        return st, step(st, _batch(x, hr), 1e-3)

    (s1, m1), (s2, m2) = run(1), run(2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    assert abs(float(m1["ssim"]) - float(m2["ssim"])) < 1e-3
    for k in amax0:
        np.testing.assert_allclose(s1.qat_amax[k].numpy(),
                                   s2.qat_amax[k].numpy(), rtol=2e-2)
    mismatch = total = 0
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        a, b = a.detach().numpy(), b.detach().numpy()
        assert float(np.abs(a - b).max()) <= 2.2e-3
        mismatch += int((np.abs(a - b) > 5e-5 + 2e-3 * np.abs(b)).sum())
        total += a.size
    assert mismatch / total < 0.15, f"{mismatch}/{total} elements differ"


# ------------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """16 phantom pairs (LR 16^2, HR 32^2) of 4 subjects, written by the
    port's PNG encoder."""
    d = tmp_path_factory.mktemp("qat_pngs")
    hr = phantom_batch(np.random.default_rng(1), 16, 32)
    lr = phantom_batch(np.random.default_rng(1), 16, 16)
    for sub in ("hr", "lr"):
        (d / sub).mkdir()
    for i in range(16):
        name = f"sub-{i // 4:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(d / "hr" / name),
                            np.round(hr[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(d / "lr" / name),
                            np.round(lr[i] * 255).astype(np.uint8))
    return d


def _argv(pngs, ckdir, *extra):
    return ["--full_res_dir", str(pngs / "hr"), "--low_res_dir",
            str(pngs / "lr"), "--base_filters", "16", "--batch_size", "4",
            "--seed", "3", "--cpu", "--no_bf16", "--checkpoint_dir",
            str(ckdir), "--log_dir", str(ckdir / "logs"), *extra]


QAT = ("--qat", "--qat_decay", "0.9")


def _sidecar(path):
    return ckpt.calib_sidecar_path(path)


def test_qat_train_end_to_end_sidecar_and_int8_serving(pngs, tmp_path,
                                                       capsys):
    """train --qat writes a checkpoint and a frozen calibration sidecar
    beside best and final; load_engine finds it and serves int8 from the
    first batch, with no calibration forward, the same bytes from two
    engines; an explicit --quant_calib still wins."""
    final = cli.main(_argv(pngs, tmp_path, "--epochs", "2", *QAT))
    assert "QAT enabled" in capsys.readouterr().out
    for base in ("best_model_unet", "final_model_unet"):
        assert os.path.exists(tmp_path / f"{base}.calib.json")
    scales, mtype = qf.load_scales(_sidecar(final))
    assert mtype == "unet" and len(scales) == 20
    assert all(np.all(np.asarray(s) > 0) for s in scales.values())
    icfg = InferConfig(model=ModelConfig(), checkpoint_path=final,
                       quant="int8", bf16=False)
    eng1 = load_engine(icfg, device="cpu")
    assert eng1._quant_fwd is not None and not eng1.quant_calibrating
    batch = np.random.default_rng(0).random((2, 16, 16), np.float32)
    out1 = eng1.upscale_batch(batch)
    assert eng1._quant_batches == {"int8": 1, "bf16": 0}
    np.testing.assert_array_equal(
        out1, load_engine(icfg, device="cpu").upscale_batch(batch))
    other = str(tmp_path / "explicit.json")
    qf.save_scales(other, scales, "unet")
    icfg2 = InferConfig(model=ModelConfig(), checkpoint_path=final,
                        quant="int8", bf16=False, quant_calib_path=other)
    assert load_engine(icfg2, device="cpu")._quant_fwd is not None


def test_qat_resume_restores_running_amax(pngs, tmp_path, capsys):
    """A --qat --resume from a QAT checkpoint restores the running ranges
    from its extras (no re-initialization) and keeps the histories."""
    cli.main(_argv(pngs, tmp_path, "--epochs", "1", *QAT))
    amax1 = ckpt.load_checkpoint(str(tmp_path / "final_model_unet.ckpt"),
                                 return_extras=True)[3]["qat_amax"]
    assert len(amax1) == 20
    capsys.readouterr()
    cli.main(_argv(pngs, tmp_path, "--epochs", "2", "--resume", *QAT))
    out = capsys.readouterr().out
    assert "without QAT state" not in out
    assert "initializing the running activation ranges" not in out
    assert "histories are reset" not in out
    assert os.path.exists(tmp_path / "final_model_unet.calib.json")


def test_qat_finetune_from_bf16_checkpoint(pngs, tmp_path, capsys):
    """The QAT recipe: --qat --resume of a checkpoint trained without QAT
    re-initializes the ranges on the restored weights and resets the
    plateau and early-stopping histories, so that the first QAT
    validation becomes the new best and exports a best sidecar; a later
    save without QAT removes the stale sidecar."""
    cli.main(_argv(pngs, tmp_path, "--epochs", "2"))
    capsys.readouterr()
    cli.main(_argv(pngs, tmp_path, "--epochs", "4", "--resume", *QAT))
    out = capsys.readouterr().out
    assert "histories are reset" in out
    assert "re-initialized from one batch through the RESTORED weights" \
        in out
    assert "initializing the running activation ranges" in out
    for base in ("best_model_unet", "final_model_unet"):
        assert os.path.exists(tmp_path / f"{base}.calib.json")
    cli.main(_argv(pngs, tmp_path, "--epochs", "5", "--resume"))
    assert "Removed stale QAT calibration sidecar" in \
        capsys.readouterr().out
    assert not os.path.exists(tmp_path / "final_model_unet.calib.json")


def test_qat_finetune_sidecar_measures_restored_weights(pngs, tmp_path):
    """A zero-epoch --qat --resume (epochs == start epoch) freezes the
    initial calibration into the sidecar: it must equal a calibration of
    the restored weights over the whole training set (batch 16 = every
    pair, and the max does not depend on the order)."""
    final = cli.main(_argv(pngs, tmp_path, "--epochs", "1",
                           "--validation_split", "0.0",
                           "--batch_size", "16"))
    cli.main(_argv(pngs, tmp_path, "--epochs", "1", "--validation_split",
                   "0.0", "--batch_size", "16", "--resume", *QAT))
    scales, _ = qf.load_scales(_sidecar(final))
    sd, _, _ = ckpt.load_checkpoint(final)
    lrs = np.stack([native.imread_gray(str(pngs / "lr" / f)) for f in
                    sorted(os.listdir(pngs / "lr"))]).astype(np.float32)
    amax = qf.calib_amax(sd, _t(lrs[..., None] / 255.0), "unet",
                         torch.float32)
    want = qf.scales_from_amax({k: v.numpy() for k, v in amax.items()})
    assert set(scales) == set(want)
    for k in want:
        np.testing.assert_allclose(scales[k], want[k], rtol=1e-5,
                                   err_msg=k)


def test_qat_composes_with_ema_and_grad_accum(pngs, tmp_path, capsys):
    """--qat --ema_decay --grad_accum: the checkpoint carries raw_params
    and qat_amax, serves the EMA weights, and its sidecar is measured on
    them (the first train batch of epoch 0, through the served weights);
    a zero-epoch re-save exports the same scales."""
    from mri_superresolution_torch.data import (BatchLoader,
                                                PairedSliceDataset,
                                                train_val_split)

    extra = ("--epochs", "2", "--ema_decay", "0.5", "--grad_accum", "2",
             *QAT)
    final = cli.main(_argv(pngs, tmp_path, *extra))
    capsys.readouterr()
    scales, mtype = qf.load_scales(_sidecar(final))
    assert mtype == "unet" and len(scales) == 20
    served, _, _, extras = ckpt.load_checkpoint(final, return_extras=True)
    assert "raw_params" in extras and len(extras["qat_amax"]) == 20
    ds = PairedSliceDataset(str(pngs / "hr"), str(pngs / "lr"))
    lr_arr, hr_arr = ds.load_all()
    train_idx, _ = train_val_split(len(ds), 0.2, 3)
    fb = next(iter(BatchLoader(lr_arr, hr_arr, train_idx, 4, shuffle=True,
                               seed=3).epoch(0)))
    amax = qf.calib_amax(served, _t(fb["lr"]), "unet", torch.float32)
    want = qf.scales_from_amax({k: v.numpy() for k, v in amax.items()})
    for k in want:
        np.testing.assert_allclose(scales[k], want[k], rtol=1e-5,
                                   err_msg=f"{k}: not the EMA weights'")
    cli.main(_argv(pngs, tmp_path, *extra, "--resume"))
    scales2, _ = qf.load_scales(_sidecar(final))
    for k in want:
        np.testing.assert_allclose(scales2[k], want[k], rtol=1e-5,
                                   err_msg=f"{k}: zero-epoch re-save")


def test_qat_validation_errors(tmp_path):
    d = str(tmp_path)
    cfg = cli.config_from_args(cli.parse_args(
        ["--full_res_dir", d, "--low_res_dir", d, "--cpu", "--qat",
         "--qat_decay", "1.5", "--checkpoint_dir", d]))
    with pytest.raises(ValueError, match="qat_decay"):
        trainer.train(cfg, device="cpu")
    cfg.qat_decay = 0.9
    cfg.model.model_type = "hourglass"
    with pytest.raises(ValueError, match="int8 serving families"):
        trainer.train(cfg, device="cpu")


# ----------------------------------------------------------- against JAX

@pytest.mark.parametrize("model_type", FAMILIES)
def test_fakequant_forward_matches_jax(model_type, rng):
    """Same params, amax and input through JAX's ``build_fakequant_forward``
    and the port's, fp32: any_fg equal and the same sites. edsr and
    simple: y within 1e-6, the batch statistic within rtol 1e-6. The unets
    (the module's note): mean |y - y_jax| at most twice JAX's own under
    1e-6 weight noise; each site's statistic within 10% (JAX's own moves
    up to 3.5%), the first two within 1e-5."""
    _, params, sd = _jax_params(model_type)
    x = rng.random((2, 32, 32, 1), np.float32)
    amax = {k: np.asarray(v) for k, v in jqf.calib_amax(
        params, jnp.asarray(x), model_type, jnp.float32).items()}
    fn = jax.jit(jqf.build_fakequant_forward(model_type, jnp.float32))
    yj, aj, fj = fn(params, amax, jnp.asarray(x))
    with torch.no_grad():
        yt, at, ft = qf.build_fakequant_forward(model_type, torch.float32)(
            sd, {k: _t(v) for k, v in amax.items()}, _t(x))
    assert bool(fj) == bool(ft) is True
    assert set(aj) == set(at) and len(at) == N_QAT_SITES[model_type]
    d = np.abs(np.asarray(yj) - yt.numpy())
    if model_type not in ("unet", "unet_tpu"):
        assert d.max() < 1e-6, d.max()
        for k in aj:
            np.testing.assert_allclose(at[k].numpy(), np.asarray(aj[k]),
                                       rtol=1e-6, err_msg=k)
        return
    own = float(np.abs(np.asarray(fn(_nudged(params), amax,
                                     jnp.asarray(x))[0])
                       - np.asarray(yj)).mean())
    assert d.mean() <= 2 * own, (d.mean(), own)
    for k in aj:
        np.testing.assert_allclose(
            at[k].numpy(), np.asarray(aj[k]), err_msg=k,
            rtol=1e-5 if k in ("inc.conv1", "inc.conv2") else 0.1)


def test_calib_percentile_matches_jax(rng):
    """calib mode with a percentile (``calibrate`` over two batches): at
    the first site, whose input is the image in both packages, JAX's
    ``jnp.percentile`` over the pixels rounded as XLA rounds it (1 ulp,
    rtol 2.4e-7); at the second, whose input is the first conv's fp32
    output (summed in another order), within rtol 1e-4."""
    _, params, sd = _jax_params("simple")
    xs = [rng.random((2, 32, 32, 1), np.float32) for _ in range(2)]
    want = jqf.calibrate(params, xs, "simple", jnp.float32, percentile=99.0)
    got = qf.calibrate(sd, xs, "simple", torch.float32, percentile=99.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   rtol=2.4e-7 if k == "extract" else 1e-4)


def test_fakequant_gradients_match_jax(rng):
    """The unet's STE gradients, ``jax.grad`` against the port's backward
    through the same fakequant forward and loss (mean (y - 0.8)^2): the
    loss within rtol 5e-3 (the output's quantization noise: JAX's own
    moves 5.6e-4 relative under 1e-6 weight noise, the port 1.1e-3);
    every parameter's gradient at a cosine of 0.9 or more to
    JAX's (JAX's own under that noise: 0.95-1.0 a tensor), and their mean
    at most 2e-2 below the mean of JAX's own."""
    _, params, sd = _jax_params("unet")
    x = rng.random((2, 32, 32, 1), np.float32)
    amax = {k: np.asarray(v) for k, v in jqf.calib_amax(
        params, jnp.asarray(x), "unet", jnp.float32).items()}
    fq = jqf.build_fakequant_forward("unet", jnp.float32)

    def loss(p):
        return jnp.mean((fq(p, amax, jnp.asarray(x))[0] - 0.8) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    jl, jg = vg(params)
    own = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, vg(_nudged(params))[1]), "unet")
    m = build_model(ModelConfig(base_filters=16))
    m.load_state_dict(sd)
    y, _, _ = qf.build_fakequant_forward("unet", torch.float32)(
        m.state_dict(keep_vars=True), {k: _t(v) for k, v in amax.items()},
        _t(x))
    tl = ((y - 0.8) ** 2).mean()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=5e-3)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                               "unet")
    cos = {n: _cos(p.grad.numpy(), want[n].numpy())
           for n, p in m.named_parameters()}
    assert min(cos.values()) >= 0.9, cos
    own_mean = np.mean([_cos(own[n].numpy(), want[n].numpy()) for n in cos])
    assert np.mean(list(cos.values())) >= own_mean - 2e-2, (cos, own_mean)


def test_qat_train_step_matches_jax(rng):
    """One QAT train step of each package from the same params, running
    amax and batch (fp32, ssim_weight 0.3, qat_decay 0.9), compared on
    what the step changes.

    - The loss (the forward before the update) within rtol 1e-3.
    - The running amax starts at half the batch's calibration, so that the
      EMA moves it: every site's largest channel by 5% or more in both
      packages (8.9-10% measured), and a step that left it unchanged
      would sit ~9% from JAX's. The updated amax within one code (rtol
      1e-2; 2.5e-3-4.2e-3 measured over five draws of the batch, JAX's
      own under 1e-6 weight noise 3.1e-3-3.9e-3).
    - The weights' update (w1 - w0), not the weights: Adam's first step
      moves each element by about lr whatever its direction, so a step
      with no update or a reversed one stays within 2 lr of JAX's
      weights. Every tensor's update at a cosine of 0.5 or more to JAX's
      (Adam's first step is lr times the gradient's sign, so a tensor of
      8 elements with one sign flipped reads 0.75; 0.625-0.81 at worst
      over five draws, a random direction reads ~0, a reversed one -1
      and a missing one nan), and the whole update's cosine (every tensor
      in one vector) at most 2e-2 below JAX's against itself under 1e-6
      weight noise (0.86-0.92 against JAX's own 0.79-0.84)."""
    model, params, sd = _jax_params("unet")
    x = rng.random((4, 32, 32, 1), np.float32)
    hr = rng.random((4, 64, 64, 1), np.float32)
    amax = {k: 0.5 * np.asarray(v) for k, v in jqf.calib_amax(
        params, jnp.asarray(x), "unet", jnp.float32).items()}
    lcfg = JaxLossConfig(ssim_weight=0.3)
    opt = jtrain.make_optimizer(0.0)
    step = jax.jit(jtrain.build_train_step(
        model, JaxLoss(lcfg), opt, None, lcfg,
        qat_fwd=jqf.build_fakequant_forward("unet", jnp.float32),
        qat_decay=0.9))
    batch = {"hr": hr, "lr": x, "weight": np.ones(4, np.float32)}

    def jax_step(p):
        st = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                               opt_state=opt.init(p), qat_amax=amax)
        return step(st, batch, jnp.asarray(1e-3, jnp.float32),
                    jax.random.key(0))

    jst, jm = jax_step(params)
    nudged = _nudged(params)
    own_st, _ = jax_step(nudged)

    m = build_model(ModelConfig(base_filters=16))
    m.load_state_dict(sd)
    pst = trainer.TrainState(m, trainer.make_optimizer(m.parameters(), 1e-3,
                                                       0.0), 0, None,
                             {k: _t(v) for k, v in amax.items()})
    pm = trainer.build_train_step(
        CombinedLoss(LossConfig(ssim_weight=0.3)),
        qat_fwd=qf.build_fakequant_forward("unet", torch.float32),
        qat_decay=0.9)(pst, _batch(x, hr), 1e-3)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    for k, a0 in amax.items():
        got, want_a = pst.qat_amax[k].numpy(), np.asarray(jst.qat_amax[k])
        for name, a1 in (("port", got), ("jax", want_a)):
            assert np.max(np.abs(a1 - a0) / a0) >= 5e-2, (name, k)
        np.testing.assert_allclose(got, want_a, rtol=1e-2, err_msg=k)

    def update(after, before):
        return [(after[k] - before[k]).numpy() for k in sd]

    w0 = state_dict_from_jax(params, "unet")
    got = update(m.state_dict(), w0)
    want = update(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jst.params), "unet"), w0)
    own = update(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, own_st.params), "unet"),
        state_dict_from_jax(nudged, "unet"))
    cos = {k: _cos(g, w) for k, g, w in zip(sd, got, want)}
    assert min(cos.values()) >= 0.5, cos
    whole, whole_own = (_cos(np.concatenate([np.ravel(u) for u in a]),
                             np.concatenate([np.ravel(u) for u in want]))
                        for a in (got, own))
    assert whole >= whole_own - 2e-2, (whole, whole_own)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_qat_checkpoint_and_sidecar_cross_packages(writer, tmp_path, rng):
    """A QAT checkpoint (params, Adam state, ``qat_amax`` extras, meta with
    ``qat`` true) and its ``.calib.json`` written by one package are read
    by the other: the ranges come back equal, and the sidecar serves int8
    in the reading package with zero calibration forwards."""
    from mri_superresolution_tpu.config import InferConfig as JaxInferConfig
    from mri_superresolution_tpu.infer.engine import (
        load_engine as jax_load_engine)

    _, params, sd = _jax_params("unet")
    amax = {k: np.abs(rng.standard_normal(v.shape)).astype(np.float32) + 0.1
            for k, v in jqf.calib_amax(params, jnp.zeros((1, 32, 32, 1)),
                                       "unet", jnp.float32).items()}
    base = str(tmp_path / "final_model_unet")
    meta = {"config": {"qat": True, "model": {"model_type": "unet",
                                              "base_filters": 16}},
            "epoch": 0, "step": 1}
    if writer == "jax":
        jax_ckpt.save_checkpoint(base, params, meta=meta,
                                 extras={"qat_amax": amax})
        jqf.save_scales(base + ".calib.json", jqf.scales_from_amax(amax),
                        "unet")
        _, _, _, extras = ckpt.load_checkpoint(base + ".ckpt",
                                               return_extras=True)
        got = {k: v.numpy() for k, v in extras["qat_amax"].items()}
    else:
        ckpt.save_checkpoint(base, sd, meta=meta, model_type="unet",
                             extras={"qat_amax": {k: _t(v) for k, v in
                                                  amax.items()}})
        qf.save_scales(base + ".calib.json", qf.scales_from_amax(amax),
                       "unet")
        _, _, _, extras = jax_ckpt.load_checkpoint(base + ".ckpt",
                                                   return_extras=True)
        got = {k: np.asarray(v) for k, v in extras["qat_amax"].items()}
        with open(base + ".calib.json") as f:
            assert json.load(f)["format"] == "int8-ptq-scales-v1"
    assert set(got) == set(amax)
    for k in amax:
        np.testing.assert_array_equal(got[k], amax[k])
    batch = rng.random((2, 16, 16), np.float32)
    if writer == "jax":
        eng = load_engine(InferConfig(checkpoint_path=base + ".ckpt",
                                      quant="int8", bf16=False),
                          device="cpu")
    else:
        eng = jax_load_engine(JaxInferConfig(checkpoint_path=base + ".ckpt",
                                             quant="int8", bf16=False))
    assert eng._quant_fwd is not None
    out = eng.upscale_batch(batch)
    assert out.shape == (2, 32, 32) and np.isfinite(out).all()
    assert eng._quant_batches == {"int8": 1, "bf16": 0}


def test_jax_trainer_resumes_a_port_qat_run(pngs, tmp_path, capsys):
    """A --qat run of the port's CLI resumes in the JAX trainer with --qat:
    the ranges come from the port's extras (no re-initialization)."""
    from mri_superresolution_tpu.config import train_config_from_dict

    cli.main(_argv(pngs, tmp_path, "--epochs", "1", *QAT))
    meta = ckpt.read_meta(str(tmp_path / "final_model_unet.ckpt"))
    cfg = train_config_from_dict(meta["config"])
    cfg.epochs, cfg.resume = 2, True
    capsys.readouterr()
    jtrain.train(cfg)
    out = capsys.readouterr().out
    assert "Resumed from" in out and "without QAT state" not in out
    assert len(jax_ckpt.load_checkpoint(
        str(tmp_path / "final_model_unet.ckpt"),
        return_extras=True)[3]["qat_amax"]) == 20
