"""The frozen reference against the port on the CPU, at a small size: the
forwards, the serving normalize and packing, SSIM and training steps."""

import numpy as np
import pytest
import torch

from benchmark import core, reference, systems, traffic, weights

MAN = core.manifest()


def _setup(name, **over):
    cfg, ref = core.config(MAN, name)
    cfg.update(over)
    return cfg, ref, weights.make(ref.param_spec(cfg), 99, "cpu")


def _port_model(cfg, params, dtype=torch.float32):
    from mri_superresolution_torch.models import build_model
    m = build_model(systems._model_config(cfg), dtype=dtype)
    m.load_state_dict(params, strict=True)
    return m


@pytest.mark.parametrize("name, over", [
    ("unet-parity-b32", {"base_filters": 16}),
    ("edsr-baseline-x2", {"base_filters": 16, "num_blocks": 3}),
])
def test_forward_matches_port_fp32(name, over):
    cfg, ref, p = _setup(name, **over)
    x = traffic.phantoms(5, 0, 3, 24, 32, "cpu")[..., None]
    with torch.no_grad():
        want = ref.forward(p, x)
        got = _port_model(cfg, p)(x)
    assert got.shape == want.shape == (3, 48, 64, 1)
    assert float((got - want).abs().max()) < 1e-4


def test_normalize_matches_port():
    from mri_superresolution_torch.ops.normalize import normalize_slices
    raw = torch.from_numpy(traffic.stored_int16(3, 0, 4, 40, 48, 1000.0,
                                                8.0, "cpu")).float()
    assert float((reference.normalize(raw) - normalize_slices(raw)
                  ).abs().max()) < 1e-5


def test_ssim_matches_port():
    from mri_superresolution_torch.ops.ssim import ssim
    a = traffic.phantoms(1, 0, 3, 40, 40, "cpu")
    b = (a + 0.05 * torch.randn(a.shape, generator=torch.Generator()
                                .manual_seed(0))).clamp(0, 1)
    want = ssim(a[..., None], b[..., None], size_average=False)
    assert float((reference.ssim_per_image(a, b) - want).abs().max()) < 1e-5


def test_serve_raw_int16_matches_port_engine():
    from mri_superresolution_torch.infer import InferenceEngine
    cfg, ref, p = _setup("unet-parity-b32", base_filters=16)
    raw = traffic.stored_int16(4, 0, 3, 32, 40, 1000.0, 8.0, "cpu")
    eng = InferenceEngine(systems._model_config(cfg), p, bf16=False,
                          out_dtype=np.int16, device="cpu",
                          normalize_inputs=True, transpose_io=True)
    got = torch.from_numpy(eng.upscale_batch(raw))
    with torch.no_grad():
        want = reference.serve_raw_int16(lambda x: ref.forward(p, x),
                                         torch.from_numpy(raw))
    assert got.shape == want.shape == (3, 80, 64)
    assert int((got.int() - want.int()).abs().max()) <= 1


def test_train_steps_match_port_fp32():
    from mri_superresolution_torch.config import LossConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.train import trainer
    cfg, ref, p = _setup("unet-parity-b32", base_filters=16)
    hr = traffic.phantoms(6, 0, 8, 32, 32, "cpu")
    lo = traffic.degrade(hr, 6, 0, 0.5, 5.0)
    batches = [(lo[:4, ..., None], hr[:4, ..., None]),
               (lo[4:, ..., None], hr[4:, ..., None])]
    losses, g1, p2 = reference.train_steps(
        ref.forward, p, batches, systems.LEARNING_RATE,
        systems.WEIGHT_DECAY, systems.SSIM_WEIGHT)
    model = _port_model(cfg, p)
    state = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), systems.LEARNING_RATE, systems.WEIGHT_DECAY))
    step = trainer.build_train_step(CombinedLoss(LossConfig()))
    got = [float(step(state, {"lr": a, "hr": b,
                              "weight": torch.ones(4)},
                      systems.LEARNING_RATE)["loss"]) for a, b in batches]
    assert got == pytest.approx(losses, rel=1e-5)
    # Adam moves a weight by about the learning rate a step whatever its
    # gradient's size; a tenth of a step is far above fp32 rounding
    for k, v in model.named_parameters():
        assert float((v.detach() - p2[k]).abs().max()) < 1e-5, k


def test_resumed_step_matches_port_fp32():
    """The window's checked step: the reference resumes from a copy of
    the port's params and Adam state and takes the same step."""
    cfg, ref, p = _setup("unet-parity-b32", base_filters=16)
    hr = traffic.phantoms(7, 0, 12, 32, 32, "cpu")
    lo = traffic.degrade(hr, 7, 0, 0.5, 5.0)
    batches = [{"lr": lo[i:i + 4, ..., None], "hr": hr[i:i + 4, ..., None],
                "weight": torch.ones(4)} for i in (0, 4, 8)]
    step = systems.ProgramTrainer(cfg, p, "cpu", dtype=torch.float32)
    for b in batches[:2]:
        step(b)
    before = step.snapshot()
    loss = float(step(batches[2]))
    after = step.snapshot()
    assert int(before["step"]) == 2 and int(after["step"]) == 3
    (want,), g, p1 = reference.train_steps(
        ref.forward, before["params"], [(batches[2]["lr"],
                                         batches[2]["hr"])],
        systems.LEARNING_RATE, systems.WEIGHT_DECAY, systems.SSIM_WEIGHT,
        state=before)
    assert loss == pytest.approx(want, rel=1e-5)
    b1 = reference.ADAM_BETAS[0]
    moving = reference.moving_leaves(g)
    got_g = {k: (after["exp_avg"][k] - b1 * before["exp_avg"][k]) / (1 - b1)
             for k in g}
    assert max(reference.leaf_diffs(got_g, g, moving).values()) < 1e-3
    for k, v in after["params"].items():
        assert float((v - p1[k]).abs().max()) < 1e-5, k


def test_leaf_diffs_see_what_leaf_gaps_do_not():
    want = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0])}
    got = {"a": torch.tensor([4.0, 3.0]), "b": torch.tensor([1.0, 0.0])}
    assert reference.leaf_gaps(got, want, ["a", "b"])["a"] == 0.0
    # ‖(1, -1)‖ over ‖want_a‖ = 5
    assert reference.leaf_diffs(got, want, ["a", "b"])["a"] == \
        pytest.approx(2 ** 0.5 / 5)
