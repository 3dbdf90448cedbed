"""The port's paired-slice extraction (``data/extraction.py``,
``cli/extract.py``) against the JAX package's on the CPU: the name
helpers, ``find_nifti_files``, ``hr_pipeline`` and ``lr_pipeline`` (at
noise 0 and with JAX's draws carried across), ``extract_slices_3d`` and
``extract_from_nifti`` on 3D and 4D volumes with both packages writing PNGs
into ``tmp_path``, and the extract CLI's messages and exit codes. Also the
unet's gradient on a constant LR image in both packages, and the train
step's weight 0 for an all-zero one (an empty slice's black pair) in the
families with GroupNorm."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import nifti as jnifti
from mri_superresolution_tpu.data import extraction as jx
from mri_superresolution_torch import native, nifti
from mri_superresolution_torch.cli import extract as extract_cli
from mri_superresolution_torch.data import extraction as tx

torch.set_num_threads(2)


def _volume(shape=(90, 70, 30), seed=0):
    """A seeded float (H, W, D) volume of smooth blobs and noise, values
    up to ~900, non-square in-plane so that the letterbox pads."""
    rng = np.random.default_rng(seed)
    h, w, d = shape
    yy, xx, zz = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                             np.linspace(-1, 1, d), indexing="ij")
    vol = np.zeros(shape)
    for _ in range(4):
        c = rng.uniform(-0.5, 0.5, 3)
        r = rng.uniform(0.3, 0.7, 3)
        vol += rng.uniform(200, 600) * (((yy - c[0]) / r[0]) ** 2 + (
            (xx - c[1]) / r[1]) ** 2 + ((zz - c[2]) / r[2]) ** 2 < 1)
    return vol + rng.random(shape) * 40.0


def _jax_draws(key, shape):
    """The normal pair ``jk.simulate_low_field_mri`` draws from ``key``
    (ops/kspace.py:69-71 of the JAX package), as tensors."""
    kr, ki = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.normal(
        k, shape, jnp.float32))) for k in (kr, ki))


def _pngs(folder):
    return {f: native.imread_gray(os.path.join(folder, f))
            for f in sorted(os.listdir(folder))}


def _same_pngs(got_dir, want_dir):
    """The same file names; at least 99.9% of the codes identical and none
    more than 1 apart (an fp32 ulp can flip a truncated code)."""
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert list(got) == list(want) and got
    d = np.concatenate([np.abs(got[f].astype(int) - want[f].astype(int))
                        .ravel() for f in got])
    assert (d == 0).mean() >= 0.999 and d.max() <= 1
    return len(got)


@pytest.mark.parametrize("name", [
    "sub-01_ses-02_T1w.nii.gz", "sub-A1_run-3_FLAIR.nii", "sub-7_bold.nii",
    "plainname.nii.gz", "/x/y/sub-01_acq-fast_DWI.nii.gz", "sub-01_T2w"])
def test_bids_identifier_matches_jax(name):
    assert tx.generate_bids_identifier(name) == \
        jx.generate_bids_identifier(name)


@pytest.mark.parametrize("args", [("sub-01_T1w", 7, None),
                                  ("sub-01_T1w", 123, 4), ("x", 0, 0)])
def test_filename_matches_jax(args):
    assert tx.generate_filename(*args) == jx.generate_filename(*args)


@pytest.mark.parametrize("num,lo,hi,n", [(160, 0.2, 0.8, 25), (40, 0.2, 0.8, 10),
                                         (30, 0.0, 1.0, 7), (5, 0.5, 1.0, 9)])
def test_slice_indices_match_jax(num, lo, hi, n):
    got = tx.select_slice_indices(num, lo, hi, n)
    np.testing.assert_array_equal(got, jx.select_slice_indices(num, lo, hi,
                                                               n))
    assert got.max() < num          # the clamp at upper_percent 1.0


def test_find_nifti_files_walks_subjects_in_sorted_order(tmp_path):
    """A set of many subject folders is listed in sorted order whatever
    order the filesystem lists them in, so that each file's noise seed
    (its index) is the same on every machine; the JAX package lists the
    same files in the filesystem's walk order."""
    for i in (3, 0, 7, 1, 5, 2, 6, 4, 10, 9, 8, 11):
        d = tmp_path / "set1" / f"sub-{i:02d}" / "anat"
        d.mkdir(parents=True)
        nifti.save(str(d / f"sub-{i:02d}_T1w.nii"), np.zeros((4, 4, 2),
                                                          np.float32))
    got = tx.find_nifti_files(str(tmp_path))
    assert got == sorted(got) and len(got) == 12
    walk = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "set1")
            for f in sorted(fs)]
    assert jx.find_nifti_files(str(tmp_path)) == walk
    assert sorted(walk) == got


def test_find_nifti_files_matches_jax(tmp_path):
    for rel in ("set1/sub-01/anat/a.nii.gz", "set1/sub-01/anat/b.nii",
                "set1/sub-01/func/c.nii.gz", "set2/sub-02/ANAT/d.nii",
                "set2/sub-02/anat/e.txt", "loose.nii"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    for anat_only in (True, False):
        got = tx.find_nifti_files(str(tmp_path), anat_only)
        assert got == jx.find_nifti_files(str(tmp_path), anat_only) and got
    assert tx.find_nifti_files(str(tmp_path / "missing")) == []


def test_sub_seed_is_stable_and_distinct():
    seeds = {tx.sub_seed(s, i) for s in (0, 1, -5, 2 ** 40) for i in range(4)}
    assert len(seeds) == 16 and all(0 <= s < 2 ** 63 for s in seeds)
    assert tx.sub_seed(3, 2) == tx.sub_seed(3, 2)


@pytest.mark.parametrize("in_hw,target", [((90, 70), (64, 64)),
                                          ((192, 256), (256, 256)),
                                          ((61, 77), (48, 40))])
def test_hr_pipeline_matches_jax(in_hw, target):
    """rtol 1e-5, atol 1e-5 on [0, 1] values."""
    x = (np.random.default_rng(1).random((4, *in_hw)) * 800).astype(
        np.float32)
    x[1] = 5.0                                   # a constant slice
    want = np.asarray(jx.hr_pipeline(jnp.asarray(x), target))
    got = tx.hr_pipeline(torch.from_numpy(x), target).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_hw,target", [((90, 70), (64, 64)),
                                          ((192, 256), (128, 128))])
@pytest.mark.parametrize("noise_std,crop", [(0.0, 0.5), (5.0, 0.5),
                                            (12.0, 0.3)])
def test_lr_pipeline_matches_jax(in_hw, target, noise_std, crop):
    """At noise 0 (no draws) and with JAX's draws carried across as numpy:
    rtol 1e-5, atol 1e-5 on [0, 1] values."""
    x = (np.random.default_rng(2).random((3, *in_hw)) * 800).astype(
        np.float32)
    key = jax.random.key(4)
    want = np.asarray(jx.lr_pipeline(jnp.asarray(x), key, target, crop,
                                     noise_std))
    noise = _jax_draws(key, x.shape) if noise_std else None
    got = tx.lr_pipeline(torch.from_numpy(x), noise, target, crop,
                         noise_std).numpy()
    assert got.shape == (3, target[1] // 2, target[0] // 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_to_uint8_matches_jax():
    x = np.random.default_rng(3).random((5, 7)).astype(np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(tx.to_uint8(x), jx.to_uint8(x))


def test_extract_slices_3d_matches_jax(tmp_path):
    """Both packages write a float volume's pairs at noise 0; the port
    again from the volume stored as int16 with scl_slope (``hdr``), which
    scales only the picked slices: the same PNGs."""
    vol = _volume()
    dirs = {k: tmp_path / k for k in ("jhr", "jlr", "thr", "tlr", "shr",
                                      "slr")}
    for d in dirs.values():
        d.mkdir()
    kw = dict(n_slices=6, target_size=(64, 48), noise_std=0.0,
              verbose=False)
    want = jx.extract_slices_3d(vol, "sub-01_T1w", str(dirs["jhr"]),
                                str(dirs["jlr"]), **kw)
    got = tx.extract_slices_3d(vol, "sub-01_T1w", str(dirs["thr"]),
                               str(dirs["tlr"]), device="cpu", **kw)
    assert got == want and len(got) == 6
    assert _same_pngs(dirs["thr"], dirs["jhr"]) == 6
    assert _same_pngs(dirs["tlr"], dirs["jlr"]) == 6
    stored = np.round(vol * 8).astype(np.int16)
    hdr = nifti.NiftiHeader(scl_slope=0.125, scl_inter=3.0)
    times = tx.StageTimes()
    tx.extract_slices_3d(stored, "sub-01_T1w", str(dirs["shr"]),
                         str(dirs["slr"]), hdr=hdr, device="cpu",
                         times=times, **kw)
    scaled = stored.astype(np.float64) * 0.125 + 3.0
    tx.extract_slices_3d(scaled, "sub-01_T1w", str(dirs["thr"]),
                         str(dirs["tlr"]), device="cpu", **kw)
    for k in ("hr", "lr"):
        assert _pngs(dirs["s" + k]).keys() == _pngs(dirs["t" + k]).keys()
        for f, img in _pngs(dirs["s" + k]).items():
            np.testing.assert_array_equal(img, _pngs(dirs["t" + k])[f])
    assert times.slices == 6 and set(times.ms) == set(tx.STAGES)
    assert all(v >= 0 for v in times.ms.values())


@pytest.mark.parametrize("ndim", [3, 4])
def test_extract_from_nifti_matches_jax(tmp_path, ndim):
    """A NIfTI file (int16 with scl_slope, 3D, or 4D with 2 timepoints)
    through both packages at noise 0: the same names, codes within the
    PNG gate; with noise, one seed gives the same files twice and the HR
    files of noise 0."""
    vol = np.round(_volume((61, 77, 20), seed=ndim) * 4).astype(np.int16)
    if ndim == 4:
        vol = np.stack([vol, vol[::-1]], axis=3)
    path = str(tmp_path / "sub-03_ses-1_T2w.nii.gz")
    jnifti.save(path, vol, scl_slope=0.25)
    kw = dict(n_slices=4, target_size=(48, 48), noise_std=0.0,
              verbose=False)
    out = {k: tmp_path / k for k in ("jhr", "jlr", "thr", "tlr", "n1h",
                                     "n1l", "n2h", "n2l")}
    for d in out.values():
        d.mkdir()
    want = jx.extract_from_nifti(path, str(out["jhr"]), str(out["jlr"]),
                                 **kw)
    got = tx.extract_from_nifti(path, str(out["thr"]), str(out["tlr"]),
                                device="cpu", **kw)
    assert got == want and len(got) == 4 * (ndim - 2)
    _same_pngs(out["thr"], out["jhr"])
    _same_pngs(out["tlr"], out["jlr"])
    kw["noise_std"] = 5.0
    for h, lo in (("n1h", "n1l"), ("n2h", "n2l")):
        tx.extract_from_nifti(path, str(out[h]), str(out[lo]), seed=9,
                              device="cpu", **kw)
    assert _pngs(out["n1l"]).keys() == _pngs(out["n2l"]).keys()
    for f, img in _pngs(out["n1l"]).items():
        np.testing.assert_array_equal(img, _pngs(out["n2l"])[f])
    for f, img in _pngs(out["n1h"]).items():
        np.testing.assert_array_equal(img, _pngs(out["thr"])[f])


def test_cli_extracts_reports_and_counts_failures(tmp_path, capsys):
    """``cli.extract --cpu``: the "No NIfTI files found" message (status
    0, as the JAX CLI); then a corrupt file beside a good one: "Error
    processing" for it, the good one extracted, status 1; the stages'
    milliseconds only with ``--stage_times``."""
    base = ["--hr_output_dir", str(tmp_path / "hr"), "--lr_output_dir",
            str(tmp_path / "lr"), "--n_slices", "3", "--target_size", "32",
            "32", "--cpu"]
    assert extract_cli.main(["--datasets_dir", str(tmp_path / "none"),
                             *base]) == 0
    assert "No NIfTI files found" in capsys.readouterr().out
    for sub in ("sub-01", "sub-02"):
        (tmp_path / "data" / "set1" / sub / "anat").mkdir(parents=True)
    nifti.save(str(tmp_path / "data/set1/sub-01/anat/sub-01_T1w.nii.gz"),
               _volume((40, 36, 12)).astype(np.float32))
    bad = tmp_path / "data/set1/sub-02/anat/sub-02_T1w.nii"
    bad.write_bytes(b"not a nifti file" * 40)
    rc = extract_cli.main(["--datasets_dir", str(tmp_path / "data"), *base])
    out = capsys.readouterr().out
    assert rc == 1
    assert f"Error processing {bad}:" in out
    assert "Extracted 3 slice pairs from 1/2 files" in out
    assert "ms by stage" not in out
    assert len(os.listdir(tmp_path / "hr")) == 3 == len(
        os.listdir(tmp_path / "lr"))
    assert extract_cli.main(["--datasets_dir", str(tmp_path / "data"),
                             *base, "--stage_times"]) == 1
    assert "; ms by stage: read " in capsys.readouterr().out


def _constant_pair_batch(fill: float):
    """Phantoms of LR 16² -> HR 32², batch 4, the second pair constant at
    ``fill`` (0.0: an empty slice's black pair), NHWC float32."""
    from mri_superresolution_torch.utils.phantom import phantom_batch
    lr = phantom_batch(np.random.default_rng(2), 4, 16)
    hr = phantom_batch(np.random.default_rng(2), 4, 32)
    lr[1], hr[1] = fill, fill
    return lr[..., None], hr[..., None]


@pytest.mark.parametrize("fill,finite", [(0.0, False), (0.5, True)])
def test_constant_lr_pair_gradient_is_finite_in_both_packages_unless_zero(
        fill, finite):
    """The unet (base filters 16, JAX's initial weights in both packages)
    on a batch whose second pair is constant, every weight 1, fp32: the
    losses agree (rtol 1e-5), and the gradient is finite in JAX's
    ``jax.grad`` exactly where it is in the port. An all-zero pair makes
    both non-finite, so the weight 0 that the port's train step gives it
    repairs a fault of both packages; a non-zero constant trains in both."""
    from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
    from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
    from mri_superresolution_tpu.models import UNetSuperRes, init_params
    from mri_superresolution_torch.config import LossConfig, ModelConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.models import build_model
    from mri_superresolution_torch.train import trainer
    from mri_superresolution_torch.utils.weights import state_dict_from_jax
    lr, hr = _constant_pair_batch(fill)
    w = np.ones(4, np.float32)
    model = UNetSuperRes(base_filters=16, initial_alpha=25.0)
    params = init_params(model, jax.random.key(0), (16, 16))
    jl = JaxLoss(JaxLossConfig())
    (jloss, _), jg = jax.value_and_grad(lambda p: jl(
        model.apply({"params": p}, lr), hr, w), has_aux=True)(params)
    m = build_model(ModelConfig(base_filters=16, initial_alpha=25.0))
    m.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    loss, _, grads = trainer.loss_and_grads(
        m, CombinedLoss(LossConfig()), torch.from_numpy(hr),
        torch.from_numpy(lr), torch.from_numpy(w))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert all(bool(np.isfinite(np.asarray(g)).all())
               for g in jax.tree_util.tree_leaves(jg)) is finite
    assert all(bool(torch.isfinite(g).all()) for g in grads) is finite


@pytest.mark.parametrize("family,fill,want", [
    ("unet", 0.0, [1.0, 0.0, 1.0, 1.0]),
    ("unet", 0.5, [1.0, 1.0, 1.0, 1.0]),
    ("unet_tpu", 0.0, [1.0, 0.0, 1.0, 1.0]),
    ("edsr", 0.0, [1.0, 1.0, 1.0, 1.0]),
    ("simple", 0.0, [1.0, 1.0, 1.0, 1.0])])
def test_train_step_weighs_all_zero_lr_pair_zero_only_in_the_unets(
        family, fill, want):
    """``trainer.informative`` gives weight 0 to an all-zero LR image in
    the families with GroupNorm and to nothing else, and the train step
    with every weight 1 equals the step with those weights set by hand,
    every parameter finite."""
    from mri_superresolution_torch.config import LossConfig, ModelConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.models import build_model
    from mri_superresolution_torch.train import trainer
    lr, hr = (torch.from_numpy(a) for a in _constant_pair_batch(fill))
    cfg = ModelConfig(model_type=family, base_filters=16, num_blocks=2)
    params = []
    for w in ([1.0] * 4, want):
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        assert trainer.informative(model, lr).tolist() == want
        state = trainer.TrainState(model, trainer.make_optimizer(
            model.parameters(), 1e-4, 1e-5))
        step = trainer.build_train_step(CombinedLoss(LossConfig()))
        m = step(state, {"lr": lr, "hr": hr, "weight": torch.tensor(w)},
                 1e-4)
        assert torch.isfinite(m["loss"])
        params.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*params):
        assert torch.isfinite(a).all() and torch.equal(a, b)
