"""The port's TTA and ablation harness against the JAX package's, on the
CPU.

- TTA's clean pass (one view, no augmentation) on the same JAX-written
  checkpoint (``tiny_rgb`` at 32², ``tiny_fusion`` at 64²): probabilities
  within 1e-5, predictions and metrics equal.
- TTA's augmented pass: JAX's PRNG stream cannot be reproduced, so
  inverse-affine matrices are drawn once and fed to the port's warp (in
  place of its own draw) and to the JAX package's ``affine_warp`` oracle,
  then to both models: each view's probability within 1e-5, and the
  port's aggregation equal to a numpy statement of it.
- The same seed gives the same TTA result, another seed another draw.
- The TTA CLI writes ``tta_results.pt`` with the JAX keys.
- The ablation's ``TrainConfig`` equals the JAX CLI's for the same argv
  (``--weight-decay 0`` kept), and a one-epoch run of the port's CLI
  returns the JAX result keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.cli import ablation_study as jax_ablation
from dfu_multimodal_tpu.data import transforms as jax_transforms
from dfu_multimodal_tpu.data.loader import load_paired as jax_load_paired
from dfu_multimodal_tpu.eval import tta as jax_tta
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.cli import ablation_study as port_ablation
from dfu_multimodal_tpu_torch.cli import test_time_augmentation as port_tta_cli
from dfu_multimodal_tpu_torch.data import transforms as port_transforms
from dfu_multimodal_tpu_torch.data.loader import load_paired
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.eval import tta as port_tta
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils.artifacts import load_pt

torch.set_num_threads(1)
PROB_TOL = 1e-5
NUM_TTA = 3
CASES = {"tiny_rgb": ("checkpoints_rgb_only", 32),
         "tiny_fusion": ("checkpoints_multimodal", 64)}


def _mods(mod):
    return {"rgb": mod.rgb_modality(), "thermal": mod.thermal_modality()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per model: a tree at its size, a JAX checkpoint, the JAX trainer and
    restored state, the port trainer restored from the same files, and
    the test split (aligned pairs, as the TTA CLI loads it)."""
    root = tmp_path_factory.mktemp("tta")
    out = {}
    for k, (name, (ckpt, size)) in enumerate(CASES.items()):
        data = root / f"data{size}"
        counts = {m: {"train": (2, 2), "val": (1, 1), "test": (5, 6)}
                  for m in ("rgb", "thermal")}
        make_synthetic_dataset(data, size=size, counts=counts)
        jcfg = jax_config.TrainConfig(batch_size=8, eval_batch_size=8,
                                      compute_dtype="float32",
                                      mesh=jax_config.MeshConfig(data=1))
        jt = JaxTrainer(name, jcfg, _mods(jax_config))
        state = jt.init_state(jax.random.PRNGKey(20 + k), image_size=size)
        logs = root / f"logs{size}"
        jax_ckpt.save_checkpoint(logs / ckpt, epoch=1,
                                 model_state=jt.variables(state),
                                 opt_state=state.opt_state, val_f1=0.5,
                                 history={}, extra_meta={"model": name})
        state = jt.restore(logs / ckpt, image_size=size)
        pt = Trainer(name, port_config.TrainConfig(
            batch_size=8, eval_batch_size=8, compute_dtype="float32"),
            _mods(port_config), device="cpu", image_size=size)
        pt.restore(logs / ckpt)
        ds = load_paired(data, "test", size, strategy="aligned")
        jds = jax_load_paired(data, "test", size, strategy="aligned")
        np.testing.assert_array_equal(ds.arrays["rgb"], jds.arrays["rgb"])
        out[name] = (data, logs, jt, state, pt, ds, jds)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_clean_pass_matches_jax(name, setup):
    _, _, jt, state, pt, ds, jds = setup[name]
    ref = jax_tta.evaluate_with_tta(jt, state, jds, num_tta=1,
                                    use_augmentation=False, seed=0)
    ours = port_tta.evaluate_with_tta(pt, ds, num_tta=1,
                                      use_augmentation=False, seed=0)
    assert set(ours) == set(ref)
    np.testing.assert_allclose(ours["probabilities"], ref["probabilities"],
                               rtol=0, atol=PROB_TOL)
    for key in ("predictions", "labels", "confusion_matrix"):
        np.testing.assert_array_equal(ours[key], ref[key])
    for key in ("accuracy", "f1", "sensitivity", "specificity", "auc"):
        assert ours[key] == pytest.approx(ref[key], abs=1e-12), key


@pytest.mark.parametrize("name", list(CASES))
def test_augmented_pass_matches_jax_through_the_same_matrices(
        name, setup, monkeypatch):
    _, _, jt, state, pt, ds, _ = setup[name]
    inputs = pt.spec.inputs
    b, size = 4, ds.arrays["rgb"].shape[1]
    batch = {m: torch.from_numpy(ds.arrays[m][:b]) for m in inputs}
    cfg = port_tta.tta_augment_config()
    gen = torch.Generator().manual_seed(5)
    mats = {m: port_transforms.sample_inverse_affine(gen, cfg, size, size,
                                                     b * NUM_TTA)
            for m in inputs}
    assert (mats[inputs[0]][:, 0, 0] < 0).any()      # a flip was drawn
    calls = []

    def injected(gen, cfg, height, width, batch_size):
        calls.append(inputs[len(calls)])
        assert batch_size == b * NUM_TTA
        return mats[calls[-1]]

    monkeypatch.setattr(port_transforms, "sample_inverse_affine", injected)
    probs = port_tta.tta_probs(pt, batch, NUM_TTA, True, seed=0,
                               batch_index=0).numpy()
    assert calls == list(inputs)

    # the JAX side: its gather-warp oracle on the same matrices
    warp = jax.vmap(jax_transforms.affine_warp)
    x = {}
    for m in inputs:
        tiled = np.repeat(ds.arrays[m][:b], NUM_TTA, axis=0)
        warped = warp(jnp.asarray(tiled, jnp.float32),
                      jnp.asarray(mats[m].numpy()))
        mod = _mods(jax_config)[m]
        x[m] = jax_transforms.normalize(warped, mod.mean, mod.std)
    logits = jax_zoo.apply_model(jt.module, jt.spec, jt.variables(state), x,
                                 train=False)
    ref = np.asarray(jax.nn.softmax(logits.astype(jnp.float32), -1)[:, 1])
    np.testing.assert_allclose(probs, ref, rtol=0, atol=PROB_TOL)

    pred, mean = port_tta.aggregate(torch.from_numpy(probs), NUM_TTA)
    views = probs.reshape(b, NUM_TTA)
    np.testing.assert_array_equal(
        pred.numpy(), ((views > 0.5).mean(axis=1) > 0.5).astype(np.int32))
    np.testing.assert_array_equal(mean.numpy(),
                                  views.mean(axis=1, dtype=np.float32))


def test_tta_seed_determinism(setup):
    _, _, _, _, pt, ds, _ = setup["tiny_rgb"]
    run = [port_tta.tta_predictions(pt, ds, NUM_TTA, True, seed=s)[1]
           for s in (7, 7, 8)]
    np.testing.assert_array_equal(run[0], run[1])
    assert not np.array_equal(run[0], run[2])
    gens = [port_tta.tta_generator(7, bi, i, torch.device("cpu"))
            for bi, i in ((0, 0), (0, 1), (1, 0))]
    draws = [torch.rand(4, generator=g) for g in gens]
    assert not any(torch.equal(draws[i], draws[j])
                   for i, j in ((0, 1), (0, 2), (1, 2)))


def test_tta_cli_writes_the_jax_artifact(setup):
    data, logs, *_ = setup["tiny_rgb"]
    res = port_tta_cli.main(["--data-dir", str(data), "--checkpoint-root",
                             str(logs), "--models", "rgb_only",
                             "--image-size", "32", "--compute-dtype",
                             "float32", "--num-tta", str(NUM_TTA),
                             "--device", "cpu"])
    saved = load_pt(logs / "checkpoints_rgb_only" / "tta_results.pt")
    assert set(saved) == {"model", "clean_metrics", "tta_metrics"}
    assert saved["model"] == "RGB-Only"
    assert set(saved["tta_metrics"]) == {
        "accuracy", "f1", "auc", "sensitivity", "specificity",
        "confusion_matrix", "predictions", "probabilities", "labels"}
    np.testing.assert_array_equal(saved["clean_metrics"]["probabilities"],
                                  res["rgb_only"]["clean"]["probabilities"])


# ---------------------------------------------------------------- ablation


@pytest.mark.parametrize("argv", [
    [], ["--weight-decay", "0"],
    ["--epochs", "2", "--lr", "0", "--batch-size", "4", "--seed", "3",
     "--compute-dtype", "float32"]])
def test_ablation_config_matches_jax(argv, setup, monkeypatch):
    data = setup["tiny_rgb"][0]
    seen = []
    monkeypatch.setattr(jax_ablation, "_train_one",
                        lambda *a: seen.append(a[4]) or ({}, 0.5))
    base = ["--data-dir", str(data), "--image-size", "32",
            "--standardized-suffix", ""]
    jax_ablation.main(base + argv)
    ref = dataclasses.asdict(seen[0])
    ours = dataclasses.asdict(port_ablation.ablation_config(
        port_ablation.build_parser().parse_args(base + argv)))
    assert ours.pop("mesh")["data"] == ref.pop("mesh")["data"] == -1
    shared = set(ours) & set(ref)
    assert len(shared) > 20
    assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}
    if "--weight-decay" in argv:
        assert ours["weight_decay"] == 0.0


def test_ablation_one_epoch_returns_the_jax_keys(setup):
    data = setup["tiny_rgb"][0]
    res = port_ablation.main([
        "--data-dir", str(data), "--image-size", "32", "--epochs", "1",
        "--batch-size", "4", "--compute-dtype", "float32", "--device",
        "cpu", "--rgb-model", "tiny_rgb", "--thermal-model", "tiny_thermal",
        "--multimodal-model", "tiny_fusion", "--with-multimodal"])
    assert set(res) == {"rgb_only", "thermal_only", "multimodal"}
    assert all(0.0 <= v <= 1.0 for v in res.values())
