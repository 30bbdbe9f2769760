"""The port's data-parallel, FSDP and tensor-parallel steps on two gloo
ranks on the CPU, against the same step on one rank and against the JAX
package's single-device jit step on the global batch.

One two-rank job (``torch_dist_job.train_job``, spawned once for the
module) runs every mode from the same weights (JAX's, through
``tools/convert_jax.py``) on the same global batch, each beside the
port's one-rank step; the JAX references are computed here, in the
parent, on a 1-device mesh while the ranks run.  The models are the tiny
ones of ``test_torch_train.py`` (ViT: 2 blocks, width 64, 4 heads) and
``test_torch_train_bn.py`` (a one-block-a-stage ResNet), fp32, no
dropout, augmentation neutral (but in ``dp_aug``).

The batch holds 6 rows, the last padding, with class weights: the two
ranks' weight masses differ, so a gradient averaged over the ranks (DDP)
instead of summed over the global mass would fail here.

Budgets.  Against JAX, those of the one-device parity tests: loss 1e-5
relative, confusion counts equal, parameters within 2·lr, first moments
within MU_TOL of each leaf's largest entry (2e-5 for the BN-free ViT,
1e-4 with BatchNorm, 1e-2 for pretraining's bf16 moment).  Two ranks
against one: the same fp32 arithmetic summed in another order, loss
1e-5 relative, first moments (the gradient) within 1e-5 of each leaf's
largest entry (bf16 moment: 1e-2; with BatchNorm 1e-4, since the
statistics of the global batch are flax's E[x²] − E[x]², the one-rank
step's two passes), parameters within 2·lr a step: where a gradient is
rounding noise (the key bias, to which softmax is blind) Adam's first
update lr·sign(g) takes either sign; a moment under 1e-4 of the model's
largest must stay under it.
"""

import inspect
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_distill as tkd
import test_torch_ssl as tssl
import test_torch_train_bn as tbn
import torch_dist_job as job
from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.train import distill as jax_distill
from dfu_multimodal_tpu.train import engine as jax_engine
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.data import loader as port_loader
from dfu_multimodal_tpu_torch.data import transforms as port_transforms
from dfu_multimodal_tpu_torch.tools.convert_jax import (pretrain_state_dict,
                                                        variables_to_state_dict)
from dfu_multimodal_tpu_torch.train import engine as port_engine
from test_torch_train import (CFG, CLASS_WEIGHTS, IMAGE, _batches, _neutral,
                              _tiny_variables, _TinyJaxViTClassifier)

torch.set_num_threads(1)

LR = CFG["learning_rate"]
FIT = dict(num_epochs=2, save_best_after_epoch=1, save_last=True,
           batch_size=4, eval_batch_size=4, async_checkpoint=True)


def _jax_thermal(variables, batch):
    cfg = jax_config.TrainConfig(**CFG, mesh=jax_config.MeshConfig(data=1))
    mod = _neutral(jax_config.thermal_modality, jax_config.AugmentConfig)
    jt = JaxTrainer("thermal_only", cfg, {"thermal": mod},
                    class_weights=CLASS_WEIGHTS, attention_impl="xla",
                    block_impl="flax")
    jt.module = _TinyJaxViTClassifier()
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    state = state.replace(params=jax.tree.map(jnp.asarray,
                                              variables["params"]),
                          opt_state=jt.tx.init(variables["params"]))
    state, m = jt.train_step(state, jax.device_put(batch, jt.batch_sharding),
                             jax.random.PRNGKey(1))
    return _jax_result("thermal_only", state, m)


def _jax_result(name, state, m):
    tree = {"params": jax.tree.map(np.asarray, state.params)}
    if state.batch_stats:
        tree["batch_stats"] = jax.tree.map(np.asarray, state.batch_stats)
    return {"loss": float(m["loss"]), "counts": np.asarray(m["counts"]),
            "state": {k: v.numpy() for k, v in
                      variables_to_state_dict(name, tree).items()},
            "mu": {k: v.numpy() for k, v in variables_to_state_dict(
                name, {"params": jax.tree.map(
                    np.asarray, state.opt_state[0].mu)}).items()}}


def _jax_simclr(jt, params, stats, sim):
    def loss_fn(p):
        z1, z2, bs = jt._project_views(p, stats, sim["v1"], sim["v2"])
        return jax_ssl_loss(z1, z2, sim["valid"], jt.cfg.temperature), bs

    loss, new_params, new_stats, mu = tssl._jax_update(jt, params, loss_fn)
    return {"loss": float(loss),
            "state": {k: v.numpy() for k, v in pretrain_state_dict(
                jax.tree.map(np.asarray, new_params),
                jax.tree.map(np.asarray, new_stats)).items()},
            "mu": {k: v.numpy() for k, v in pretrain_state_dict(
                jax.tree.map(lambda a: np.asarray(a, np.float32), mu),
                None).items()}}


def jax_ssl_loss(z1, z2, valid, temperature):
    from dfu_multimodal_tpu.train import ssl as jax_ssl
    return jax_ssl.nt_xent_loss(z1, z2, valid, temperature)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's results, rank 1's, the JAX references)."""
    d = tmp_path_factory.mktemp("dist_train")
    thermal_vars = _tiny_variables()
    thermal_batch = _batches()[0]
    mm_jt, mm_state, mm_vars = tbn.jax_trainer("multimodal")
    mm_batch = tbn.batches("multimodal")[0]
    ssl_jt = tssl._jax_trainer("tiny", "simclr")
    ssl_vars = tssl._numpy_variables(
        tssl._shapes(ssl_jt, jnp.zeros((1, IMAGE, IMAGE, 3))), 8)
    sim = {"v1": tssl._images(6, 9), "v2": tssl._images(6, 10),
           "valid": np.array([1, 1, 1, 1, 1, 0], np.float32)}
    t_vars = tkd._numpy_variables("tiny_fusion", 3)
    s_vars = tkd._numpy_variables("tiny_rgb", 4)
    kd_batch = tkd._batch(5)
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (12, IMAGE, IMAGE, 3), dtype=np.uint8)
    labels = np.arange(12, dtype=np.int32) % 2
    torch.save({
        "cfg": CFG, "class_weights": CLASS_WEIGHTS,
        "thermal_only_state": variables_to_state_dict("thermal_only",
                                                      thermal_vars),
        "thermal_batch": thermal_batch,
        "eval_images": images[:5], "eval_labels": labels[:5],
        "multimodal_state": variables_to_state_dict("multimodal", mm_vars),
        "mm_batch": mm_batch,
        "ssl_cfg": tssl.CFG, "simclr": sim,
        "simclr_state": pretrain_state_dict(ssl_vars["params"],
                                            ssl_vars["batch_stats"]),
        "teacher_state": variables_to_state_dict("tiny_fusion", t_vars),
        "student_state": variables_to_state_dict("tiny_rgb", s_vars),
        "kd_batch": kd_batch,
        "fit": {"train": images[4:], "ty": labels[4:], "val": images[:4],
                "vy": labels[:4]},
        "fit_cfg": FIT, "fit_dir": str(d / "fit"),
    }, d / "inputs.pt")
    ranks = job.Job("train_job", d)
    # the JAX references while the ranks run
    ref = {"thermal": _jax_thermal(thermal_vars, thermal_batch)}
    mm_state, m = mm_jt.train_step(
        mm_state, jax.device_put(mm_batch, mm_jt.batch_sharding),
        jax.random.PRNGKey(1))
    ref["mm"] = _jax_result("multimodal", mm_state, m)
    ref["simclr"] = _jax_simclr(ssl_jt, ssl_vars["params"],
                                ssl_vars["batch_stats"], sim)
    kd_jt = jax_distill.DistillTrainer(
        "tiny_rgb", "tiny_fusion", t_vars, jax_distill.DistillConfig(),
        jax_config.TrainConfig(**tkd.CFG,
                               mesh=jax_config.MeshConfig(data=1)),
        tkd._neutral(jax_config), class_weights=CLASS_WEIGHTS)
    state, m = kd_jt.train_step(
        tkd._jax_state(kd_jt, s_vars),
        jax.device_put(kd_batch, kd_jt.batch_sharding),
        jax.random.PRNGKey(1))
    ref["kd"] = _jax_result("tiny_rgb", state, m)
    ranks.wait()
    return (torch.load(d / "out0.pt", weights_only=False),
            torch.load(d / "out1.pt", weights_only=False), ref)


def _check(got, ref, *, loss_rel, param_tol, mu_tol, zero_grad=None,
           counts=True):
    """``got`` against ``ref``: loss, confusion counts, every parameter
    (BatchNorm statistics within 1e-5 of their largest entry) and first
    moment (within ``mu_tol`` of each leaf's largest entry; with
    ``zero_grad``, a leaf whose reference moment stays under that share
    of the model's largest must stay under it too)."""
    assert got["loss"] == pytest.approx(ref["loss"], rel=loss_rel)
    if counts:
        np.testing.assert_array_equal(got["counts"], ref["counts"])
    for k, v in ref["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = (1e-5 * float(np.abs(v).max()) if "running" in k
               else param_tol)
        np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=tol,
                                   err_msg=k)
    assert got["mu"].keys() == ref["mu"].keys()
    top = max(float(np.abs(v).max()) for v in ref["mu"].values())
    for k, v in ref["mu"].items():
        scale = float(np.abs(v).max())
        if zero_grad is not None and scale < zero_grad * top:
            assert float(np.abs(got["mu"][k]).max()) < zero_grad * top, k
            continue
        np.testing.assert_allclose(got["mu"][k], v, rtol=0,
                                   atol=mu_tol * scale, err_msg=k)


def _two_vs_one(mode, out, mu_tol=1e-5, counts=True):
    _check(out[mode]["2"], out[mode]["1"], loss_rel=1e-5, param_tol=2 * LR,
           mu_tol=mu_tol, zero_grad=1e-4, counts=counts)


THERMAL_JAX = dict(loss_rel=1e-5, param_tol=2 * LR, mu_tol=2e-5)
BN_JAX = dict(loss_rel=1e-5, param_tol=2 * LR, mu_tol=1e-4)


@pytest.mark.parametrize("mode", ["dp", "accum", "fsdp", "tp"])
def test_thermal_step_matches_one_rank_and_jax(run, mode):
    """The data-parallel step (fused blocks, class weights, a padded row
    on rank 1), grad-accum 3 under it (per-rank microbatches of 1), FSDP
    and tensor parallelism (flax blocks): the one-rank step's results,
    and JAX's full-batch step's (grad-accum's exact gradient is the full
    batch's)."""
    out0, out1, ref = run
    _two_vs_one(mode, out0)
    _check(out0[mode]["2"], ref["thermal"], **THERMAL_JAX)
    _check(out1[mode]["2"], ref["thermal"], **THERMAL_JAX)


def test_tp_plan_splits_every_block_linear(run):
    plan = run[0]["tp"]["plan"]
    for i in range(2):
        for lin, kind in (("attn.qkv", "col"), ("attn.proj", "row"),
                          ("mlp.fc1", "col"), ("mlp.fc2", "row")):
            assert plan[f"vit.blocks.{i}.{lin}"] == kind
    assert len(plan) == 8


def test_multimodal_step_with_cross_rank_batchnorm(run):
    """Three rows a rank; the ResNet's BatchNorm statistics are the
    global batch's (an all-reduce of Σx, Σx², n), its running buffers
    equal the single device's."""
    out0, out1, ref = run
    _two_vs_one("mm", out0, mu_tol=1e-4)
    _check(out0["mm"]["2"], ref["mm"], **BN_JAX)
    _check(out1["mm"]["2"], ref["mm"], **BN_JAX)


def test_views_are_the_single_devices(run):
    """Random augmentation: every rank draws the global batch's transforms
    and keeps its rows, so two ranks take the one-rank step."""
    _two_vs_one("dp_aug", run[0])


def test_simclr_dp_step(run):
    """The tiny BatchNorm trunk, two passes with cross-rank statistics,
    z1, z2 and the validity mask gathered with autograd, local anchors,
    the global count: the one-rank step and JAX's (bf16 first moment)."""
    out0, _, ref = run
    _two_vs_one("simclr", out0, mu_tol=1e-2, counts=False)
    _check(out0["simclr"]["2"], ref["simclr"], loss_rel=1e-5,
           param_tol=2 * LR, mu_tol=1e-2, zero_grad=1e-4, counts=False)


def test_kd_dp_step(run):
    """tiny_rgb under a tiny_fusion teacher: the denominators all-reduced
    before the backward, the numerators per rank."""
    out0, _, ref = run
    _two_vs_one("kd", out0, mu_tol=1e-4)
    _check(out0["kd"]["2"], ref["kd"], loss_rel=1e-5, param_tol=2 * LR,
           mu_tol=1e-4, zero_grad=1e-4)


def test_eval_on_two_ranks_gathers_rows_in_order(run):
    """Five rows, eval batch 3 padded to 4: each rank evaluates its two
    rows, the probabilities come back in row order, the loss and counts
    are the global batch's."""
    got, one = run[0]["dp"]["2"]["eval"], run[0]["dp"]["1"]["eval"]
    assert got["probs"].shape == (5,)
    np.testing.assert_allclose(got["probs"], one["probs"], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["preds"], one["preds"])
    assert got["f1"] == one["f1"]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)


def test_fit_on_two_ranks(run):
    """Two epochs of ``fit`` on the mesh: only rank 0 writes, the files
    and the metrics JSONL are those of the one-rank run (an epoch a line,
    not two), the saved weights equal its weights; asynchronous saves
    fall back to synchronous with JAX's log line on both ranks.  The
    checkpoint restored into an FSDP and a tensor-parallel trainer (the
    weights and moments resharded) gathers back to itself bit for bit."""
    out0, out1, _ = run
    two, one = out0["fit"]["2"], out0["fit"]["1"]
    assert two["files"] == one["files"] and "last_model.pt" in two["files"]
    rows = [json.loads(line) for line in two["jsonl"].splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    for key in ("train_loss", "val_loss", "val_f1"):
        np.testing.assert_allclose(two["history"][key], one["history"][key],
                                   rtol=1e-5)
    steps = 2 * 2                        # 8 rows a batch of 4, 2 epochs
    for k, v in one["state"].items():
        np.testing.assert_allclose(two["state"][k], v, rtol=0,
                                   atol=2 * LR * steps, err_msg=k)
    for key in ("fsdp", "tp"):              # sharded, restored, gathered
        assert out0["fit"][f"restore_{key}"] == 0.0
        assert out1["fit"][f"restore_{key}"] == 0.0
    line = "async checkpointing is single-process only; saving synchronously"
    assert line in two["logs"] and line in out1["fit"]["2"]["logs"]
    assert not any("Saved BEST" in s for s in out1["fit"]["2"]["logs"])


JAX_SOURCE = inspect.getsource(jax_engine)


@pytest.mark.parametrize("case,words", [
    ("mixup", "no mixup; grad-accum only for the BN-free model and only "
              "when it divides the per-device batch"),
    ("bn_accum", "BatchNorm statistics of global microbatches"),
    ("accum_split", "does not divide the per-device batch 3"),
    ("fsdp_tp", "fsdp=True combined with a model axis > 1 is not "
                "supported"),
    ("fused_tp", "is incompatible with tensor parallelism (model axis 2 "
                 "> 1): the fused Pallas kernels are opaque"),
    ("fused_fsdp", "is incompatible with fsdp: the fused Pallas kernels"),
    ("ssl_tp", "pretraining shards no parameters")])
def test_refusals(run, case, words):
    """Each configuration the two-rank step cannot compute as the single
    global program would is refused on both ranks, in the JAX Trainer's
    words where it has them (its source holds them)."""
    for out in run[:2]:
        assert words in out["refusals"][case]
    jax_words = {"mixup": "the BN-free model and only when it divides the",
                 "fsdp_tp": "fsdp=True combined with a model axis > 1 is not",
                 "fused_tp": "the fused Pallas kernels are opaque to",
                 "fused_fsdp": "the fused Pallas kernels are opaque to"}
    if case in jax_words:
        assert jax_words[case] in JAX_SOURCE


# ------------------------------------------------------ no ranks needed


def test_int8_blocks_refuse_training_in_jax_s_words():
    """JAX refuses the serving-only int8 blocks for training on any mesh;
    so does the port, in the same words (its source holds them)."""
    pt = port_engine.Trainer(
        "thermal_only", port_config.TrainConfig(**CFG),
        {"thermal": port_config.thermal_modality()}, device="cpu",
        image_size=IMAGE, block_impl="fused_q8", depth=2, hidden_dim=64,
        num_heads=4, patch_size=8)
    words = "int8 kernels are serving-only (no VJP). Train bf16/fp32"
    with pytest.raises(ValueError, match=re.escape(words)):
        pt.train_step(_batches()[0], torch.Generator().manual_seed(0))
    assert words in JAX_SOURCE


@pytest.mark.parametrize("lo", [0, 3])
def test_augmentation_of_a_rank_is_its_rows_of_the_batchs(lo):
    """``rows=(lo, n)``: the draws of the whole n-row batch, this rank's
    rows kept, bit for bit (jitter, the geometric transform, the blur)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (6, 16, 16, 3),
                                      dtype=np.uint8))
    for mod in (port_config.rgb_modality(), port_config.thermal_modality()):
        full = port_transforms.augment_and_normalize(
            x, mod, torch.float32, torch.Generator().manual_seed(4))
        part = port_transforms.augment_and_normalize(
            x[lo:lo + 3], mod, torch.float32,
            torch.Generator().manual_seed(4), rows=(lo, 6))
        torch.testing.assert_close(part, full[lo:lo + 3], rtol=0, atol=0)


def test_shard_batch_slices_and_refuses_what_jax_refuses():
    batch = {"x": np.arange(6), "valid": np.ones(6, np.float32)}
    local, lo, n = port_loader.shard_batch(batch, 1, 2)
    assert (lo, n) == (3, 6) and local["x"].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="must divide evenly over 4 "
                                         "processes"):
        port_loader.shard_batch(batch, 0, 4)
