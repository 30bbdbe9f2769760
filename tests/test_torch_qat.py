"""Quantization-aware training of the port (``train/qat.py`` and
``Trainer(cfg.qat=True)``) against the JAX package's ``train/qat.py``, on
the CPU.

The cases of the JAX package's tests/test_qat.py and
tests/test_qat_resnet.py, on the port's layouts (an ``nn.Linear`` weight
is (out, in), JAX's dense kernel (in, out); a conv weight OIHW, JAX's
HWIO), the dense and conv cases as one parametrised test each: the
fake quantisers equal JAX's and the serving grid's dequantised values bit
for bit, BN-fold equivariance, the identity (straight-through) gradient,
lossless requantisation of a snapped weight, the transform's scope on the
port's models.  Then a QAT train step of the cut-down thermal_only model
against the JAX Trainer's from the same weights (tests/test_torch_train
.py's model and budgets), a QAT
epoch of each of the three models (finite loss, real weights kept off
the grid by the optimizer), and the QAT eval step equal to the plain eval
step on the dequantised int8 weights (JAX's zero-flip contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as tt
import test_torch_train_bn as bn
from dfu_multimodal_tpu.models import resnet_q8 as jax_resnet_q8
from dfu_multimodal_tpu.ops import vit_block_q8 as jax_vit_q8
from dfu_multimodal_tpu.train import qat as jax_qat
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet_q8 import quantize_conv_weight
from dfu_multimodal_tpu_torch.ops.vit_block_q8 import quantize_weight
from dfu_multimodal_tpu_torch.train import engine as port_engine
from dfu_multimodal_tpu_torch.train import qat

torch.set_num_threads(1)

IMAGE = 32
VIT = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
# (port weight layout, JAX layout of the same weight, port quantiser, JAX
# fake quantiser, port fake quantiser)
KINDS = {
    "dense": ((48, 64), lambda w: w.T, lambda w: quantize_weight(w.t()),
              jax_qat.fake_quant_weight, qat.fake_quant_weight),
    "conv": ((32, 16, 3, 3), lambda w: w.transpose(2, 3, 1, 0),
             lambda w: quantize_conv_weight(w.permute(2, 3, 1, 0)),
             jax_qat.fake_quant_conv_weight, qat.fake_quant_conv_weight),
}


def _weight(kind, seed):
    shape = KINDS[kind][0]
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _dequant(kind, w):
    """The serving grid's dequantised w in the port's layout."""
    q, s = KINDS[kind][2](w)
    dq = q.float() * s
    return dq.t() if kind == "dense" else dq.permute(3, 2, 0, 1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fake_quant_matches_jax_and_the_serving_grid(kind):
    _, to_jax, _, jax_fq, port_fq = KINDS[kind]
    w = _weight(kind, 0)
    ours = port_fq(torch.from_numpy(w))
    ref = np.asarray(jax_fq(jnp.asarray(to_jax(w))))      # JAX layout
    np.testing.assert_array_equal(to_jax(ours.numpy()), ref)
    assert torch.equal(ours, _dequant(kind, torch.from_numpy(w)))
    # and the JAX serving quantiser's grid
    if kind == "dense":
        q, s = jax_vit_q8.quantize_weight(jnp.asarray(w.T))
    else:
        q, s = jax_resnet_q8.quantize_conv_weight(jnp.asarray(to_jax(w)))
    np.testing.assert_array_equal(
        to_jax(ours.numpy()), np.asarray(q.astype(jnp.float32) * s))


@pytest.mark.parametrize("kind", list(KINDS))
def test_straight_through_gradient_is_identity(kind):
    w = torch.from_numpy(_weight(kind, 2)).requires_grad_()
    (KINDS[kind][4](w) * 3.0).sum().backward()
    assert torch.equal(w.grad, torch.full_like(w, 3.0))


@pytest.mark.parametrize("kind", list(KINDS))
def test_on_grid_weights_requantize_losslessly(kind):
    """A snapped weight sits on the serving grid: its absmax element maps
    to ±127·scale, so quantising it again reproduces it."""
    fq = KINDS[kind][4](torch.from_numpy(_weight(kind, 3)))
    torch.testing.assert_close(_dequant(kind, fq), fq, rtol=0, atol=1e-12)
    assert torch.equal(KINDS[kind][4](fq), fq)


def test_bn_fold_equivariance():
    """quantdequant(w·s) == quantdequant(w)·s per output channel, negative
    gammas included: snapping the unfolded conv injects serving's
    fold-then-quantise error."""
    w = torch.from_numpy(_weight("conv", 1))
    s_bn = torch.from_numpy(np.random.default_rng(5).standard_normal(32)
                            .astype(np.float32) * 2.0)
    folded = _dequant("conv", w * s_bn[:, None, None, None])
    want = qat.fake_quant_conv_weight(w) * s_bn[:, None, None, None]
    torch.testing.assert_close(folded, want, rtol=1e-6, atol=1e-7)


def _thermal_trainer(**overrides):
    cfg = TrainConfig(**{**bn.CFG, "batch_size": 4, **overrides})
    mods = bn._modalities(bn.port_config, "multimodal")
    tr = port_engine.Trainer("thermal_only", cfg,
                             {"thermal": mods["thermal"]}, device="cpu",
                             image_size=IMAGE, **VIT)
    zoo.init_model(tr.module, torch.Generator().manual_seed(0))
    return tr


@pytest.mark.parametrize("trunk", ["vit", "resnet"])
def test_trunk_transform_scope(trunk):
    """Only the trunk's quantised weights change: the ViT encoder's four
    dense weights of every block, or every ResNet stage conv (projections
    included); the stem, BatchNorm, LayerNorms, biases, the patch
    embedding and the heads pass through, as does a model without such a
    trunk."""
    if trunk == "vit":
        params = dict(_thermal_trainer().module.named_parameters())
        fn = qat.fake_quant_vit_trunks
        expect = {f"vit.blocks.{i}.{d}.weight" for i in range(2)
                  for d in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")}
    else:
        pt = bn.port_trainer("rgb_only")
        params = dict(pt.module.named_parameters())
        fn = qat.fake_quant_resnet_trunks
        expect = {f"resnet.layer{s}.0.{c}.weight" for s in range(1, 5)
                  for c in ("conv1", "conv2", "conv3", "downsample.0")}
    out = fn(params)
    changed = {k for k in params if not torch.equal(out[k], params[k])}
    assert changed == expect
    both = qat.fake_quant_trunks(params)
    assert all(torch.equal(both[k], out[k]) for k in params)
    other = qat.fake_quant_resnet_trunks if trunk == "vit" \
        else qat.fake_quant_vit_trunks
    assert all(other(params)[k] is params[k] for k in params)


def test_qat_train_step_matches_jax_trainer():
    """One QAT step of the cut-down thermal_only model (its ViT encoder's
    dense weights snapped, the port's fused blocks) from the same weights
    as the JAX Trainer's (tests/test_torch_train.py's model and budgets:
    loss 1e-5 relative, first moments within 2e-5 of each leaf's largest
    entry, parameters within 2·lr)."""
    variables = tt._tiny_variables()
    cfg = tt.jax_config.TrainConfig(
        **tt.CFG, qat=True, mesh=tt.jax_config.MeshConfig(data=1))
    mod = tt._neutral(tt.jax_config.thermal_modality,
                      tt.jax_config.AugmentConfig)
    jt = tt.JaxTrainer("thermal_only", cfg, {"thermal": mod},
                       class_weights=tt.CLASS_WEIGHTS, attention_impl="xla",
                       block_impl="flax")
    jt.module = tt._TinyJaxViTClassifier()
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    state = state.replace(params=jax.tree.map(jnp.asarray,
                                              variables["params"]),
                          opt_state=jt.tx.init(variables["params"]))
    pt = tt._port_trainer(qat=True)
    pt.module.load_state_dict(tt.variables_to_state_dict("thermal_only",
                                                         variables))
    batch = tt._batches()[0]
    state, jm = jt.train_step(state, jax.device_put(batch,
                                                    jt.batch_sharding),
                              jax.random.PRNGKey(1))
    pm = pt.train_step(batch, torch.Generator().manual_seed(0))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    # the QAT loss is not the plain one: the snap is in the step
    plain = tt._port_trainer()
    plain.module.load_state_dict(tt.variables_to_state_dict("thermal_only",
                                                            variables))
    assert float(plain.train_step(batch, torch.Generator().manual_seed(0))
                 ["loss"]) != float(pm["loss"])
    ref_mu = tt.variables_to_state_dict(
        "thermal_only", {"params": jax.tree.map(np.asarray,
                                                state.opt_state[0].mu)})
    for k, mu in zip([k for k, _ in pt.module.named_parameters()],
                     pt.optimizer.mu):
        ref = ref_mu[k].numpy()
        np.testing.assert_allclose(mu.numpy(), ref, rtol=0,
                                   atol=2e-5 * float(np.abs(ref).max()),
                                   err_msg=k)
    ref = tt.variables_to_state_dict(
        "thermal_only", {"params": jax.tree.map(np.asarray, state.params)})
    ours = pt.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                   atol=2 * tt.CFG["learning_rate"],
                                   err_msg=k)


@pytest.mark.parametrize("name", ["thermal_only", "rgb_only", "multimodal"])
def test_qat_trains_every_model(name):
    """A QAT epoch of each model (cut-down): a finite loss, every weight
    moved, and the optimizer's weights the real ones — off the grid, which
    the loss only sees through the snap."""
    if name == "thermal_only":
        pt = _thermal_trainer(qat=True)
    else:
        pt = bn.port_trainer(name, qat=True, batch_size=4)
        zoo.init_model(pt.module, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    inputs = pt.spec.inputs
    ds = ArrayDataset({m: rng.integers(0, 256, (8, IMAGE, IMAGE, 3),
                                       dtype=np.uint8) for m in inputs},
                      np.array([0, 1] * 4, np.int32))
    before = {k: v.clone() for k, v in pt.module.named_parameters()}
    m = pt.run_train_epoch(ds, np.random.default_rng(0),
                           torch.Generator().manual_seed(0))
    assert np.isfinite(m.loss)
    after = dict(pt.module.named_parameters())
    assert all(not torch.equal(before[k], after[k]) for k in before)
    snapped = qat.fake_quant_trunks(after)
    off_grid = [k for k in after if not torch.equal(snapped[k], after[k])]
    assert off_grid


def test_qat_eval_equals_the_dequantised_int8_weights():
    """JAX's zero-flip contract: after a QAT epoch, the QAT eval step (the
    snapped weights) gives the probabilities of the plain eval step on the
    int8 weights dequantised, since both use the serving grid."""
    tr = _thermal_trainer(qat=True, batch_size=8)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (8, IMAGE, IMAGE, 3), dtype=np.uint8)
    ds = ArrayDataset({"thermal": images}, np.array([0, 1] * 4, np.int32))
    tr.run_train_epoch(ds, np.random.default_rng(0),
                       torch.Generator().manual_seed(0))
    out_qat = tr.eval_step({"thermal": images})
    plain = _thermal_trainer(qat=False, batch_size=8)
    sd = tr.module.state_dict()
    for i in range(VIT["depth"]):
        for d in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            key = f"vit.blocks.{i}.{d}.weight"
            sd[key] = _dequant("dense", sd[key])
    plain.module.load_state_dict(sd, strict=True)
    out = plain.eval_step({"thermal": images})
    torch.testing.assert_close(out["probs"], out_qat["probs"], rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(out["preds"], out_qat["preds"])
