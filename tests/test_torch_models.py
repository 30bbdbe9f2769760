"""Port models against the JAX package's flax models on the CPU, with the
same weights carried across by the weight bridge (tools/convert_jax.py).

The JAX variables are made by the JAX initialisers, then every vector
leaf (biases, LayerNorm/BatchNorm params, BN statistics, CLS token and
position embedding) is perturbed with numpy noise from a seed, so a key
that lands in the wrong place cannot hide behind a zero or a one.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.config import (TrainConfig, rgb_modality,
                                       thermal_modality)
from dfu_multimodal_tpu.data.transforms import eval_normalize
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.models.resnet import ResNet50 as JaxResNet50
from dfu_multimodal_tpu.models.vit import ViT as JaxViT
from dfu_multimodal_tpu.tools.convert_torch import convert_state_dict
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet import ResNet50
from dfu_multimodal_tpu_torch.models.vit import ViT
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    resnet_state_dict, variables_to_state_dict, vit_state_dict)
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.train.engine import TrainConfig as PortConfig
from dfu_multimodal_tpu_torch.train.engine import \
    thermal_modality as port_thermal

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parents[1]
IMAGE = 32


def _perturb(variables, seed):
    """numpy copy of a JAX variables tree with every non-kernel leaf
    moved off its initial value (BN variances stay positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = str(path[-1].key)
        if name == "var":
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "kernel":
            return x
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _images(batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, IMAGE, IMAGE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_multimodal():
    """(module, spec, perturbed numpy variables) of the JAX multimodal
    model at full width, image 32."""
    module, spec = jax_zoo.build("multimodal")
    variables = jax_zoo.init_model(module, spec, jax.random.PRNGKey(0),
                                   image_size=IMAGE)
    return module, spec, _perturb(variables, seed=0)


# ------------------------------------------------------------------- ViT


def _tiny_vit_variables(**port_kw):
    kw = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
    x = _images(2, seed=1)
    flax_vit = JaxViT(block_impl="flax", attention_impl="xla", **kw)
    variables = _perturb(flax_vit.init({"params": jax.random.PRNGKey(1)},
                                       jnp.asarray(x), train=False), seed=1)
    port = ViT(image_size=IMAGE, **kw, **port_kw)
    port.load_state_dict(vit_state_dict(variables["params"]), strict=True)
    return kw, variables, x, port.eval()


@pytest.mark.parametrize("block_impl,rtol,atol,port_kw", [
    # fp32 flax blocks against the port's fused blocks: the same math,
    # summed in another order
    pytest.param("flax", 1e-4, 1e-4, {}, id="flax-0.0001-0.0001"),
    # fused Pallas blocks in interpret mode: their logistic GELU against
    # the port's exact erf GELU (the reference's budget, test_ops.py:173)
    pytest.param("fused_interpret", 1e-3, 3e-3, {},
                 id="fused_interpret-0.001-0.003"),
    # the port's flax blocks, attention by the packed-qkv kernel's plain
    # version (its normalise-before-P·V numerics) or by xla_attention
    pytest.param("flax", 1e-4, 1e-4,
                 dict(block_impl="flax", attention_impl="pallas"),
                 id="port_flax_pallas"),
    pytest.param("flax", 1e-4, 1e-4,
                 dict(block_impl="flax", attention_impl="xla"),
                 id="port_flax_xla")])
def test_tiny_vit_matches_flax(block_impl, rtol, atol, port_kw):
    kw, variables, x, port = _tiny_vit_variables(**port_kw)
    jvit = JaxViT(block_impl=block_impl, attention_impl="xla", **kw)
    ref = jvit.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("attention_impl", ["pallas", "xla"])
def test_tiny_vit_flax_bf16_matches_flax(attention_impl):
    """bf16 compute, the port's flax blocks against the JAX flax blocks
    (xla attention): both round every activation to bf16, at places that
    differ a little (F.linear and XLA's bf16 dot, P normalised before or
    after the cast), so the reference's bf16 budget (test_ops.py) on
    features the final LayerNorm scales to O(1)."""
    kw, variables, x, port = _tiny_vit_variables(
        block_impl="flax", attention_impl=attention_impl,
        dtype=torch.bfloat16)
    jvit = JaxViT(block_impl="flax", attention_impl="xla",
                  dtype=jnp.bfloat16, **kw)
    ref = np.asarray(jvit.apply(variables, jnp.asarray(x), train=False),
                     np.float32)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-2, atol=5e-2)


def test_one_jax_tree_loads_into_every_float_block():
    """The flax and fused blocks declare the same keys: one JAX trunk
    loads strictly into both and both compute the same features."""
    kw, variables, x, fused = _tiny_vit_variables()
    sd = vit_state_dict(variables["params"])
    flax = ViT(image_size=IMAGE, block_impl="flax", **kw)
    assert flax.state_dict().keys() == fused.state_dict().keys() == sd.keys()
    flax.load_state_dict(sd, strict=True)
    with torch.no_grad():
        a = flax.eval()(torch.from_numpy(x))
        b = fused(torch.from_numpy(x))
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- ResNet


def test_resnet50_matches_flax():
    x = _images(2, seed=2)
    jres = JaxResNet50()
    variables = _perturb(jres.init({"params": jax.random.PRNGKey(2)},
                                   jnp.asarray(x), train=False), seed=2)
    ref = np.asarray(jres.apply(variables, jnp.asarray(x), train=False))
    port = ResNet50()
    port.load_state_dict(resnet_state_dict(variables["params"],
                                           variables["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 2048)
    # fp32 convs summed in another order through 53 layers
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------------------ multimodal


def _trainer():
    return Trainer("multimodal", TrainConfig(compute_dtype="float32"),
                   {"rgb": rgb_modality(), "thermal": thermal_modality()},
                   device="cpu", image_size=IMAGE)


def test_multimodal_eval_step_matches_jax(jax_multimodal):
    module, spec, variables = jax_multimodal
    rng = np.random.default_rng(3)
    batch = {m: rng.integers(0, 256, (3, IMAGE, IMAGE, 3), dtype=np.uint8)
             for m in ("rgb", "thermal")}
    modalities = {"rgb": rgb_modality(), "thermal": thermal_modality()}
    inputs = {m: eval_normalize(jnp.asarray(batch[m]), modalities[m],
                                jnp.float32) for m in batch}
    logits = jax_zoo.apply_model(module, spec, variables, inputs,
                                 train=False)
    ref = np.asarray(jax.nn.softmax(logits, axis=-1)[:, 1])

    trainer = _trainer()
    trainer.module.load_state_dict(
        variables_to_state_dict("multimodal", variables), strict=True)
    out = trainer.eval_step(batch)
    np.testing.assert_allclose(out["probs"].numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(out["preds"].numpy(),
                                  np.argmax(np.asarray(logits), axis=-1))


def test_bridge_round_trip(jax_multimodal):
    """variables -> port state_dict -> convert_torch.convert_state_dict
    onto an all-zero tree gives back every original leaf, exactly."""
    _, _, variables = jax_multimodal
    sd = variables_to_state_dict("multimodal", variables)
    zeros = jax.tree.map(np.zeros_like, variables)
    merged, skipped = convert_state_dict("multimodal", sd, zeros)
    assert skipped == 0
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_out = dict(jax.tree_util.tree_leaves_with_path(merged))
    assert flat_out.keys() == flat_ref.keys()
    for path, ref in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_out[path]), ref,
                                      err_msg=str(path))


def test_bridge_loads_strict_and_counts_params(jax_multimodal):
    _, _, variables = jax_multimodal
    model, _ = zoo.build("multimodal", image_size=IMAGE)
    sd = variables_to_state_dict("multimodal", variables)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd, strict=True)
    assert zoo.param_count(model) == jax_zoo.param_count(variables)


@pytest.fixture(scope="module")
def jax_rgb_only_variables():
    """Perturbed numpy variables of the JAX rgb_only model (ResNet-50 +
    head) at full width, image 32."""
    module, spec = jax_zoo.build("rgb_only")
    return _perturb(jax_zoo.init_model(module, spec, jax.random.PRNGKey(5),
                                       image_size=IMAGE), seed=5)


def test_bridge_loads_strict_rgb_only(jax_rgb_only_variables):
    """The bridge's rgb_only case: ResNet_0 -> resnet., head -> head, a
    strict load into both trunk impls, the JAX param count, and the exact
    round trip back through convert_torch.convert_state_dict (which reads
    the reference's head name, ``fc.1``, so the head is renamed for it)."""
    variables = jax_rgb_only_variables
    sd = variables_to_state_dict("rgb_only", variables)
    for block_impl in ("flax", "fused"):
        model, spec = zoo.build("rgb_only", image_size=IMAGE,
                                block_impl=block_impl)
        assert spec.inputs == ("rgb",)
        assert sd.keys() == model.state_dict().keys()
        model.load_state_dict(sd, strict=True)
    assert zoo.param_count(model) == jax_zoo.param_count(variables)
    assert zoo.param_count(model) == 23_512_130
    zeros = jax.tree.map(np.zeros_like, variables)
    reference_keys = {k.replace("head.", "fc.1.", 1): v for k, v in sd.items()}
    merged, skipped = convert_state_dict("rgb_only", reference_keys, zeros)
    assert skipped == 0
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_out = dict(jax.tree_util.tree_leaves_with_path(merged))
    assert flat_out.keys() == flat_ref.keys()
    for path, ref in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_out[path]), ref,
                                      err_msg=str(path))


def test_param_count_at_224():
    model, spec = zoo.build("multimodal")
    assert spec.inputs == ("rgb", "thermal")
    assert zoo.param_count(model) == 110_880_834    # tests/test_models.py


# ------------------------------------------------------- initialisers

# flax's lecun_normal: a normal truncated at ±2σ_p with σ_p =
# fan_in^-0.5 / 0.87962566, so that the draw's std is fan_in^-0.5
TRUNC_STD = 0.87962566103423978


@pytest.mark.parametrize("module,fan_in,jax_shape", [
    (torch.nn.Linear(768, 3072), 768, (768, 3072)),
    (torch.nn.Conv2d(64, 256, 3), 3 * 3 * 64, (3, 3, 64, 256))],
    ids=["linear_768_3072", "conv3x3_64"])
def test_init_model_draws_lecun_normal(module, fan_in, jax_shape):
    """init_model's weights against jax.nn.initializers.lecun_normal() on
    the same shape: std within 1% of it, and every |w| within 2·σ_p (the
    truncation), which the untruncated N(0, 1/fan_in) draw of the same
    generator breaks."""
    zoo.init_model(module, torch.Generator().manual_seed(0))
    w = module.weight.detach()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), jax_shape, jnp.float32))
    assert abs(float(w.std()) / float(ref.std()) - 1.0) <= 0.01
    bound = 2.0 * fan_in ** -0.5 / TRUNC_STD
    assert float(w.abs().max()) <= bound
    assert float(np.abs(ref).max()) <= bound * (1 + 1e-6)
    old = torch.empty_like(w).normal_(0.0, fan_in ** -0.5,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    assert float(old.abs().max()) > bound
    assert module.bias is None or not bool(module.bias.any())


# ------------------------------------------------------ block_impl auto


def test_block_impl_auto_builds_fused_blocks():
    """``block_impl="auto"`` resolves to the fused blocks (the JAX
    ``ViT._resolve_block`` where the kernels run): the same block class
    and the same features as ``"fused"`` on the same weights."""
    kw, variables, x, fused = _tiny_vit_variables(block_impl="fused")
    _, _, _, auto = _tiny_vit_variables(block_impl="auto")
    assert [type(b) for b in auto.blocks] == [type(b) for b in fused.blocks]
    assert type(auto.blocks[0]).__name__ == "FusedEncoderBlock"
    with torch.no_grad():
        assert torch.equal(auto(torch.from_numpy(x)),
                           fused(torch.from_numpy(x)))
    with pytest.raises(ValueError):
        ViT(image_size=IMAGE, block_impl="fast")


def test_trainer_block_impl_auto_takes_a_train_step():
    trainer = Trainer("thermal_only",
                      PortConfig(compute_dtype="float32", batch_size=2),
                      {"thermal": port_thermal()}, device="cpu",
                      image_size=IMAGE, depth=2, hidden_dim=64, num_heads=4,
                      patch_size=8, block_impl="auto")
    assert type(trainer.module.vit.blocks[0]).__name__ == "FusedEncoderBlock"
    zoo.init_model(trainer.module, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    out = trainer.train_step(
        {"thermal": rng.integers(0, 256, (2, IMAGE, IMAGE, 3), np.uint8),
         "label": np.array([0, 1]), "valid": np.ones(2, np.float32)},
        torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(out["loss"]))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in trainer.module.parameters())


NO_JAX_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack",
             "dfu_multimodal_tpu", "PIL", "cv2", "matplotlib"):
    sys.modules[name] = None            # any import of them now fails
import numpy as np
import torch
torch.set_num_threads(1)
import dfu_multimodal_tpu_torch.ops._build
import dfu_multimodal_tpu_torch.serve.engine
import dfu_multimodal_tpu_torch.serve.shadow
import dfu_multimodal_tpu_torch.tools.convert_jax
import dfu_multimodal_tpu_torch.train.qat
import dfu_multimodal_tpu_torch.cli.serve
for mod in ("train.ssl", "train.distill", "train.self_train",
            "models.efficientnet", "cli.pretrain", "cli.distill",
            "cli.self_train", "cli.train_legacy", "cli.fix_checkpoint_keys",
            "cli.convert_checkpoint", "cli.check_gpu",
            "cli.download_datasets", "cli.main", "parallel.mesh",
            "parallel.sharding", "parallel.pipeline"):
    __import__(f"dfu_multimodal_tpu_torch.{mod}")
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import (
    Trainer, TrainConfig, rgb_modality, thermal_modality)

trainer = Trainer("multimodal", TrainConfig(compute_dtype="float32"),
                  {"rgb": rgb_modality(), "thermal": thermal_modality()},
                  device="cpu", image_size=32)
zoo.init_model(trainer.module, torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
batch = {m: rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
         for m in ("rgb", "thermal")}
probs = trainer.eval_step(batch)["probs"]
assert probs.shape == (2,) and bool(torch.isfinite(probs).all())
from dfu_multimodal_tpu_torch.serve.explain import Explainer
explained = Explainer(trainer).explain_one({m: batch[m][0] for m in batch})
assert {m: c["method"] for m, c in explained["cams"].items()} == {
    "rgb": "gradcam", "thermal": "saliency"}
assert all(p.grad is None for p in trainer.module.parameters())
out = trainer.train_step({**batch, "label": np.array([0, 1]),
                          "valid": np.ones(2, np.float32)},
                         torch.Generator().manual_seed(0))
assert bool(torch.isfinite(out["loss"])), out

thermal = Trainer("thermal_only",
                  TrainConfig(compute_dtype="float32", batch_size=2),
                  {"thermal": thermal_modality()}, device="cpu",
                  image_size=32, depth=2, hidden_dim=64, num_heads=4,
                  patch_size=8)
zoo.init_model(thermal.module, torch.Generator().manual_seed(0))
data = ArrayDataset({"thermal": batch["thermal"]}, np.array([0, 1]))
epoch = thermal.run_train_epoch(data, np.random.default_rng(0),
                                torch.Generator().manual_seed(0))
assert np.isfinite(epoch.loss), epoch
import dataclasses
thermal.cfg = dataclasses.replace(thermal.cfg, qat=True)
epoch = thermal.run_train_epoch(data, np.random.default_rng(0),
                                torch.Generator().manual_seed(0))
assert np.isfinite(epoch.loss), epoch
thermal.cfg = dataclasses.replace(thermal.cfg, qat=False)

from dfu_multimodal_tpu_torch.serve.engine import quantize_for_serving
int8 = quantize_for_serving(thermal, image_size=32)
assert int8.variables()["vit.blocks.0.attn.qkv.kernel_q8"].dtype == torch.int8
probs = int8.eval_step({"thermal": batch["thermal"]})["probs"]
assert probs.shape == (2,) and bool(torch.isfinite(probs).all())
import tempfile
from dfu_multimodal_tpu_torch.serve import export
with tempfile.TemporaryDirectory() as bundle:
    export.export_bundle(int8, bundle, image_size=32, buckets=[2])
    frozen = export.load_bundle(bundle, "cpu").eval_step(
        {"thermal": batch["thermal"]})["probs"]
assert torch.equal(frozen, probs)

flax = Trainer("thermal_only",
               TrainConfig(compute_dtype="float32", batch_size=2),
               {"thermal": thermal_modality()}, device="cpu",
               image_size=32, depth=2, hidden_dim=64, num_heads=4,
               patch_size=8, block_impl="flax", attention_impl="pallas")
zoo.init_model(flax.module, torch.Generator().manual_seed(0))
probs = flax.eval_step({"thermal": batch["thermal"]})["probs"]
assert probs.shape == (2,) and bool(torch.isfinite(probs).all())
out = flax.train_step({"thermal": batch["thermal"], "label": np.array([0, 1]),
                       "valid": np.ones(2, np.float32)},
                      torch.Generator().manual_seed(0))
assert bool(torch.isfinite(out["loss"])), out

rgb = Trainer("rgb_only", TrainConfig(compute_dtype="float32"),
              {"rgb": rgb_modality()}, device="cpu", image_size=32,
              block_impl="fused")
zoo.init_model(rgb.module, torch.Generator().manual_seed(0))
probs = rgb.eval_step({"rgb": batch["rgb"]})["probs"]
assert probs.shape == (2,) and bool(torch.isfinite(probs).all())

import dfu_multimodal_tpu_torch.cli.compare
import dfu_multimodal_tpu_torch.cli.cross_validate
import dfu_multimodal_tpu_torch.cli.embed
import dfu_multimodal_tpu_torch.cli.model_card
import dfu_multimodal_tpu_torch.cli.robustness
import dfu_multimodal_tpu_torch.cli.soup
import dfu_multimodal_tpu_torch.cli.sweep
import dfu_multimodal_tpu_torch.eval.embed
import dfu_multimodal_tpu_torch.train.soup
from dfu_multimodal_tpu_torch.eval.compare import compare_models
from dfu_multimodal_tpu_torch.eval.robustness import apply_corruption
report = compare_models(np.array([0, 1, 1, 0]), np.array([0, 1, 0, 0]),
                        None, np.array([0, 1, 1, 1]), None, n_boot=20)
assert report["flip_table"]["n_flips"] == 2, report
x = torch.from_numpy(batch["rgb"]).float()
for name in ("gaussian_blur", "brightness", "contrast"):
    y = apply_corruption(name, x, 2.0)
    assert y.shape == x.shape and 0 <= float(y.min()) <= float(y.max()) <= 255
y = apply_corruption("gaussian_noise", x, 8.0, torch.randn(x.shape))
assert y.shape == x.shape
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "msgpack", "dfu_multimodal_tpu", "PIL",
                                  "cv2", "matplotlib")]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
