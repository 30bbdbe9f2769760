"""The port's fused ResNet bottleneck (K11) and rgb_only serving path
against the JAX package's, on the CPU.

The JAX side runs its Pallas bottleneck in interpret mode
(``interpret=True``, ``block_impl="fused_interpret"``), as its own tests
do (tests/test_ops.py); the port's CPU tensors take the plain version.
Inputs are made with numpy from a seed.

Tolerances, each with its reason (``python -m pytest
tests/test_torch_resnet_block.py -s`` prints every measured error):

- bottleneck, fp32: 2e-5 (JAX's own kernel-vs-oracle budget): the same
  math, summed in another order;
- bottleneck, bf16: 2e-2·(1+|ref|): the same roundings, but an fp32 sum
  taken in another order may land one bf16 step apart before it is
  rounded;
- gradients (remat through the plain version vs ``jax.grad`` of the
  interpret kernel): 5e-5 for x, 1e-4 for the weights (JAX's budgets);
- tiny fused trunk vs JAX ``fused_interpret`` and vs the port's cuDNN-style
  path: 2e-4 (JAX's budget; BatchNorm folded into the weights rounds
  otherwise than BatchNorm after the conv);
- full-width rgb_only at 32², fp32, fused vs JAX flax through the bridge:
  probabilities rtol 1e-4, atol 1e-5 — 53 fp32 convolutions, BN folded on
  one side and applied on the other, summed in another order (the same
  budget as the multimodal eval step, tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.config import rgb_modality as jax_rgb_modality
from dfu_multimodal_tpu.data.transforms import eval_normalize
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.models.resnet import ResNet as JaxResNet
from dfu_multimodal_tpu.ops import resnet_block as jax_rb
from dfu_multimodal_tpu_torch.config import TrainConfig, rgb_modality
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet import ResNet, ResNetClassifier
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
from dfu_multimodal_tpu_torch.serve.engine import ServingEngine
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    resnet_state_dict, variables_to_state_dict)
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

IMAGE = 32
TINY = dict(stage_sizes=(2, 2), widths=(8, 16))
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _bottleneck_args(seed, b, hw, cin, cmid, cout, proj):
    """x and the folded (w1, b1, w2, b2, w3, b3[, wd, bd]) as numpy."""
    rng = np.random.default_rng(seed)
    x = _f32(rng, b, hw, hw, cin)
    args = [_f32(rng, cin, cmid, scale=cin ** -0.5),
            _f32(rng, cmid, scale=0.1),
            _f32(rng, 9 * cmid, cmid, scale=(9 * cmid) ** -0.5),
            _f32(rng, cmid, scale=0.1),
            _f32(rng, cmid, cout, scale=cmid ** -0.5),
            _f32(rng, cout, scale=0.1)]
    if proj:
        args += [_f32(rng, cin, cout, scale=cin ** -0.5),
                 _f32(rng, cout, scale=0.1)]
    return x, args


def _to_torch(x, args, dtype):
    """Weights (even positions) and x in the compute dtype, biases fp32."""
    return (torch.from_numpy(x).to(dtype),
            [torch.from_numpy(a).to(dtype if i % 2 == 0 else torch.float32)
             for i, a in enumerate(args)])


def _to_jax(x, args, dtype):
    return (jnp.asarray(x, dtype),
            [jnp.asarray(a, dtype if i % 2 == 0 else jnp.float32)
             for i, a in enumerate(args)])


# (batch, H=W, Cin, Cmid, Cout, projection): JAX's own test shapes; the
# projection batch puts several images in one grid step
SHAPES = {"identity": (3, 6, 32, 8, 32, False),
          "projection": (4, 6, 16, 8, 32, True)}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bottleneck_matches_pallas_interpret(shape, dtype, tol):
    b, hw, cin, cmid, cout, proj = SHAPES[shape]
    x, args = _bottleneck_args(10, b, hw, cin, cmid, cout, proj)
    xt, at = _to_torch(x, args, dtype)
    out = rb.fused_bottleneck(xt, *at)
    xj, aj = _to_jax(x, args, JAX_DTYPES[dtype])
    ref = np.asarray(jax_rb.fused_bottleneck(xj, *aj, interpret=True),
                     np.float32)
    assert out.dtype == dtype and out.shape == (b, hw, hw, cout)
    got = out.float().numpy()
    err = float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))
    print(f"\nbottleneck {shape} {dtype}: max|d|/(1+|ref|) = {err:.3e} "
          f"(tol {tol:g})")
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bottleneck_gradients_match_jax(shape):
    """FusedBottleneck's remat backward against jax.grad through the JAX
    custom VJP of the interpret kernel, for x and every weight."""
    b, hw, cin, cmid, cout, proj = SHAPES[shape]
    x, args = _bottleneck_args(11, b, 4, cin, cmid, cout, proj)
    xt, at = _to_torch(x, args, torch.float32)
    leaves = [xt] + at
    for t in leaves:
        t.requires_grad_(True)
    extra = [] if proj else [None, None]
    out = rb.FusedBottleneck.apply(*leaves, *extra)
    (out ** 2).sum().backward()

    def loss(*a):
        return jnp.sum(jax_rb.fused_bottleneck(*a, interpret=True) ** 2)

    refs = jax.grad(loss, argnums=tuple(range(len(leaves))))(
        jnp.asarray(x), *[jnp.asarray(a) for a in args])
    for i, (t, ref) in enumerate(zip(leaves, refs)):
        tol = 5e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol, err_msg=f"arg {i}")


# ---------------------------------------------------------------- trunks


def _perturb(variables, seed):
    """numpy copy of a JAX variables tree with every vector leaf moved off
    its initial value (BN variances stay positive), so folding is
    exercised and a misplaced key cannot hide behind a zero or a one."""
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
def tiny_trunks():
    """JAX variables of a 2-stage bottleneck trunk (widths 8, 16), the
    input, and the port's fused and cuDNN-style trunks holding them."""
    x = _images(2, seed=3)
    variables = _perturb(JaxResNet(block_impl="flax", **TINY).init(
        {"params": jax.random.PRNGKey(3)}, jnp.asarray(x), train=False),
        seed=3)
    sd = resnet_state_dict(variables["params"], variables["batch_stats"])
    ports = {}
    for impl in ("fused", "flax"):
        ports[impl] = ResNet(block_impl=impl, **TINY).eval()
        ports[impl].load_state_dict(sd, strict=True)
    return variables, x, ports


def test_tiny_fused_trunk_matches_jax_and_cudnn_path(tiny_trunks):
    variables, x, ports = tiny_trunks
    ref = np.asarray(JaxResNet(block_impl="fused_interpret", **TINY).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        fused = ports["fused"](torch.from_numpy(x)).numpy()
        flax = ports["flax"](torch.from_numpy(x)).numpy()
    assert fused.shape == (2, 64) and fused.dtype == np.float32
    print(f"\ntiny trunk: fused vs JAX fused_interpret "
          f"{np.abs(fused - ref).max():.3e}, fused vs cuDNN-style path "
          f"{np.abs(fused - flax).max():.3e} (tol 2e-4)")
    np.testing.assert_allclose(fused, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(fused, flax, rtol=2e-4, atol=2e-4)


def test_fused_trunk_runs_each_stride1_block_through_the_kernel(
        tiny_trunks, monkeypatch):
    """Eval with "fused" sends every stride-1 bottleneck (stage 1's
    projection block and the identity blocks) through the kernel's
    wrapper, and nothing else; train mode and "auto" send none."""
    _, x, ports = tiny_trunks
    calls = []
    plain = rb.bottleneck_ref

    def counting(*args):
        calls.append(args[7] is not None)           # projection?
        return plain(*args)

    monkeypatch.setattr(rb, "bottleneck_ref", counting)
    with torch.no_grad():
        ports["fused"](torch.from_numpy(x))
        # stage 1: the projection block and an identity block; stage 2:
        # the identity block after the strided one
        assert sorted(calls) == [False, False, True]
        calls.clear()
        for impl, train in (("auto", False), ("fused", True)):
            net = ResNet(block_impl=impl, **TINY).train(train)
            net.load_state_dict(ports["fused"].state_dict())
            net(torch.from_numpy(x))
    assert calls == []


def test_state_dict_keys_match_across_block_impls():
    sds = {impl: ResNet(block_impl=impl, **TINY).state_dict()
           for impl in ("auto", "flax", "fused")}
    shapes = {impl: {k: tuple(v.shape) for k, v in sd.items()}
              for impl, sd in sds.items()}
    assert shapes["fused"] == shapes["flax"] == shapes["auto"]
    heads = {impl: ResNetClassifier(block_impl=impl).state_dict().keys()
             for impl in ("flax", "fused")}
    assert heads["fused"] == heads["flax"]
    assert {k.split(".")[0] for k in heads["fused"]} == {"resnet", "head"}


def test_unported_options_raise():
    with pytest.raises(ValueError, match="block_impl"):
        ResNet(block_impl="pallas")
    # the ResNet-18 student is ported (tests/test_torch_students.py): its
    # basic blocks take no kernel, so "fused" leaves them on cuDNN; a
    # trunk the JAX package does not have raises
    with pytest.raises(ValueError, match="trunk"):
        ResNetClassifier(trunk="resnet34")
    student = ResNetClassifier(trunk="resnet18", block_impl="fused")
    assert student.head.in_features == 512
    assert not any(hasattr(b, "forward_fused")
                   for b in student.resnet.modules())
    x, args = _bottleneck_args(12, 1, 4, 32, 8, 32, True)
    xt, at = _to_torch(x, args, torch.float32)
    with pytest.raises(ValueError, match="wd and bd"):
        rb.fused_bottleneck(xt, *at[:7])
    # a tensor on no CPU takes no plain version: the kernel or an error
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rb.fused_bottleneck(xt.to("meta"), *[a.to("meta") for a in at])
    # one rgb_only train step runs (cuDNN-style blocks in train mode with
    # block_impl="fused", live BatchNorm), and moves weights and statistics
    trainer = _rgb_trainer()
    rng = np.random.default_rng(13)
    batch = {"rgb": rng.integers(0, 256, (2, IMAGE, IMAGE, 3), np.uint8),
             "label": np.array([0, 1]), "valid": np.ones(2, np.float32)}
    before = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    out = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(out["loss"])) and trainer.optimizer.count == 1
    after = trainer.module.state_dict()
    for k in ("resnet.conv1.weight", "resnet.bn1.running_var",
              "resnet.layer4.2.bn3.running_mean", "head.bias"):
        assert not torch.equal(before[k], after[k]), k
    assert int(after["resnet.layer4.2.bn3.num_batches_tracked"]) == 1


# ------------------------------------------------------- the rgb_only slice


@pytest.fixture(scope="module")
def jax_rgb_only():
    """(module, spec, perturbed numpy variables) of the JAX rgb_only model
    (flax ResNet-50) at full width, image 32."""
    module, spec = jax_zoo.build("rgb_only")
    variables = jax_zoo.init_model(module, spec, jax.random.PRNGKey(4),
                                   image_size=IMAGE)
    return module, spec, _perturb(variables, seed=4)


def _rgb_trainer():
    return Trainer("rgb_only", TrainConfig(compute_dtype="float32"),
                   {"rgb": rgb_modality()}, device="cpu", image_size=IMAGE,
                   block_impl="fused")


def test_rgb_only_fused_eval_step_matches_jax(jax_rgb_only):
    module, spec, variables = jax_rgb_only
    rng = np.random.default_rng(5)
    batch = {"rgb": rng.integers(0, 256, (3, IMAGE, IMAGE, 3), dtype=np.uint8)}
    inputs = {"rgb": eval_normalize(jnp.asarray(batch["rgb"]),
                                    jax_rgb_modality(), jnp.float32)}
    logits = jax_zoo.apply_model(module, spec, variables, inputs, train=False)
    ref = np.asarray(jax.nn.softmax(logits, axis=-1)[:, 1])

    trainer = _rgb_trainer()
    trainer.module.load_state_dict(
        variables_to_state_dict("rgb_only", variables), strict=True)
    assert zoo.param_count(trainer.module) == jax_zoo.param_count(variables)
    assert zoo.param_count(trainer.module) == 23_512_130
    out = trainer.eval_step(batch)
    print(f"\nrgb_only fused vs JAX flax: max|dprob| "
          f"{np.abs(out['probs'].numpy() - ref).max():.3e}")
    np.testing.assert_allclose(out["probs"].numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(out["preds"].numpy(),
                                  np.argmax(np.asarray(logits), axis=-1))

    # the same model behind the serving engine: padded buckets, one row
    # per request, the eval step's answers
    samples = [{"rgb": im} for im in batch["rgb"]]
    with ServingEngine(trainer, image_size=IMAGE, max_batch=2) as engine:
        served = engine.predict(samples)
    np.testing.assert_allclose([p for p, _ in served], out["probs"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert [int(c) for _, c in served] == out["preds"].tolist()
