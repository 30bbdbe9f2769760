"""The ResNet-18 distillation students of the port against the JAX package
on the CPU at 32²: ``resnet18_rgb`` and ``resnet18_thermal`` in fp32 on
the same weights (through ``tools/convert_jax.py``), the int8 student
trunk on a JAX int8 tree, the student trees through the bridge both
ways, and ``quantize_for_serving`` of both students.

Budgets: the ResNet-50 parity tests' (``tests/test_torch_resnet_block.py``:
probabilities rtol 1e-4, atol 1e-5; ``tests/test_torch_q8_resnet.py``:
int8 features 1e-5 of their largest, quantised trees equal but for
boundary entries one step apart, int8 logits within JAX's 0.2 of the fp32
model's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.config import rgb_modality as jax_rgb_modality
from dfu_multimodal_tpu.config import (thermal_modality as
                                       jax_thermal_modality)
from dfu_multimodal_tpu.data.transforms import eval_normalize
from dfu_multimodal_tpu.models import resnet_q8 as jax_q8
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu_torch.models import resnet_q8 as port_q8
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet import BasicBlock, ResNet
from dfu_multimodal_tpu_torch.serve.engine import (ServingEngine,
                                                   quantize_for_serving)
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    int8_resnet_params, int8_resnet_state_dict, resnet_params,
    resnet_state_dict, variables_to_state_dict)
from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                   rgb_modality,
                                                   thermal_modality)
from test_torch_q8_resnet import _compare_trees, _report

torch.set_num_threads(2)

IMAGE = 32
STUDENTS = ("resnet18_rgb", "resnet18_thermal")
MODALITY = {"resnet18_rgb": ("rgb", jax_rgb_modality),
            "resnet18_thermal": ("thermal", jax_thermal_modality)}


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_student():
    """(JAX student classifier module, its jitted eval apply, numpy
    variables): the weights drawn by the port (seeded, BatchNorm
    statistics off identity) and carried to JAX's tree by
    ``convert_jax.resnet_params`` (one module for both zoo entries)."""
    torch.manual_seed(6)
    port = zoo.build("resnet18_rgb")[0]
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.running_mean, -0.1, 0.1),
                                  (m.running_var, 0.5, 1.5),
                                  (m.weight, 0.8, 1.2),
                                  (m.bias, -0.1, 0.1)):
                    t.uniform_(lo, hi)
    sd = port.state_dict()
    params, stats = resnet_params(sd, "resnet.")
    variables = {"params": {"ResNet_0": params, "head": {
        "kernel": sd["head.weight"].numpy().T.copy(),
        "bias": sd["head.bias"].numpy()}},
        "batch_stats": {"ResNet_0": stats}}
    module, _ = jax_zoo.build("resnet18_rgb")
    apply = jax.jit(lambda v, x: module.apply(v, x, train=False))
    return module, apply, variables


def _port(name, variables, dtype="float32", **kwargs):
    tr = Trainer(name, TrainConfig(compute_dtype=dtype),
                 {"rgb": rgb_modality(), "thermal": thermal_modality()},
                 device="cpu", image_size=IMAGE, **kwargs)
    tr.module.load_state_dict(variables_to_state_dict(name, variables),
                              strict=True)
    return tr


@pytest.mark.parametrize("name", STUDENTS)
def test_student_matches_jax(name, jax_student):
    """The fp32 student's eval step (its modality's normalisation, the
    ResNet-18 trunk, the 512-wide head) against JAX's on the same weights
    and images; 11.2M parameters on both sides."""
    _, apply, variables = jax_student
    mod, jax_modality = MODALITY[name]
    batch = {mod: _images(3, 7)}
    x = eval_normalize(jnp.asarray(batch[mod]), jax_modality(), jnp.float32)
    logits = np.asarray(apply(variables, x))
    ref = np.asarray(jax.nn.softmax(logits, axis=-1)[:, 1])
    tr = _port(name, variables)
    assert tr.spec.inputs == (mod,)
    assert zoo.param_count(tr.module) == jax_zoo.param_count(variables)
    assert zoo.param_count(tr.module) == 11_177_538
    assert isinstance(tr.module.resnet.layer2[0], BasicBlock)
    out = tr.eval_step(batch)
    print(f"\n{name} vs JAX: max|dprob| "
          f"{np.abs(out['probs'].numpy() - ref).max():.3e}")
    np.testing.assert_allclose(out["probs"].numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(out["preds"].numpy(),
                                  np.argmax(logits, axis=-1))


@pytest.fixture(scope="module")
def student_trunk(jax_student):
    """(the port's float student trunk, a calibration batch, its absmaxes,
    JAX's int8 tree of the same weights and absmaxes)."""
    _, _, variables = jax_student
    trunk = {"params": variables["params"]["ResNet_0"],
             "batch_stats": variables["batch_stats"]["ResNet_0"]}
    port = ResNet((2, 2, 2, 2), block_type="basic", dtype=torch.float32)
    port.load_state_dict(resnet_state_dict(trunk["params"],
                                           trunk["batch_stats"]),
                         strict=True)
    x = np.random.default_rng(8).standard_normal(
        (2, IMAGE, IMAGE, 3)).astype(np.float32)
    absmax = port_q8.calibrate_resnet(port, [torch.from_numpy(x)])
    flat = {(block, conv): v for block, convs in absmax.items()
            for conv, v in convs.items()}
    tree = jax.jit(lambda t: jax_q8.quantize_resnet_params(
        t, flat, stage_sizes=(2, 2, 2, 2), block_type="basic"))(
        trunk)["params"]
    return port, x, absmax, jax.tree.map(np.asarray, tree)


def test_student_quantisation_matches_jax(student_trunk):
    """The float student trunk records each block's conv1_in (which the
    projection shares) and conv2_in, and ``quantize_resnet_params`` turns
    the weights and those absmaxes into JAX's int8 tree (``proj``
    scopes)."""
    port, _, absmax, tree = student_trunk
    assert absmax["stage2_block0"].keys() == {"conv1_in", "conv2_in"}
    assert len(absmax) == 8
    sd = port_q8.quantize_resnet_params(port.state_dict(), absmax,
                                        (2, 2, 2, 2), "basic")
    assert "layer2.0.proj.kernel_q8" in sd and not any("down" in k
                                                       for k in sd)
    _compare_trees("student quantize_resnet_params", int8_resnet_params(sd),
                   tree)


def test_int8_student_on_the_jax_tree_matches_jax(student_trunk):
    """JAX's int8 student tree through ``convert_jax`` into the port's
    ``Int8ResNet18`` (strict load): features and taps against JAX's
    ``Int8ResNet18`` in fp32."""
    _, x, _, tree = student_trunk
    net = port_q8.Int8ResNet18(dtype=torch.float32)
    net.load_state_dict(int8_resnet_state_dict(tree), strict=True)
    taps = {}
    with torch.no_grad():
        out = net(torch.from_numpy(x), taps).numpy()
    jax_net = jax_q8.Int8ResNet18(dtype=jnp.float32)
    ref, inter = jax.jit(lambda p, x: jax_net.apply(
        p, x, train=False, mutable=["intermediates"]))({"params": tree},
                                                      jnp.asarray(x))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 512)
    _report("int8 student features vs JAX (of max|feature|)",
            float(np.abs(out - ref).max()) / float(np.abs(ref).max()), 1e-5)
    theirs = np.asarray(inter["intermediates"]["stage4"][0])
    _report("int8 student tap stage4 vs JAX (of its max)",
            float(np.abs(taps["stage4"].numpy() - theirs).max())
            / float(np.abs(theirs).max()), 1e-5)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_student_trees_convert_both_ways(kind, jax_student, student_trunk):
    """A JAX student tree -> the port's keys (strict load) -> the JAX tree
    again, leaf for leaf: float (params and batch stats) and int8."""
    if kind == "float":
        _, _, variables = jax_student
        sd = variables_to_state_dict("resnet18_thermal", variables)
        zoo.build("resnet18_thermal")[0].load_state_dict(sd, strict=True)
        params, stats = resnet_params(sd, "resnet.")
        pairs = ((params, variables["params"]["ResNet_0"]),
                 (stats, variables["batch_stats"]["ResNet_0"]))
    else:
        tree = student_trunk[3]
        sd = {f"resnet.{k}": v for k, v in
              int8_resnet_state_dict(tree).items()}
        sd.update({"head.weight": torch.zeros(2, 512),
                   "head.bias": torch.zeros(2)})
        zoo.build("resnet18_rgb", block_impl="int8")[0].load_state_dict(
            sd, strict=True)
        pairs = ((int8_resnet_params(sd, "resnet."), tree),)
    for ours, ref in pairs:
        assert jax.tree.structure(ours) == jax.tree.structure(
            jax.tree.map(np.asarray, ref))
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", STUDENTS)
def test_quantize_for_serving_students(name, jax_student):
    """``quantize_for_serving`` of each student: the int8 basic-block
    trunk, calibrated on its own modality's normalised images (each
    act_scale = absmax / 127 of the float trunk's record on them), logits
    within JAX's 0.2 of the fp32 model's, and the ServingEngine's
    answers equal to its eval step's."""
    _, _, variables = jax_student
    tr = _port(name, variables)
    mod = MODALITY[name][0]
    calib = _images(4, 9)
    q = quantize_for_serving(tr, image_size=IMAGE, calib_u8=calib)
    assert isinstance(q.module.resnet, port_q8.Int8ResNet)
    assert isinstance(q.module.resnet.layer3[0], port_q8.Int8BasicBlock)
    norm = tr._preprocess_eval({mod: torch.from_numpy(calib)})
    absmax = port_q8.calibrate_resnet(tr.module.resnet, list(norm))
    assert float(q.module.resnet.layer3[0].conv2.act_scale) == pytest.approx(
        absmax["stage3_block0"]["conv2_in"] / 127.0, rel=1e-6)
    batch = {mod: _images(3, 10)}
    norm = tr._preprocess_eval({mod: torch.from_numpy(batch[mod])})
    q.module.eval()
    tr.module.eval()
    with torch.no_grad():
        d = float((q.module(*norm) - tr.module(*norm)).abs().max())
    _report(f"{name} int8 vs fp32 logits", d, 0.2)
    ref = q.eval_step(batch)
    with ServingEngine(q, image_size=IMAGE, max_batch=4,
                       max_wait_ms=200.0) as engine:
        got = engine.predict([{mod: im} for im in batch[mod]])
    np.testing.assert_array_equal([p for p, _ in got], ref["probs"].numpy())
