"""Frozen serving bundles of the port on the CPU (``serve/export.py``,
``cli/export_model.py``, ``serve --exported``): the serving kernels as
``dfu::`` custom ops, the exported programs' content, bundle rows against
the live eval step and against the JAX package, the bundle rules and the
ServingEngine on a bundle.

Every op's CPU implementation is its plain version, so a bundle replays
here through the plain versions; on the card the same program launches
the kernels (``chip_smoke.py`` phase 17, the full-width models).  Here
the multimodal model keeps its head and feature widths (2048 + 768 ->
512 -> 256 -> 2) with its depth cut: one bottleneck a stage (stage 1's on
K11, the strided ones on cuDNN) and one ViT-B/16 block.  Budgets: a
bundle replays its trainer's eval step bit for bit here (the same ops on
the same inputs); against JAX the port's serving parity budget for the
tiny thermal ViT, 1e-5 on the probabilities
(``tests/test_torch_checkpoint.py``).
"""

import contextlib
import dataclasses
import json
from functools import partial

import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch.cli import export_model
from dfu_multimodal_tpu_torch.cli import predict as port_predict
from dfu_multimodal_tpu_torch.cli import serve as port_serve
from dfu_multimodal_tpu_torch.models import fusion
from dfu_multimodal_tpu_torch.models import resnet_q8 as port_q8
from dfu_multimodal_tpu_torch.models import vit as port_vit
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet import ResNet
from dfu_multimodal_tpu_torch.models.resnet_q8 import quantize_rgb_trunks
from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import conv_q8 as cq
from dfu_multimodal_tpu_torch.ops import fused_mlp as fm
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as q8
from dfu_multimodal_tpu_torch.serve import export as ex
from dfu_multimodal_tpu_torch.serve.engine import ServingEngine
from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                   rgb_modality,
                                                   thermal_modality)
from test_torch_train import (IMAGE, TINY, _tiny_variables,
                              _TinyJaxViTClassifier)

torch.set_num_threads(2)

MODALITIES = {"rgb": rgb_modality(), "thermal": thermal_modality()}
PROB_TOL = 1e-5           # the tiny thermal ViT against JAX


def _t(*shape, seed, scale=1.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).to(dtype)


def _op_cases():
    """Each registered op with CPU operands at small widths: (op, args,
    its plain version on the same args)."""
    x, c = _t(2, 5, 16, seed=0), 16
    ln = (_t(c, seed=1, scale=0.1) + 1, _t(c, seed=2, scale=0.1))
    wqkv, bqkv = _t(c, 3 * c, seed=3, scale=0.2), _t(3 * c, seed=4)
    wproj, bproj = _t(c, c, seed=5, scale=0.2), _t(c, seed=6)
    w1, b1 = _t(c, 64, seed=7, scale=0.2), _t(64, seed=8)
    w2, b2 = _t(64, c, seed=9, scale=0.2), _t(c, seed=10)
    bias = torch.log(torch.arange(1, 6, dtype=torch.float32)).repeat(2, 1)
    attn = (x, *ln, wqkv, bqkv, wproj, bproj)
    mlp = (x, *ln, w1, b1, w2, b2)
    (qq, sq), (qp, sp) = map(q8.quantize_weight, (wqkv, wproj))
    (q1, s1), (q2, s2) = map(q8.quantize_weight, (w1, w2))
    attn8 = (x, *ln, qq, sq, bqkv, qp, sp, bproj)
    mlp8 = (x, *ln, q1, s1, b1, q2, s2, b2)
    inv = torch.tensor([30.0, 40.0])
    kt = (qq.t().contiguous(), qp.t().contiguous())
    head = (_t(3, 24, seed=11), _t(24, 16, seed=12, scale=0.3),
            _t(16, seed=13), _t(16, 8, seed=14, scale=0.3), _t(8, seed=15),
            _t(8, 2, seed=16, scale=0.3), _t(2, seed=17))
    xb = _t(2, 4, 4, 8, seed=18)
    blk = (_t(8, 4, seed=19, scale=0.3), _t(4, seed=20),
           _t(36, 4, seed=21, scale=0.3), _t(4, seed=22),
           _t(4, 16, seed=23, scale=0.3), _t(16, seed=24),
           _t(8, 16, seed=25, scale=0.3), _t(16, seed=26))
    ident = (xb, *blk[:4], _t(4, 8, seed=27, scale=0.3), _t(8, seed=28),
             None, None)
    g = torch.Generator().manual_seed(29)
    kmajor = torch.randint(-127, 128, (16, 72), generator=g).to(torch.int8)
    act = torch.tensor(0.05)
    conv = (_t(2, 6, 6, 8, seed=30), kmajor, act * _t(16, seed=31).abs(),
            _t(16, seed=32), act, 3, 1, True, None, torch.float32)
    ops = torch.ops.dfu
    return {
        "attn_block": (ops.attn_block, (*attn, 2, None),
                       lambda: vb.attn_block_ref(*attn, 2)),
        "attn_block_bias": (ops.attn_block, (*attn, 2, bias),
                            lambda: vb.attn_block_ref(*attn, 2, bias)),
        "mlp_block": (ops.mlp_block, mlp, lambda: vb.mlp_block_ref(*mlp)),
        "fused_mlp": (ops.fused_mlp, head, lambda: fm.fused_mlp_ref(*head)),
        "qkv_attention_fwd": (
            ops.qkv_attention_fwd, (_t(2, 5, 48, seed=33), 2),
            lambda: at.qkv_attention_ref(_t(2, 5, 48, seed=33), 2)),
        "attn_block_q8": (ops.attn_block_q8, (*attn8, 2, bias, *kt),
                          lambda: q8.attn_block_q8_ref(*attn8, 2, bias)),
        "mlp_block_q8": (ops.mlp_block_q8, (*mlp8, 4, None, None),
                         lambda: q8.mlp_block_q8_ref(*mlp8, 4)),
        "attn_block_q8s": (ops.attn_block_q8s,
                           (*attn8, inv, 2, None, None, None),
                           lambda: q8.attn_block_q8s_ref(*attn8, inv, 2)),
        "mlp_block_q8s": (ops.mlp_block_q8s, (*mlp8, inv, 4, None, None),
                          lambda: q8.mlp_block_q8s_ref(*mlp8, inv, 4)),
        "fused_bottleneck": (ops.fused_bottleneck, ident,
                             lambda: rb.bottleneck_ref(*ident)),
        "fused_bottleneck_proj": (
            ops.fused_bottleneck, (xb, *blk),
            lambda: rb.bottleneck_ref(xb, *blk)),
        "conv_q8": (ops.conv_q8, conv, lambda: cq.conv_q8_ref(*conv)),
        "quantize_act_q8": (ops.quantize_act_q8, (xb, act),
                            lambda: cq.quantize_act(xb, act)),
    }


OP_CASES = sorted(_op_cases())


@pytest.mark.parametrize("case", OP_CASES)
def test_op_passes_opcheck_and_equals_its_plain_version(case):
    """Each ``dfu::`` op: its schema and fake implementation hold
    (``torch.library.opcheck``), and on the CPU it is its plain version,
    bit for bit."""
    op, args, plain = _op_cases()[case]
    torch.library.opcheck(op, args,
                          test_utils=("test_schema", "test_faketensor"))
    assert torch.equal(op(*args), plain())


def test_ops_dispatch_by_device_only():
    """The wrappers call their op: a CPU call counts no launch, a tensor
    on neither the CPU nor a CUDA device has no kernel."""
    op, args, plain = _op_cases()["attn_block"]
    assert torch.equal(vb.attn_block(*args), plain())
    assert vb.attn_block.launches == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cq.quantize_act_q8(*(a.to("meta") for a in
                             _op_cases()["quantize_act_q8"][1]))


# ------------------------------------------------------------- bundles


def _trainer(name, dtype="float32", seed=0, **kwargs):
    tr = Trainer(name, TrainConfig(compute_dtype=dtype), MODALITIES,
                 device="cpu", image_size=IMAGE, **kwargs)
    zoo.init_model(tr.module, torch.Generator().manual_seed(seed))
    return tr


def _batch(inputs, n, seed=0):
    rng = np.random.default_rng(seed)
    batch = {m: rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
             for m in inputs}
    batch["label"] = rng.integers(0, 2, n).astype(np.int64)
    batch["valid"] = np.array([1.0] * (n - 1) + [0.0], np.float32)
    return batch


def _program_ops(path):
    return _graph_ops(torch.export.load(path))


def _graph_ops(program):
    """(dfu:: op -> node count, aten op -> node count) of a program."""
    ops, aten = {}, {}
    for node in program.graph.nodes:
        target = str(node.target)
        for prefix, into in (("dfu.", ops), ("aten.", aten)):
            if target.startswith(prefix):
                name = target.split(".")[1]
                into[name] = into.get(name, 0) + 1
    return ops, aten


# the cut ResNet: one bottleneck a stage, 4·512 = 2048 features
CUT_RESNET = ((1, 1, 1, 1), (8, 8, 8, 512))


@contextlib.contextmanager
def _cut_multimodal():
    """``multimodal`` built with its depth cut (the module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fusion, "ResNet50", lambda dtype, block_impl="auto":
                   ResNet(*CUT_RESNET, dtype=dtype, block_impl=block_impl))
        mp.setattr(fusion, "ViTBase16",
                   lambda **kw: port_vit.ViT(depth=1, **kw))
        mp.setattr(port_q8, "Int8ResNet50", lambda dtype:
                   port_q8.Int8ResNet(*CUT_RESNET, dtype=dtype))
        yield


def _multimodal(**kwargs):
    with _cut_multimodal():
        return Trainer("multimodal", TrainConfig(compute_dtype="float32"),
                       MODALITIES, device="cpu", image_size=IMAGE, **kwargs)


@pytest.fixture(scope="module")
def multimodal(tmp_path_factory):
    """The cut multimodal at 32² (fused ViT block, K3 head, the stride-1
    bottleneck on K11, fp32; the layers' own seeded initialisation) and
    its bundle at bucket 2."""
    torch.manual_seed(0)
    tr = _multimodal(rgb_impl="fused")
    out = tmp_path_factory.mktemp("export") / "multimodal"
    meta = ex.export_bundle(tr, out, image_size=IMAGE, buckets=[2])
    return tr, out, meta


@pytest.fixture(scope="module")
def servable(multimodal):
    servable = ex.load_bundle(multimodal[1], "cpu")
    servable.warmup_programs()
    return servable


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    """A thermal_only at the tiny ViT's widths (fused blocks) and its
    bundle at bucket 2."""
    tr = _trainer("thermal_only", **TINY)
    out = tmp_path_factory.mktemp("export") / "thermal_only"
    ex.export_bundle(tr, out, image_size=IMAGE, buckets=[2])
    return tr, out


def test_multimodal_program_holds_the_kernel_ops(multimodal, servable):
    """The multimodal program calls K1, K2, K3 and K11 (the stride-1
    bottleneck) as ``dfu::`` nodes; none of their plain versions' ops is
    in it: one softmax (the probabilities), no GELU, and convs only for
    the stem and the three strided blocks."""
    meta = multimodal[2]
    ops, aten = _graph_ops(servable.program(2))
    assert ops == {"attn_block": 1, "mlp_block": 1, "fused_mlp": 1,
                   "fused_bottleneck": 1}
    assert aten.get("softmax") == 1 and "gelu" not in aten
    assert aten.get("conv2d") == 1 + 3 * 4
    assert meta["model"] == "multimodal"
    assert meta["inputs"] == ["rgb", "thermal"]


def test_thermal_only_program_holds_the_block_ops(tiny_bundle):
    """thermal_only on the fused blocks: K1 and K2 as ``dfu::`` nodes, no
    GELU; the bundle's rows equal its eval step's."""
    tr, out = tiny_bundle
    servable = ex.load_bundle(out, "cpu")
    ops, aten = _graph_ops(servable.program(2))
    assert ops == {"attn_block": 2, "mlp_block": 2} and "gelu" not in aten
    batch = _batch(tr.spec.inputs, 2, seed=6)
    frozen, live = servable.eval_step(batch), tr.eval_step(batch)
    for k in live:
        assert torch.equal(frozen[k], live[k]), k


def test_int8_program_holds_the_int8_ops(multimodal, tmp_path):
    """An int8 multimodal on the static int8 blocks (K8) and the int8
    trunk (``conv_q8``, the projection blocks' ``quantize_act_q8``) with
    the K3 head."""
    base = multimodal[0]
    calib = torch.from_numpy(_batch(("rgb",), 2, seed=5)["rgb"])
    rgb, thermal = base._preprocess_eval({"rgb": calib,
                                          "thermal": calib})
    state = port_vit.quantize_variables(base.variables(),
                                        calib_batches=[thermal])
    state = quantize_rgb_trunks(state, [rgb], dtype=torch.float32)
    tr = _multimodal(block_impl="fused_q8s", rgb_impl="int8")
    tr.module.load_state_dict(state, strict=True)
    ex.export_bundle(tr, tmp_path, image_size=IMAGE, buckets=[2])
    ops, aten = _program_ops(tmp_path / "forward_b2.pt2")
    # four projection blocks: conv1..3 and the projection each
    assert ops == {"attn_block_q8s": 1, "mlp_block_q8s": 1,
                   "fused_mlp": 1, "conv_q8": 16, "quantize_act_q8": 4}
    assert "gelu" not in aten


def test_bundle_rows_equal_the_live_eval_step(multimodal, servable):
    """Every output of the bundle's program equals the trainer's eval
    step on the same batch (valid mask and labels included); without
    labels both give probabilities and predictions only."""
    tr = multimodal[0]
    batch = _batch(("rgb", "thermal"), 2, seed=1)
    frozen, live = servable.eval_step(batch), tr.eval_step(batch)
    assert set(frozen) == set(live) == {"probs", "preds", "loss", "counts"}
    for k in live:
        assert torch.equal(frozen[k], live[k]), k
    unlabelled = {m: batch[m] for m in ("rgb", "thermal")}
    frozen = servable.eval_step(unlabelled)
    assert set(frozen) == {"probs", "preds"}
    assert torch.equal(frozen["probs"], live["probs"])


def test_qat_trainer_bundle_freezes_its_snap(tmp_path):
    """A ``qat`` trainer's bundle runs its eval step's snap of the trunk
    weights to the int8 grids: every output equals that eval step's, and
    the probabilities differ from the unsnapped forward's."""
    tr = Trainer("thermal_only",
                 TrainConfig(compute_dtype="float32", qat=True),
                 MODALITIES, device="cpu", image_size=IMAGE, **TINY)
    zoo.init_model(tr.module, torch.Generator().manual_seed(8))
    ex.export_bundle(tr, tmp_path, image_size=IMAGE, buckets=[2])
    batch = _batch(tr.spec.inputs, 2, seed=8)
    frozen = ex.load_bundle(tmp_path, "cpu").eval_step(batch)
    live = tr.eval_step(batch)
    for k in live:
        assert torch.equal(frozen[k], live[k]), k
    tr.cfg = dataclasses.replace(tr.cfg, qat=False)
    assert not torch.equal(tr.eval_step(batch)["probs"], frozen["probs"])


@pytest.mark.parametrize("cli", ["serve", "predict", "export_model"])
def test_resnet_block_impl_is_one_flag_of_the_three_clis(cli):
    """``--resnet-block-impl fused`` reaches a ResNet-50 trunk the same
    way from serve, predict and export_model, so a live engine can run
    the trunk a bundle froze; the students and ViT models ignore it."""
    parser = {"serve": port_serve.build_parser,
              "predict": port_predict.build_parser,
              "export_model": export_model.build_parser}[cli]()
    required = {"serve": [], "predict": ["--checkpoint", "c", "--images",
                                         "i"],
                "export_model": ["--checkpoint", "c", "--out", "o"]}[cli]
    args = parser.parse_args(required + ["--resnet-block-impl", "fused"])
    kwargs = partial(port_serve.model_impl_kwargs, args=args)
    assert kwargs("rgb_only") == {"block_impl": "fused"}
    assert kwargs("multimodal") == {"attention_impl": "auto",
                                    "rgb_impl": "fused"}
    assert kwargs("resnet18_rgb") == {}
    assert kwargs("thermal_only") == {"attention_impl": "auto"}
    default = parser.parse_args(required)
    assert port_serve.model_impl_kwargs("rgb_only", default) == {}


def _copy_with_meta(src, dst, **changes):
    """A bundle at ``dst`` whose files link to ``src``'s, its manifest
    edited."""
    dst.mkdir()
    for f in src.iterdir():
        if f.name != ex.META_NAME:
            (dst / f.name).symlink_to(f)
    meta = {**json.loads((src / ex.META_NAME).read_text()), **changes}
    (dst / ex.META_NAME).write_text(json.dumps(meta))
    return dst


def test_bundle_rules(multimodal, servable, tiny_bundle, tmp_path):
    """The bucket ladder; a batch size with no program raises and names
    the buckets; an unknown format and a device type outside
    ``platforms`` are refused; the weights are written once (params.pt,
    read with weights_only) and no program carries one."""
    _, out, meta = multimodal
    assert ex.default_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    assert ex.default_buckets(6) == (1, 2, 4, 6)
    assert meta["buckets"] == [2] and meta["platforms"] == ["cpu"]
    assert meta["format_version"] == ex.FORMAT_VERSION
    assert meta["torch_version"] == torch.__version__
    assert meta["compute_dtype"] == "float32"
    with pytest.raises(KeyError, match=r"buckets are \[2\]"):
        servable.eval_step(_batch(("rgb", "thermal"), 3))
    with pytest.raises(ValueError, match="format"):
        ex.load_bundle(_copy_with_meta(out, tmp_path / "v9",
                                       format_version=9), "cpu")
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not for "
                                         "cpu"):
        ex.load_bundle(_copy_with_meta(out, tmp_path / "card",
                                       platforms=["cuda"]), "cpu")
    with pytest.raises(ValueError, match="unknown platforms"):
        ex.export_bundle(multimodal[0], tmp_path / "tpu", image_size=IMAGE,
                         buckets=[1], platforms=["tpu"])
    program = servable.program(2)
    assert not list(program.parameters())
    assert all(t.numel() <= 3 for t in program.buffers())
    small = torch.export.load(tiny_bundle[1] / "forward_b2.pt2")
    assert small.state_dict == {} and small.example_inputs is None
    params = torch.load(out / ex.PARAMS_NAME, weights_only=True)
    assert params.keys() == ex.serving_state(multimodal[0].module).keys()
    assert (out / "forward_b2.pt2").stat().st_size < 2e7


def test_serving_engine_on_a_bundle(multimodal, servable):
    """``ServingEngine(servable, buckets=servable.buckets)``: answers equal
    to the live eval step's, batches padded to the bundle's bucket."""
    tr = multimodal[0]
    batch = _batch(("rgb", "thermal"), 2, seed=2)
    samples = [{m: batch[m][i] for m in ("rgb", "thermal")} for i in (0, 1)]
    engine = ServingEngine(servable, image_size=IMAGE,
                           buckets=servable.buckets, max_wait_ms=100.0)
    assert engine.buckets == (2,) and engine.max_batch == 2
    with engine:
        got = engine.predict(samples) + engine.predict(samples[:1])
    live = tr.eval_step(batch)
    np.testing.assert_array_equal([p for p, _ in got[:2]],
                                  live["probs"].numpy())
    assert [c for _, c in got[:2]] == live["preds"].tolist()
    assert engine.stats()["batch_size_hist"] == {1: 1, 2: 1}


# ------------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A thermal_only checkpoint the JAX package wrote (its tiny ViT, the
    trunk scope ``ViT_0``), and the JAX trainer holding it."""
    cfg = jax_config.TrainConfig(batch_size=4, compute_dtype="float32",
                                 mesh=jax_config.MeshConfig(data=1))
    jt = JaxTrainer("thermal_only", cfg,
                    {"thermal": jax_config.thermal_modality()},
                    attention_impl="xla", block_impl="flax")
    jt.module = _TinyJaxViTClassifier()
    variables = _tiny_variables()
    directory = tmp_path_factory.mktemp("jax_ckpt")
    jax_ckpt.save_checkpoint(directory, epoch=1, model_state=variables,
                             opt_state=None, val_f1=0.5, history={},
                             extra_meta={"model": "thermal_only"})
    return directory, jt, variables


@pytest.fixture
def tiny_zoo(monkeypatch):
    """The port's thermal_only at the tiny ViT's widths, as the JAX
    trainer's module is swapped for it."""
    monkeypatch.setitem(zoo._REGISTRY, "thermal_only", zoo.ModelSpec(
        "thermal_only", partial(port_vit.ViTClassifier, **TINY),
        ("thermal",)))


def test_export_cli_on_a_jax_checkpoint_matches_jax(jax_checkpoint,
                                                    tiny_zoo, tmp_path,
                                                    capsys):
    """``export_model --verify --device cpu --platforms cpu`` on the JAX
    checkpoint: the bundle's rows against JAX's ``Trainer.eval_step`` on
    the same batch (1e-5, predictions equal)."""
    directory, jt, variables = jax_checkpoint
    out = tmp_path / "bundle"
    meta = export_model.main([
        "--checkpoint", str(directory), "--out", str(out), "--image-size",
        str(IMAGE), "--buckets", "1,4", "--compute-dtype", "float32",
        "--platforms", "cpu", "--device", "cpu", "--verify"])
    assert "verify: max |prob delta| 0.00e+00" in capsys.readouterr().out
    assert meta["int8"] is False and meta["token_merge"] is None
    assert meta["checkpoint"] == str(directory)
    batch = _batch(("thermal",), 4, seed=3)
    frozen = ex.load_bundle(out, "cpu").eval_step(batch)
    ref = jt.eval_step(variables, {k: np.asarray(v) if k != "label"
                                   else v.astype(np.int32)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(frozen["probs"].numpy(),
                               np.asarray(ref["probs"]), rtol=0,
                               atol=PROB_TOL)
    assert frozen["preds"].tolist() == np.asarray(ref["preds"]).tolist()


def test_export_cli_token_merge_bundle(jax_checkpoint, tiny_zoo, tmp_path):
    """A ``--token-merge --tome-prop-attn`` bundle (JAX
    ``test_export_cli_token_merge``): the manifest records the merge, the
    program calls the blocks as ops, and --verify held it to the live
    merged model."""
    directory = jax_checkpoint[0]
    out = tmp_path / "tome"
    meta = export_model.main([
        "--checkpoint", str(directory), "--out", str(out), "--image-size",
        str(IMAGE), "--buckets", "2", "--compute-dtype", "float32",
        "--device", "cpu", "--token-merge", "1:10", "--tome-prop-attn",
        "--verify"])
    assert meta["token_merge"] == "1:10" and meta["tome_prop_attn"] is True
    assert _program_ops(out / "forward_b2.pt2")[0] == {"attn_block": 2,
                                                       "mlp_block": 2}


def test_export_distilled_student_bundle(tmp_path):
    """The ResNet-18 student exports and replays behind the ServingEngine
    (JAX ``test_export_distilled_student_bundle``)."""
    tr = _trainer("resnet18_rgb", seed=4)
    meta = ex.export_bundle(tr, tmp_path, image_size=IMAGE, buckets=[2])
    assert meta["model"] == "resnet18_rgb"
    servable = ex.load_bundle(tmp_path, "cpu")
    batch = _batch(("rgb",), 2, seed=3)
    engine = ServingEngine(servable, image_size=IMAGE,
                           buckets=servable.buckets, max_wait_ms=100.0)
    with engine:
        got = engine.predict([{"rgb": img} for img in batch["rgb"]])
    live = tr.eval_step(batch)
    np.testing.assert_array_equal([p for p, _ in got], live["probs"].numpy())


def test_serve_cli_serves_a_bundle(tiny_bundle, capsys):
    """``serve --exported``: the bundle's engine at its buckets; a name
    served twice exits; ``--explain`` refuses a bundle."""
    out = tiny_bundle[1]
    server, router, _ = port_serve.build_daemon(
        ["--exported", str(out), "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--no-warmup", "--image-size", str(IMAGE)])
    try:
        engine = router.engines["thermal_only"]
        assert engine.buckets == (2,)
        assert isinstance(engine.trainer, ex.ExportedServable)
    finally:
        server.server_close()
        router.stop()
    assert "exported thermal_only, buckets [2]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="served twice"):
        port_serve.build_daemon(["--exported", str(out), "--exported",
                                 str(out), "--device", "cpu",
                                 "--no-warmup"])
    with pytest.raises(SystemExit, match="no model source"):
        port_serve.build_daemon(["--exported", str(out), "--explain",
                                 "--device", "cpu"])
