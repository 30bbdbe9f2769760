"""The port's token-merged ViT serving path (ToMe: bipartite merging and
proportional attention's key bias) against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's CPU tensors take the plain versions (the biased K1's tile
walk among them).  Inputs are made with numpy from a seed.  Widths are
small: C = 64, 2 to 4 heads, a depth-2 trunk at 32² with 8² patches (17
tokens), merged after block 1 down to 11 tokens, which the serving glue
also runs (the JAX thermal_only's trunk swapped for it); the multimodal
model runs at full width at 32² (5 tokens) on numpy-drawn weights.

Tolerances, each with its reason:

- ``bipartite_merge``: sizes bit-equal; tokens 1e-6 (rtol and atol, the
  JAX test's), the similarity product and the norms summed in another
  order (the duplicated tokens' exact ties merge in the same order);
- the biased attention block, fp32: 1e-5 (rtol and atol, the JAX test's)
  against JAX's ``_attn_block_ref`` and its Pallas K1; bf16 tile walk
  against the Pallas K1: 5e-2, tests/test_torch_vit_block_fwd.py's;
- the biased int8 attention blocks: 1e-3·(1+|ref|), tests/test_torch_q8.
  py's attention-block budget (JAX's own test allows 0.1);
- the token-merged ViT: 1e-5·(1+|ref|) for the flax blocks (the same
  math), and for the fused and int8 blocks with the Pallas kernels'
  logistic GELU swapped into the port (as tests/test_torch_q8.py does:
  the port's exact erf GELU is 3.8e-4 away, which moves the merge's
  inputs); ``keep = N`` bit-equal to no merge;
- serving probabilities: 1e-5, tests/test_torch_serve_explain.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_q8 as tq
from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.models import fusion as jax_fusion
from dfu_multimodal_tpu.models import vit as jax_vit
from dfu_multimodal_tpu.ops import token_merge as jax_tm
from dfu_multimodal_tpu.ops import vit_block as jax_vb
from dfu_multimodal_tpu.ops import vit_block_q8 as jax_q8
from dfu_multimodal_tpu.serve import engine as jax_engine
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.models import vit as port_vit
from dfu_multimodal_tpu_torch.models.fusion import MultimodalFusionClassifier
from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import token_merge as port_tm
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as port_q8
from dfu_multimodal_tpu_torch.serve.engine import (ServingEngine,
                                                   parse_token_merge,
                                                   quantize_for_serving,
                                                   tome_for_serving)
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    variables_to_state_dict, vit_params, vit_state_dict)
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

IMAGE = 32
VIT_KW = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
TOKENS = (IMAGE // VIT_KW["patch_size"]) ** 2 + 1          # 17
MERGE = (1, 11)                    # r = 6 of the 8 mergeable A-tokens
PROB_TOL = 1e-5


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = float((np.abs(out - ref) / (1.0 + np.abs(ref))).max())
    assert err <= tol, err


def _log_sizes(rng, b, n):
    """A (B, N) proportional-attention bias: log of token sizes 1..5."""
    return np.log(rng.integers(1, 6, (b, n))).astype(np.float32)


# ------------------------------------------------------------ the merge


def _tokens(b, n, c, seed, duplicates=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    if duplicates:        # a flat background: identical tokens, exact ties
        x[:, 9:n - 3] = x[:, 4:5]
    return x


# JAX's merge as one compiled program a shape (its eager ops compile one
# by one)
_jax_merge = jax.jit(jax_tm.bipartite_merge, static_argnums=2)


def _merge_both(x, sizes, r, dtype):
    jx, js = _jax_merge(jnp.asarray(x, dtype), jnp.asarray(sizes), r)
    px, ps = port_tm.bipartite_merge(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(sizes), r)
    assert px.dtype == getattr(torch, dtype) and ps.dtype == torch.float32
    return (jx, js), (px, ps)


@pytest.mark.parametrize("duplicates", [False, True],
                         ids=["distinct", "duplicates"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bipartite_merge_matches_jax(dtype, duplicates):
    x = _tokens(3, 33, 16, seed=11, duplicates=duplicates)
    sizes = np.ones((3, 33), np.float32)
    for r in (1, 7, 16):
        (jx, js), (px, ps) = _merge_both(x, sizes, r, dtype)
        assert px.shape == (3, 33 - r, 16)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_allclose(px.float().numpy(),
                                   np.asarray(jx, np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_two_merges_compose_as_jax():
    """A second merge of the first's output: the sizes of the patch
    tokens still sum to N - 1, and both merges equal JAX's."""
    x = _tokens(2, 33, 8, seed=3)
    sizes = np.ones((2, 33), np.float32)
    (jx, js), (px, ps) = _merge_both(x, sizes, 8, "float32")
    jx2, js2 = _jax_merge(jx, js, 4)
    px2, ps2 = port_tm.bipartite_merge(px, ps, 4)
    assert px2.shape == (2, 21, 8)
    np.testing.assert_array_equal(ps2[:, 1:].sum(1).numpy(), [32, 32])
    np.testing.assert_array_equal(ps2.numpy(), np.asarray(js2))
    np.testing.assert_allclose(px2.numpy(), np.asarray(jx2), rtol=1e-6,
                               atol=1e-6)


def test_merge_identity_and_refusal():
    x = torch.from_numpy(_tokens(1, 9, 8, seed=1))
    s = torch.ones(1, 9)
    x0, s0 = port_tm.bipartite_merge(x, s, 0)
    assert x0 is x and s0 is s
    with pytest.raises(ValueError, match="exceeds the 4 mergeable"):
        port_tm.bipartite_merge(x, s, 5)


# -------------------------------------------------- the biased blocks


def _block_arrays(b, n, c, seed):
    """x, g1, b1, wqkv, bqkv, wproj, bproj (numpy fp32) and a bias."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(
            np.float32)

    return (f(b, n, c), f(c, scale=0.1, offset=1.0), f(c, scale=0.1),
            f(c, 3 * c, scale=c ** -0.5), f(3 * c, scale=0.1),
            f(c, c, scale=c ** -0.5), f(c, scale=0.1)), _log_sizes(rng, b, n)


@pytest.mark.parametrize("n", [99, 128])
@pytest.mark.parametrize("heads", [4, 2], ids=["D16", "D32"])
def test_biased_attn_block_matches_jax(heads, n):
    """The plain version, the bf16 kernel's tile walk (in fp32) and the
    CPU dispatch of ``attn_block`` against JAX's ``_attn_block_ref`` and
    its Pallas K1 (interpret), each with the key bias; D = 32 scales the
    fp32 scores after the product (no power of two)."""
    arrays, bias = _block_arrays(2, n, 64, seed=n + heads)
    ts = [torch.from_numpy(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    tb, jb = torch.from_numpy(bias), jnp.asarray(bias)
    refs = (jax_vb._attn_block_ref(*js, num_heads=heads, bias=jb),
            jax_vb.attn_block(*js, num_heads=heads, interpret=True, bias=jb))
    outs = (vb.attn_block_ref(*ts, heads, bias=tb),
            vb._attn_block_tiled_ref(*ts, heads, bias=tb),
            vb.attn_block(*ts, heads, bias=tb))
    for out in outs:
        for ref in refs:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)
    assert float((outs[0] - vb.attn_block_ref(*ts, heads)).abs().max()) \
        > 1e-3                        # the bias moves the output


@pytest.mark.parametrize("defer", [False, True], ids=["normalised",
                                                      "deferred"])
def test_biased_two_pass_walk_matches_jax(defer):
    """``_attend_two_pass(bias=)``, both of the kernel's walks, against
    JAX's ``xla_attention`` with the bias, at N = 99 (a partial second
    tile) and D = 16, 32."""
    rng = np.random.default_rng(5)
    for d in (16, 32):
        q, k, v = (rng.standard_normal((2, 3, 99, d)).astype(np.float32)
                   for _ in range(3))
        bias = _log_sizes(rng, 2, 99)
        ref = jax_vit.xla_attention(*map(jnp.asarray, (q, k, v)),
                                    jnp.asarray(bias))
        out = at._attend_two_pass(*map(torch.from_numpy, (q, k, v)),
                                  defer=defer, bias=torch.from_numpy(bias))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_biased_tile_walk_bf16_matches_pallas():
    """The bf16 K1's algorithm with the bias (bf16 operands) against the
    Pallas K1 in bf16 (interpret) at N = 99."""
    arrays, bias = _block_arrays(2, 99, 64, seed=7)
    ts = [torch.from_numpy(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    for i in (0, 3, 5):               # x and the weights in bf16
        ts[i], js[i] = ts[i].bfloat16(), js[i].astype(jnp.bfloat16)
    out = vb._attn_block_tiled_ref(*ts, 4, bias=torch.from_numpy(bias))
    ref = jax_vb.attn_block(*js, num_heads=4, interpret=True,
                            bias=jnp.asarray(bias))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("n", [99, 128])
@pytest.mark.parametrize("static", [False, True], ids=["q8", "q8s"])
def test_biased_q8_attn_blocks_match_jax(static, n):
    rng = np.random.default_rng(20 + n)
    x, (g, b), (wqkv, sqkv, bqkv), (wproj, sproj, bproj), _, _ = \
        tq._block_inputs(seed=n)
    x = rng.standard_normal((tq.B, n, tq.C)).astype(np.float32)
    bias = _log_sizes(rng, tq.B, n)
    if static:
        args = (x, g, b, wqkv, sqkv * tq.ACT[0], bqkv, wproj,
                sproj * tq.ACT[1], bproj, np.float32(1.0) / tq.ACT)
        ref = jax_q8.attn_block_q8s(*map(jnp.asarray, args),
                                    num_heads=tq.HEADS, interpret=True,
                                    bias=jnp.asarray(bias))
        out = port_q8.attn_block_q8s(*map(tq._t, args), tq.HEADS,
                                     torch.from_numpy(bias))
        plain = port_q8.attn_block_q8s(*map(tq._t, args), tq.HEADS)
    else:
        args = (x, g, b, wqkv, sqkv, bqkv, wproj, sproj, bproj)
        ref = jax_q8.attn_block_q8(*map(jnp.asarray, args),
                                   num_heads=tq.HEADS, interpret=True,
                                   bias=jnp.asarray(bias))
        out = port_q8.attn_block_q8(*map(tq._t, args), tq.HEADS,
                                    torch.from_numpy(bias))
        plain = port_q8.attn_block_q8(*map(tq._t, args), tq.HEADS)
    _close(out.numpy(), ref, 1e-3)
    assert float((out - plain).abs().max()) > 1e-3


def test_biased_block_is_inference_only():
    """With the key bias, ``AttnBlock`` runs forward (also with grad
    enabled) and raises when a gradient is asked through it."""
    arrays, bias = _block_arrays(1, 9, 64, seed=9)
    ts = [torch.from_numpy(a).requires_grad_(i == 0)
          for i, a in enumerate(arrays)]
    out = vb.AttnBlock.apply(*ts, 4, torch.from_numpy(bias))
    np.testing.assert_array_equal(
        out.detach().numpy(),
        vb.attn_block_ref(*ts, 4, bias=torch.from_numpy(bias))
        .detach().numpy())
    with pytest.raises(RuntimeError, match="inference-only"):
        out.sum().backward()


# -------------------------------------------------------------- the ViT


@pytest.fixture(scope="module")
def trunk():
    """(the JAX trunk tree of each block family, a batch): the depth-2
    trunk at 32², every non-kernel leaf off its initial value; the int8
    trees quantised by JAX, the static one calibrated on two batches."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    flax = jax_vit.ViT(block_impl="flax", attention_impl="xla", **VIT_KW)
    params = tq._perturb(flax.init({"params": jax.random.PRNGKey(30)},
                                   jnp.asarray(x), train=False)["params"], 30)
    calib = [jnp.asarray(rng.standard_normal((3, IMAGE, IMAGE, 3)),
                         jnp.float32) for _ in range(2)]
    cal = jax_vit.calibrate_vit_absmax(params, calib,
                                       num_heads=VIT_KW["num_heads"])
    return {"flax": params, "fused": params,
            "fused_q8": jax_vit.quantize_encoder_params(params),
            "fused_q8s": jax_vit.quantize_encoder_params(params, cal)}, x


def _split(trunk_params, merge_at):
    return jax_vit.split_encoder_variables(
        {"params": {"trunk": trunk_params}}, merge_at)["params"]["trunk"]


def _port_vit(block_impl, state, **kw):
    vit = port_vit.ViT(image_size=IMAGE, block_impl=block_impl,
                       attention_impl="xla", **VIT_KW, **kw)
    vit.load_state_dict(state, strict=True)
    return vit.eval()


BLOCK_IMPLS = ["flax", "fused", "fused_q8", "fused_q8s"]


@pytest.mark.parametrize("prop", [False, True], ids=["plain", "prop_attn"])
@pytest.mark.parametrize("block_impl", BLOCK_IMPLS)
def test_token_merged_vit_matches_jax(trunk, block_impl, prop, monkeypatch):
    """The port's ViT with ``token_merge`` (and ``tome_prop_attn``) on
    the bridged split tree against the JAX ViT on
    ``split_encoder_variables``' tree."""
    if block_impl != "flax":
        monkeypatch.setattr(torch.nn.functional, "gelu", tq._logistic_gelu)
    trees, x = trunk
    split = _split(trees[block_impl], MERGE[0])
    jimpl = block_impl if block_impl == "flax" else f"{block_impl}_interpret"
    jvit = jax_vit.ViT(block_impl=jimpl, attention_impl="xla",
                       token_merge=MERGE, tome_prop_attn=prop, **VIT_KW)
    taps = {}
    ref = jvit.apply({"params": split}, jnp.asarray(x), train=False)
    vit = _port_vit(block_impl, vit_state_dict(split), token_merge=MERGE,
                    tome_prop_attn=prop)
    with torch.no_grad():
        out = vit(torch.from_numpy(x), taps=taps)
    assert out.shape == (2, VIT_KW["hidden_dim"])
    assert taps["blocks"].shape == (2, MERGE[1], VIT_KW["hidden_dim"])
    _close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize("block_impl", BLOCK_IMPLS)
def test_keep_all_tokens_is_bit_equal_to_no_merge(trunk, block_impl):
    """``keep = N`` merges nothing: the output is the unmerged model's bit
    for bit, with proportional attention too (its bias is log 1 = 0)."""
    trees, x = trunk
    state = vit_state_dict(trees[block_impl])
    with torch.no_grad():
        base = _port_vit(block_impl, state)(torch.from_numpy(x))
        for prop in (False, True):
            out = _port_vit(block_impl, state, token_merge=(1, TOKENS),
                            tome_prop_attn=prop)(torch.from_numpy(x))
            assert torch.equal(out, base), prop


def test_vit_refuses_bad_token_merge():
    for merge, msg in (((0, 9), r"merge_at must be in \(0, 2\)"),
                       ((2, 9), r"merge_at must be in \(0, 2\)"),
                       ((1, TOKENS + 1), "exceeds the 17 tokens")):
        with pytest.raises(ValueError, match=msg):
            port_vit.ViT(image_size=IMAGE, token_merge=merge, **VIT_KW)


def _draw(rng, path, leaf):
    """A numpy draw for one leaf of a JAX tree: BatchNorm variances in
    [1, 1.2), every other leaf N(0, 0.05²)."""
    x = 0.05 * rng.standard_normal(leaf.shape, np.float32)
    return 1.0 + np.abs(x) if str(path[-1].key) == "var" else x


def test_token_merged_multimodal_matches_jax():
    """The full-width multimodal model (ResNet-50 + ViT-B/16 at 32², 5
    tokens) with ``token_merge=(4, 4)`` and proportional attention, flax
    blocks, against JAX's on the same split weights, drawn with numpy
    into the JAX tree's shapes."""
    rng = np.random.default_rng(40)
    rgb, thermal = (jnp.asarray(rng.standard_normal((2, IMAGE, IMAGE, 3)),
                                jnp.float32) for _ in range(2))
    kw = dict(block_impl="flax", attention_impl="xla", token_merge=(4, 4),
              tome_prop_attn=True)
    jm = jax_fusion.MultimodalFusionClassifier(**kw)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, rgb, thermal, train=False))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(rng, p, leaf), shapes)
    assert "encoder2" in variables["params"]["thermal_branch"]
    ref = jax.jit(jm.apply, static_argnames="train")(
        variables, rgb, thermal, train=False)
    model = MultimodalFusionClassifier(image_size=IMAGE, **kw)
    model.load_state_dict(variables_to_state_dict("multimodal", variables),
                          strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(np.array(rgb)),
                           torch.from_numpy(np.array(thermal)))
    _close(out.numpy(), ref, 1e-5)


# ------------------------------------------------------------ the glue


def test_convert_jax_split_trees_both_ways(trunk):
    """A split tree (float and int8) bridges to the plain model's keys,
    and ``vit_params(..., merge_at)`` writes JAX's split tree back."""
    trees, _ = trunk
    for block_impl in ("fused", "fused_q8s"):
        tree = trees[block_impl]
        split = _split(tree, MERGE[0])
        state = vit_state_dict(split)
        plain = vit_state_dict(tree)
        assert state.keys() == plain.keys()
        for k, v in plain.items():
            assert torch.equal(state[k], v), k
        for merge_at, want in ((MERGE[0], split), (None, tree)):
            back = vit_params(state, merge_at=merge_at)
            flat = jax.tree_util.tree_leaves_with_path(want)
            got = dict(jax.tree_util.tree_leaves_with_path(back))
            assert len(got) == len(flat)
            for path, leaf in flat:
                np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                              err_msg=str(path))
                assert got[path].dtype == np.asarray(leaf).dtype
    with pytest.raises(ValueError, match="outside"):
        vit_params(state, merge_at=VIT_KW["depth"])


def test_tome_for_serving_engine_matches_jax(monkeypatch):
    """thermal_only with the depth-2 trunk (JAX's ``ViTBase16`` swapped
    for it) rebuilt by ``tome_for_serving`` (merge after block 1 down to
    11 tokens, proportional attention) behind the ServingEngine, against
    JAX's rebuild and engine on the same weights; composed after
    ``quantize_for_serving`` it keeps the int8 blocks and the merge."""
    monkeypatch.setattr(
        jax_vit, "ViTBase16",
        lambda dtype, attention_impl, block_impl, **kw: jax_vit.ViT(
            dtype=dtype, attention_impl=attention_impl,
            block_impl=block_impl, **kw, **VIT_KW))
    cfg = jax_config.TrainConfig(batch_size=4, eval_batch_size=4,
                                 compute_dtype="float32",
                                 mesh=jax_config.MeshConfig(data=1))
    jt = JaxTrainer("thermal_only", cfg,
                    {"thermal": jax_config.thermal_modality()})
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    pt = Trainer("thermal_only", port_config.TrainConfig(
        compute_dtype="float32"), {"thermal": port_config.thermal_modality()},
        device="cpu", image_size=IMAGE, block_impl="flax",
        attention_impl="xla", **VIT_KW)
    pt.module.load_state_dict(variables_to_state_dict(
        "thermal_only", jax.tree.map(np.asarray, jt.variables(state))))
    rng = np.random.default_rng(50)
    samples = [{"thermal": rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                        dtype=np.uint8)} for _ in range(5)]
    jtt, jst = jax_engine.tome_for_serving(jt, state, *MERGE,
                                           image_size=IMAGE, prop_attn=True)
    tt = tome_for_serving(pt, *MERGE, image_size=IMAGE, prop_attn=True)
    assert tt is not pt and tt.module.vit.token_merge == MERGE
    assert tt.module.vit.tome_prop_attn and pt.module.vit.token_merge is None
    answers = []
    for eng in (jax_engine.ServingEngine(jtt, jst, image_size=IMAGE,
                                         max_batch=8, max_wait_ms=500.0),
                ServingEngine(tt, image_size=IMAGE, max_batch=8,
                              max_wait_ms=500.0)):
        with eng:
            answers.append(eng.predict(samples))
    ref, ours = answers
    np.testing.assert_allclose([p for p, _ in ours], [p for p, _ in ref],
                               rtol=0, atol=PROB_TOL)
    assert [c for _, c in ours] == [c for _, c in ref]

    q = tome_for_serving(quantize_for_serving(pt, image_size=IMAGE), *MERGE,
                         image_size=IMAGE)
    vit = q.module.vit
    assert vit.token_merge == MERGE and not vit.tome_prop_attn
    assert all(type(b) is port_vit.QuantizedEncoderBlock
               for b in vit.blocks)
    probs = q.eval_step({"thermal": np.stack(
        [s["thermal"] for s in samples])})["probs"]
    assert bool(torch.isfinite(probs).all())


def test_trainer_and_cli_glue_refusals():
    cfg = port_config.TrainConfig(compute_dtype="float32")
    with pytest.raises(ValueError, match="ViT-trunk"):
        Trainer("rgb_only", cfg, {"rgb": port_config.rgb_modality()},
                device="cpu", token_merge=(2, 3))
    assert parse_token_merge("4:128") == (4, 128)
    for bad in ("4", "4:x", "4:128:1"):
        with pytest.raises(SystemExit, match=r"expects L:K \(e.g. 4:128\)"):
            parse_token_merge(bad)
