"""The port's whole-stage ResNet kernel (K12, ``fused_stage``) against the
JAX package's, on the CPU.

The JAX side runs its Pallas stage kernel in interpret mode
(``interpret=True``, ``block_impl="fused_interpret"``), as its own tests
do (tests/test_ops.py); the port's CPU tensors take the plain version
``stage_ref``.  Inputs are made with numpy from a seed, at JAX's own test
size (H = W = 6, C = 32, Cmid = 8, 3 blocks).

Tolerances, each with its reason (``python -m pytest
tests/test_torch_resnet_stage.py -s`` prints every measured error):

- stage, fp32: 2e-5 (JAX's own stage-vs-oracle budget): the same math,
  summed in another order;
- stage, bf16: 2e-2·(1+|ref|): the same roundings, but an fp32 sum taken
  in another order may land one bf16 step apart before it is rounded,
  and the step carries into the next block;
- gradients (remat through the plain version vs ``jax.grad`` of the
  interpret kernel): 5e-5 for x, 1e-4 for the weights (JAX's budgets);
- tiny trunk with its identity tails on ``fused_stage`` vs JAX
  ``fused_interpret``: 2e-4 (JAX's trunk budget);
- folded weights vs JAX's folding: 1e-6 (fp32, one product and one
  rsqrt each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfu_multimodal_tpu.models.resnet import ResNet as JaxResNet
from dfu_multimodal_tpu.ops import resnet_block as jax_rb
from dfu_multimodal_tpu_torch.models.resnet import ResNet
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
from dfu_multimodal_tpu_torch.tools.convert_jax import resnet_state_dict

torch.set_num_threads(1)

B, HW, C, CMID, NBLOCKS = 2, 6, 32, 8, 3
TINY = dict(stage_sizes=(3, 3), widths=(8, 16))
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _stage_args(seed, cmids=(CMID,) * NBLOCKS):
    """x (B, H, W, C) and each block's folded (w1, b1, w2, b2, w3, b3) as
    numpy fp32."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x = f32(B, HW, HW, C)
    blocks = [(f32(C, m, scale=C ** -0.5), f32(m, scale=0.1),
               f32(9 * m, m, scale=(9 * m) ** -0.5), f32(m, scale=0.1),
               f32(m, C, scale=m ** -0.5), f32(C, scale=0.1))
              for m in cmids]
    return x, blocks


def _to_torch(x, blocks, dtype):
    """Weights (even positions) and x in the compute dtype, biases fp32."""
    return (torch.from_numpy(x).to(dtype),
            [tuple(torch.from_numpy(a).to(dtype if i % 2 == 0
                                          else torch.float32)
                   for i, a in enumerate(blk)) for blk in blocks])


def _to_jax(x, blocks, dtype):
    return (jnp.asarray(x, dtype),
            tuple(tuple(jnp.asarray(a, dtype if i % 2 == 0 else jnp.float32)
                        for i, a in enumerate(blk)) for blk in blocks))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_stage_matches_pallas_interpret_and_oracle(dtype, tol):
    x, blocks = _stage_args(20)
    xt, bt = _to_torch(x, blocks, dtype)
    out = rb.fused_stage(xt, bt)
    xj, bj = _to_jax(x, blocks, JAX_DTYPES[dtype])
    refs = {"interpret": jax_rb.fused_stage(xj, bj, interpret=True),
            "_stage_ref": jax_rb._stage_ref(xj, bj)}
    assert out.dtype == dtype and out.shape == (B, HW, HW, C)
    got = out.float().numpy()
    for name, ref in refs.items():
        ref = np.asarray(ref, np.float32)
        err = float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))
        print(f"\nstage {dtype} vs JAX {name}: max|d|/(1+|ref|) = "
              f"{err:.3e} (tol {tol:g})")
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_equals_the_chain_of_bottlenecks(dtype):
    """The stage is the chain of fused_bottleneck calls over the same
    blocks, bit for bit, also with a Cmid per block."""
    x, blocks = _stage_args(21, cmids=(8, 16, 4))
    xt, bt = _to_torch(x, blocks, dtype)
    chain = xt
    for blk in bt:
        chain = rb.fused_bottleneck(chain, *blk)
    assert torch.equal(rb.fused_stage(xt, bt), chain)


def test_stage_gradients_match_jax():
    """FusedStage's remat backward against jax.grad through the JAX custom
    VJP of the interpret kernel, for x and every block weight."""
    x, blocks = _stage_args(22)
    xt, bt = _to_torch(x, blocks, torch.float32)
    leaves = [xt.requires_grad_()] + [t.requires_grad_()
                                      for t in rb.FusedStage.flat(bt)]
    out = rb.FusedStage.apply(*leaves)
    (out ** 2).sum().backward()

    xj, bj = _to_jax(x, blocks, jnp.float32)
    gx, gb = jax.jit(jax.grad(
        lambda x, bw: jnp.sum(jax_rb.fused_stage(x, bw, interpret=True) ** 2),
        argnums=(0, 1)))(xj, bj)
    refs = [gx] + [g for blk in gb for g in blk]
    assert len(refs) == len(leaves) == 1 + 6 * NBLOCKS
    for i, (t, ref) in enumerate(zip(leaves, refs)):
        tol = 5e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol, err_msg=f"leaf {i}")


# ---------------------------------------------------------------- trunks


def _tiny_variables(seed, x):
    """Variables of the JAX trunk, drawn with numpy: LeCun-scaled conv
    kernels and every BatchNorm vector off its initial value (variances
    positive), so folding is exercised."""
    shapes = jax.eval_shape(
        lambda x: JaxResNet(block_impl="flax", **TINY).init(
            {"params": jax.random.PRNGKey(0)}, x, train=False), x)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            t = rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5
        elif name == "var":
            t = rng.uniform(0.5, 1.5, s.shape)
        else:                                   # scale, bias, mean
            t = (name == "scale") + 0.05 * rng.standard_normal(s.shape)
        return t.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny_trunk():
    """A 2-stage trunk with two identity blocks after each stage's first:
    the input, the port's trunk, and JAX's fused_interpret output on the
    same weights with the folded tuples its FusedBottleneck handed the
    kernel (stride-1 blocks, in trunk order)."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = _tiny_variables(23, x)
    net = ResNet(block_impl="flax", **TINY).eval()
    net.load_state_dict(resnet_state_dict(variables["params"],
                                          variables["batch_stats"]),
                        strict=True)
    seen, kernel = [], jax_rb.fused_bottleneck

    def capture(x, *weights, interpret=False):
        seen.append(weights)
        return kernel(x, *weights, interpret=interpret)

    def run(v, x):
        seen.clear()
        out = JaxResNet(block_impl="fused_interpret", **TINY).apply(
            v, x, train=False)
        return out, list(seen)

    jax_rb.fused_bottleneck = capture
    try:
        ref, folds = jax.jit(run)(variables, jnp.asarray(x))
    finally:
        jax_rb.fused_bottleneck = kernel
    return x, net, np.asarray(ref), [[np.asarray(w) for w in f]
                                     for f in folds]


@torch.no_grad()
def _trunk_with_stage_tails(net, x):
    """The port's trunk with each stage's identity tail on fused_stage
    (fed the blocks' folded_weights) and its first block as the model
    runs it with block_impl="fused"."""
    h = x.permute(0, 3, 1, 2)                      # channels-last NCHW
    h = F.max_pool2d(F.relu(net.bn1(net.conv1(h))), 3, stride=2, padding=1)
    for i in range(1, net.num_stages + 1):
        first, *tail = getattr(net, f"layer{i}")
        h = first.forward_fused(h) if first.stride == 1 else first(h)
        h = rb.fused_stage(h.permute(0, 2, 3, 1),
                           [blk.folded_weights(h.dtype) for blk in tail])
        h = h.permute(0, 3, 1, 2)
    return h.mean(dim=(2, 3))


def test_tiny_trunk_on_stage_kernel_matches_jax_fused_interpret(tiny_trunk):
    x, net, ref, _ = tiny_trunk
    got = _trunk_with_stage_tails(net, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 64)
    print(f"\ntiny trunk, stage tails on fused_stage vs JAX fused_interpret: "
          f"{np.abs(got - ref).max():.3e} (tol 2e-4)")
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_folded_weights_match_jax_folding(tiny_trunk):
    """Bottleneck.folded_weights against the tuples JAX's FusedBottleneck
    hands its kernel, for every stride-1 block (stage 1's projection block
    and the identity blocks), in trunk order."""
    _, net, _, folds = tiny_trunk
    ours = [blk.folded_weights(torch.float32)
            for i in range(1, net.num_stages + 1)
            for blk in getattr(net, f"layer{i}") if blk.stride == 1]
    assert [len(w) for w in ours] == [len(w) for w in folds] == [8, 6, 6, 6,
                                                                 6]
    for k, (mine, theirs) in enumerate(zip(ours, folds)):
        for i, (a, b) in enumerate(zip(mine, theirs)):
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6,
                                       atol=1e-6, err_msg=f"block {k} #{i}")


# ------------------------------------------------------------ validation


def _bad_blocks(case):
    x, blocks = _to_torch(*_stage_args(24), torch.float32)
    if case == "empty":
        return x, []
    if case == "projection":
        return x, [blocks[0] + (torch.zeros(C, C), torch.zeros(C))]
    if case == "mismatched C":
        return x[..., :16].contiguous(), blocks
    if case == "w2 shape":
        w1, b1, w2, b2, w3, b3 = blocks[1]
        return x, [blocks[0], (w1, b1, w2[:8 * CMID], b2, w3, b3)]
    assert case == "meta device"
    return (x.to("meta"),
            [tuple(t.to("meta") for t in blk) for blk in blocks])


@pytest.mark.parametrize("case,match", [
    ("empty", "blocks is empty"),
    ("projection", "identity blocks only"),
    ("mismatched C", "block 0 of x"),
    ("w2 shape", "block 1 of x"),
    ("meta device", "no kernel for device meta")])
def test_stage_refuses_bad_operands(case, match):
    """Shapes are checked on every device; a tensor on no CPU takes no
    plain version: the kernel or an error."""
    x, blocks = _bad_blocks(case)
    with pytest.raises(ValueError, match=match):
        rb.fused_stage(x, blocks)


# --------------------------------------------- the bf16 kernel's schedule
#
# The bf16 stage kernel (csrc/resnet_block.cu::stage_kernel) walks, in each
# phase, the output tiles of one product on gemm_sm90.cuh's tile body:
# block i of a grid of G takes tiles i, i + G, ... (row-major over the
# tile grid), at one tile shape per launch, rb._stage_tile (the card's
# dfu_stage_tile is held to it in tests/test_torch_cuda.py).

SMS = 132                                     # an H100's SMs
# ResNet-50's stride-1 stage tails: (H = W, C, Cmid, blocks)
STAGE_TAILS = [(56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
               (7, 2048, 512, 2)]
# the shape K11's launcher takes for each tail's 3x3 (n = Cmid, k =
# 9·Cmid) at batch 8 and 128: 64 x 64 where 128 x 64 tiles leave SMs idle,
# else 128 rows at pick_bn's width
K11_3X3_TILE = {8: [(128, 64), (64, 64), (64, 64), (64, 64)],
                128: [(128, 64), (128, 128), (128, 128), (128, 128)]}


@pytest.mark.parametrize("batch", [8, 128])
def test_stage_tile_is_k11s_for_its_3x3(batch):
    got = [rb._stage_tile(batch * hw * hw, cmid, SMS)
           for hw, _, cmid, _ in STAGE_TAILS]
    assert got == K11_3X3_TILE[batch]


def _phase_tiles(rows, n, tile, grid):
    """Each block's (m0, n0) origins in one phase: block i takes tiles i,
    i + grid, ... of the (ceil(rows / RM), ceil(n / BN)) tile grid."""
    rm, bn = tile
    n_tiles = -(-n // bn)
    tiles = -(-rows // rm) * n_tiles
    return [[(t // n_tiles * rm, t % n_tiles * bn)
             for t in range(i, tiles, grid)] for i in range(grid)]


@pytest.mark.parametrize("grid", [1, 7, 132, 264])
@pytest.mark.parametrize("batch,tail", [(8, t) for t in STAGE_TAILS]
                         + [(128, STAGE_TAILS[3]), (3, (5, 40, 24, 3))])
def test_stage_schedule_computes_every_tile_once(batch, tail, grid):
    """Every output tile of every phase (conv1 and the 3x3: Cmid columns;
    conv3: C columns) is computed by exactly one block of the grid, and
    the tiles tile the (rows, columns) output without overlap."""
    hw, c, cmid, nblocks = tail
    rows = batch * hw * hw
    tile = rb._stage_tile(rows, cmid, SMS)
    for n in [cmid, cmid, c] * nblocks:
        origins = [o for blk in _phase_tiles(rows, n, tile, grid) for o in blk]
        assert len(origins) == len(set(origins))
        covered = np.zeros((-(-rows // tile[0]) * tile[0],
                            -(-n // tile[1]) * tile[1]), np.int32)
        for m0, n0 in origins:
            covered[m0:m0 + tile[0], n0:n0 + tile[1]] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_stage_of_the_walk_matches_pallas_interpret(dtype, tol):
    """The stage as the bf16 kernel computes it, each block the K11 tile
    walk of tests/test_torch_bottleneck_gemm.py (the 3x3's A as the card
    builds it, 16-deep k steps), against the JAX fused_stage in interpret
    mode, at the tolerances of test_stage_matches_pallas_interpret_and_
    oracle."""
    from test_torch_bottleneck_gemm import _walk_bottleneck
    x, blocks = _stage_args(25)
    xt, bt = _to_torch(x, blocks, dtype)
    h = xt
    for blk in bt:
        h = _walk_bottleneck(h, *blk)
    xj, bj = _to_jax(x, blocks, JAX_DTYPES[dtype])
    ref = np.asarray(jax_rb.fused_stage(xj, bj, interpret=True), np.float32)
    got = h.float().numpy()
    err = float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))
    print(f"\nwalked stage {dtype} vs JAX interpret: {err:.3e} (tol {tol:g})")
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
