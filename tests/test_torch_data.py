"""The port's data path from disk against the JAX package's, on the CPU.

- The decoder (``native/``, ``data/png.py``) against JAX ``decode_raw``
  (libjpeg + PIL) bit for bit, on PIL-written JPEGs (4:2:0 q90, 4:4:4
  q95, grayscale, progressive; down-scaled, up-scaled, non-square) and
  8-bit PNGs (L, LA, RGB, RGBA, P with and without tRNS), with a ``None``
  placeholder row; each unsupported format raises naming the file.
- The encoder: a port-written JPEG decodes (by PIL) to the pixels of
  PIL's own q90 save of the same array.
- The card's decode fixture (``data/fixtures/``) regenerated with JAX.
- The data modules against JAX: layout scans, the three pairings, the
  leakage gate, the decode cache, the dataset loaders and
  ``get_dataloaders`` on a tree JAX's ``make_synthetic_dataset`` wrote,
  and ``make_image`` bit for bit.

The fixture is written by ``python tests/test_torch_data.py
--write-fixture`` (PIL writes the images, the JAX package decodes them).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

FIXTURES = (Path(__file__).resolve().parents[1] / "dfu_multimodal_tpu_torch"
            / "data" / "fixtures")
# (file, PIL mode, width, height, save kwargs); content is a crop of the
# synthetic generator's smooth images, so the GPU decoder's error on it
# is that of a photograph-like image, not of white noise
FIXTURE_SPECS = (
    ("rgb_420_q90.jpg", "RGB", 96, 72, {"quality": 90}),
    ("rgb_444_q95.jpg", "RGB", 80, 80, {"quality": 95, "subsampling": 0}),
    ("gray_q90.jpg", "L", 100, 64, {"quality": 90}),
    ("progressive_q90.jpg", "RGB", 90, 70,
     {"quality": 90, "progressive": True}),
    ("nonsquare_q85.jpg", "RGB", 120, 56, {"quality": 85}),
    ("l.png", "L", 72, 90, {}),
    ("la.png", "LA", 64, 100, {}),
    ("rgb.png", "RGB", 90, 60, {}),
    ("rgba.png", "RGBA", 60, 90, {}),
    ("p.png", "P", 88, 66, {}),
    ("p_trns.png", "P", 66, 88, {"transparency": 5}),
)
FIXTURE_SIZES = (48, 128)          # a down-scale and an up-scale of each


def _fixture_image(rng, mode, w, h):
    from PIL import Image

    from dfu_multimodal_tpu.data.synthetic import make_image

    base = make_image(rng, ("rgb", "thermal")[int(rng.integers(2))],
                      int(rng.integers(2)), 128)[:h, :w]
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    if mode == "L":
        return Image.fromarray(base[..., 0], "L")
    if mode == "LA":
        return Image.fromarray(np.concatenate([base[..., :1], alpha], -1),
                               "LA")
    if mode == "RGBA":
        return Image.fromarray(np.concatenate([base, alpha], -1), "RGBA")
    img = Image.fromarray(base, "RGB")
    return img.convert("P", palette=Image.ADAPTIVE) if mode == "P" else img


def write_fixture(out: Path = FIXTURES) -> None:
    """Write the fixture images with PIL and ``decode.npz``: the JAX
    package's ``decode_raw`` of each at FIXTURE_SIZES."""
    from dfu_multimodal_tpu.data.loader import decode_raw

    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(16)
    for name, mode, w, h, kw in FIXTURE_SPECS:
        _fixture_image(rng, mode, w, h).save(out / name, **kw)
    arrays = {f"{name}@{s}": decode_raw([out / name], s)[0]
              for name, *_ in FIXTURE_SPECS for s in FIXTURE_SIZES}
    np.savez_compressed(out / "decode.npz", **arrays)


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    write_fixture()
    sys.exit(0)


from PIL import Image  # noqa: E402

from dfu_multimodal_tpu.data import cache as jax_cache  # noqa: E402
from dfu_multimodal_tpu.data import layout as jax_layout  # noqa: E402
from dfu_multimodal_tpu.data import leakage as jax_leakage  # noqa: E402
from dfu_multimodal_tpu.data import loader as jax_loader  # noqa: E402
from dfu_multimodal_tpu.data import pairing as jax_pairing  # noqa: E402
from dfu_multimodal_tpu.data import synthetic as jax_synthetic  # noqa: E402
from dfu_multimodal_tpu_torch import native  # noqa: E402
from dfu_multimodal_tpu_torch.data import cache as port_cache  # noqa: E402
from dfu_multimodal_tpu_torch.data import layout as port_layout  # noqa: E402
from dfu_multimodal_tpu_torch.data import leakage as port_leakage  # noqa: E402
from dfu_multimodal_tpu_torch.data import loader as port_loader  # noqa: E402
from dfu_multimodal_tpu_torch.data import pairing as port_pairing  # noqa: E402
from dfu_multimodal_tpu_torch.data import synthetic as port_synthetic  # noqa: E402
from dfu_multimodal_tpu_torch.data.png import read_png  # noqa: E402

# (name, PIL mode, width, height, save kwargs): the decoder's cases
DECODE_CASES = (
    ("jpeg_420_q90", "RGB", 300, 200, {"quality": 90}),
    ("jpeg_444_q95", "RGB", 64, 64, {"quality": 95, "subsampling": 0}),
    ("jpeg_gray", "L", 120, 90, {"quality": 90}),
    ("jpeg_progressive", "RGB", 80, 60,
     {"quality": 90, "progressive": True}),
    ("jpeg_small_odd", "RGB", 17, 23, {"quality": 90}),
    ("png_l", "L", 50, 41, {}),
    ("png_la", "LA", 50, 41, {}),
    ("png_rgb", "RGB", 90, 33, {}),
    ("png_rgba", "RGBA", 33, 90, {}),
    ("png_p", "P", 70, 52, {}),
    ("png_p_trns", "P", 52, 70, {"transparency": 2}),
    ("png_p_4bit", "P16", 45, 37, {}),
)


def _case_image(rng, mode, w, h):
    """Noise over a gradient: every filter of PIL's PNG writer and every
    JPEG block type gets used."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(3 * x + y) % 256, (5 * y) % 256, (x * y) % 256], -1)
    rgb = (base + rng.integers(0, 40, base.shape)).clip(0, 255).astype(
        np.uint8)
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    if mode == "L":
        return Image.fromarray(rgb[..., 0], "L")
    if mode == "LA":
        return Image.fromarray(np.concatenate([rgb[..., :1], alpha], -1),
                               "LA")
    if mode == "RGBA":
        return Image.fromarray(np.concatenate([rgb, alpha], -1), "RGBA")
    img = Image.fromarray(rgb, "RGB")
    if mode == "P":
        return img.convert("P", palette=Image.ADAPTIVE)
    if mode == "P16":                    # PIL writes it at 4 bits a pixel
        return img.convert("P", palette=Image.ADAPTIVE, colors=12)
    return img


@pytest.fixture(scope="module")
def decode_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(0)
    out = {}
    for name, mode, w, h, kw in DECODE_CASES:
        path = root / (name + (".jpg" if name.startswith("jpeg") else
                               ".png"))
        _case_image(rng, mode, w, h).save(path, **kw)
        out[name] = path
    return out


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_decode_matches_jax_bit_exact(case, decode_files):
    """The port's decode_raw against the JAX package's (libjpeg for JPEG,
    PIL otherwise), bit for bit, at a down-scale (32) and an up-scale
    (224: every case is smaller), beside a None placeholder row."""
    path = decode_files[case]
    for size in (32, 224):
        ref = jax_loader.decode_raw([path, None], size)
        got = port_loader.decode_raw([path, None], size)
        np.testing.assert_array_equal(got, ref, err_msg=f"{case}@{size}")
        assert not got[1].any()
    np.testing.assert_array_equal(port_loader.load_image(path, 48),
                                  jax_loader.load_image(path, 48))


def _interlaced_png(path):
    """A PNG whose IHDR says Adam7 (PIL writes none)."""
    import struct
    import zlib
    data = bytearray(path.read_bytes())
    data[28] = 1                              # IHDR's interlace byte
    crc = zlib.crc32(bytes(data[12:29]))
    data[29:33] = struct.pack(">I", crc)
    return bytes(data)


@pytest.mark.parametrize("fmt", ["bmp", "tiff", "gif", "cmyk_jpeg",
                                 "png16", "interlaced_png", "corrupt_jpeg",
                                 "corrupt_png"])
def test_unsupported_formats_raise(fmt, tmp_path):
    """No PIL fallback: each file the port cannot decode raises a
    DecodeError that names the file (and what it is)."""
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8))
    path = tmp_path / f"x_{fmt}"
    word = fmt.split("_")[0]
    if fmt in ("bmp", "tiff", "gif"):
        img.save(path, format=fmt.upper() if fmt != "tiff" else "TIFF")
    elif fmt == "cmyk_jpeg":
        img.convert("CMYK").save(path, format="JPEG")
        word = "CMYK"
    elif fmt == "png16":
        Image.fromarray(rng.integers(0, 65535, (20, 30)).astype(
            np.uint16)).save(path, format="PNG")
        word = "16-bit"
    elif fmt == "interlaced_png":
        img.save(path, format="PNG")
        path.write_bytes(_interlaced_png(path))
        word = "interlaced"
    elif fmt == "corrupt_jpeg":
        img.save(path, format="JPEG")
        path.write_bytes(path.read_bytes()[:150])
        word = "corrupt"
    else:
        img.save(path, format="PNG")
        raw = bytearray(path.read_bytes())
        raw[-20] ^= 0xFF                      # inside the last IDAT
        path.write_bytes(bytes(raw))
        word = "CRC"
    with pytest.raises(port_loader.DecodeError) as err:
        port_loader.decode_raw([path], 32)
    assert str(path) in str(err.value) and word in str(err.value)


def test_encoder_matches_pil(tmp_path):
    """A port-written q90 JPEG decodes (by PIL) to the pixels of PIL's own
    ``save(quality=90)`` of the same array; on this route the two files
    are the same bytes."""
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate(((224, 224), (37, 53))):
        img = port_synthetic.make_image(rng, ("rgb", "thermal")[i], 1, 224)
        img = img[:h, :w].copy()
        ours, theirs = tmp_path / f"port{i}.jpg", tmp_path / f"pil{i}.jpg"
        native.encode_jpeg(img, ours, quality=90)
        Image.fromarray(img).save(theirs, quality=90)
        with Image.open(ours) as a, Image.open(theirs) as b:
            assert a.info.get("progressive") is None
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert ours.read_bytes() == theirs.read_bytes()


def test_fixture_matches_jax_decode():
    """The card's decode fixture: its .npz equals the JAX package's
    decode_raw of each file at each size, recomputed now, and the port's
    decode (libjpeg route) equals it too."""
    ref = np.load(FIXTURES / "decode.npz")
    assert sorted(ref.files) == sorted(
        f"{n}@{s}" for n, *_ in FIXTURE_SPECS for s in FIXTURE_SIZES)
    for name, *_ in FIXTURE_SPECS:
        for s in FIXTURE_SIZES:
            want = ref[f"{name}@{s}"]
            np.testing.assert_array_equal(
                jax_loader.decode_raw([FIXTURES / name], s)[0], want,
                err_msg=name)
            np.testing.assert_array_equal(
                port_loader.decode_raw([FIXTURES / name], s)[0], want,
                err_msg=name)
    size = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert size < 1 << 20


@pytest.mark.parametrize("modality", ["rgb", "thermal"])
@pytest.mark.parametrize("difficulty", ["easy", "hard"])
def test_make_image_bit_exact(modality, difficulty):
    for label in (0, 1):
        a = jax_synthetic.make_image(np.random.default_rng(3), modality,
                                     label, 40, difficulty)
        b = port_synthetic.make_image(np.random.default_rng(3), modality,
                                      label, 40, difficulty)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the trees


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same synthetic tree written by each package (JAX through PIL,
    the port through its encoder)."""
    root = tmp_path_factory.mktemp("trees")
    counts = {m: {"train": (5, 3), "val": (2, 2), "test": (1, 2)}
              for m in ("rgb", "thermal")}
    counts["thermal"]["train"] = (4, 6)
    jax_synthetic.make_synthetic_dataset(root / "jax", size=40, seed=4,
                                         counts=counts)
    port_synthetic.make_synthetic_dataset(root / "port", size=40, seed=4,
                                          counts=counts)
    return root / "jax", root / "port"


def _rel(paths, root):
    return [None if p is None else Path(p).relative_to(root) for p in paths]


def test_synthetic_tree_matches_jax(trees):
    jax_root, port_root = trees
    a = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*.jpg"))
    b = sorted(p.relative_to(port_root) for p in port_root.rglob("*.jpg"))
    assert a == b and len(a) == 2 * (8 + 4 + 3) + 2
    for rel in a:
        assert (jax_root / rel).read_bytes() == (port_root / rel).read_bytes()


def test_scan_and_statistics_match_jax(trees, capsys):
    _, root = trees
    for modality in ("rgb", "thermal"):
        for split in port_layout.SPLITS:
            a = jax_layout.scan_split(root / modality, split)
            b = port_layout.scan_split(root / modality, split)
            assert a.paths == b.paths and a.labels == b.labels
            assert a.class_counts == b.class_counts
            assert a.by_class() == b.by_class()
    assert (port_layout.dataset_statistics(root)
            == jax_layout.dataset_statistics(root))
    jax_layout.print_dataset_statistics(root)
    ref = capsys.readouterr().out
    port_layout.print_dataset_statistics(root)
    assert capsys.readouterr().out == ref
    (root / "rgb" / "train" / "healthy" / "notes.txt").write_text("x")
    assert (port_layout.list_images(root / "rgb")
            == jax_layout.list_images(root / "rgb"))


@pytest.mark.parametrize("strategy", ["aligned", "pseudo", "random"])
def test_pairings_match_jax(strategy):
    for rgb, th in (((5, 3), (4, 6)), ((0, 3), (4, 0)), ((2, 2), (2, 2))):
        for seed in (None, 0, 7) if strategy != "aligned" else (None,):
            kw = {} if strategy == "aligned" else {"seed": seed}
            if seed is None and strategy != "aligned":
                continue               # unseeded draws differ run to run
            a = getattr(jax_pairing, f"{strategy}_pairs")(rgb, th, **kw)
            b = getattr(port_pairing, f"{strategy}_pairs")(rgb, th, **kw)
            assert [(p.rgb, p.thermal, p.label) for p in a] == \
                [(p.rgb, p.thermal, p.label) for p in b]
            assert (port_pairing.pair_class_counts(b)
                    == jax_pairing.pair_class_counts(a))


def test_hashes_and_leakage_gate_match_jax(trees, tmp_path, capsys):
    _, root = trees
    paths = {s: port_layout.scan_split(root / "rgb", s).paths
             for s in port_layout.SPLITS}
    for s, p in paths.items():
        assert (port_leakage.hash_files(p + [None])
                == jax_leakage.hash_files(p + [None]))
    jax_leakage.check_split_leakage(paths, name="rgb")
    ref = capsys.readouterr().out
    port_leakage.check_split_leakage(paths, name="rgb")
    assert capsys.readouterr().out == ref
    leaky = dict(paths, test=paths["test"] + [paths["train"][0]])
    with pytest.raises(jax_leakage.LeakageError):
        jax_leakage.check_split_leakage(leaky, verbose=False)
    with pytest.raises(port_leakage.LeakageError, match="leakage"):
        port_leakage.check_split_leakage(leaky, verbose=False)
    missing = [tmp_path / "gone.jpg"]
    assert port_leakage.hash_files(missing) == set()
    with pytest.raises(port_leakage.LeakageError, match="could not be read"):
        port_leakage.hash_files(missing, strict=True)
    assert (port_leakage.compute_sha256(paths["val"][0])
            == jax_leakage.compute_sha256(paths["val"][0]))


def test_decode_cache_matches_jax(trees, tmp_path, monkeypatch):
    """cache_key equals JAX's; the cached block is a read-only memmap of
    JAX's decode_raw; a hit decodes nothing; an mtime change or a
    truncated block rebuilds; the file format is JAX's (its reader takes
    the port's entry as a hit)."""
    _, root = trees
    paths = port_layout.scan_split(root / "rgb", "train").paths
    paths = [paths[0], None] + paths[1:]
    assert port_cache.cache_key(paths, 32) == jax_cache.cache_key(paths, 32)
    cdir = tmp_path / "cache"
    block = port_cache.cached_decode(paths, 32, cdir, chunk=3)
    assert isinstance(block, np.memmap) and not block.flags.writeable
    got = np.array(block)                 # the file is rewritten below
    del block
    np.testing.assert_array_equal(got, jax_loader.decode_raw(paths, 32))

    def poisoned(*a, **k):
        raise AssertionError("cache miss on identical inputs")

    monkeypatch.setattr(port_loader, "decode_raw", poisoned)
    np.testing.assert_array_equal(
        np.asarray(port_cache.cached_decode(paths, 32, cdir)), got)
    monkeypatch.setattr(jax_loader, "decode_raw", poisoned)
    np.testing.assert_array_equal(
        np.asarray(jax_cache.cached_decode(paths, 32, cdir)), got)
    monkeypatch.undo()

    key = port_cache.cache_key(paths, 32)
    block = cdir / f"{key}.u8"
    block.write_bytes(block.read_bytes()[:-7])           # truncated entry
    np.testing.assert_array_equal(
        np.asarray(port_cache.cached_decode(paths, 32, cdir)), got)
    assert block.stat().st_size == got.size
    os.utime(paths[2], ns=(1, 1))
    assert port_cache.cache_key(paths, 32) != key
    assert not list(cdir.glob("*.tmp*"))
    monkeypatch.setenv("DFU_CACHE_DIR", str(tmp_path / "env"))
    assert port_cache.resolve_cache_dir() == tmp_path / "env"
    np.testing.assert_array_equal(port_loader.decode_all(paths, 32), got)
    assert list((tmp_path / "env").glob("*.json"))


def _same_dataset(a, b, a_root, b_root):
    assert a.modalities == b.modalities
    np.testing.assert_array_equal(a.labels, b.labels)
    for m in a.modalities:
        np.testing.assert_array_equal(np.asarray(a.arrays[m]),
                                      np.asarray(b.arrays[m]))
        assert _rel(a.paths[m], a_root) == _rel(b.paths[m], b_root)


def test_loaders_match_jax(trees):
    """load_single_modality and load_paired (each strategy) on the tree
    JAX wrote, against the JAX loaders on the same tree; then on the
    port-written tree, which gives the same arrays."""
    jax_root, port_root = trees
    for split in port_layout.SPLITS:
        for modality in ("rgb", "thermal"):
            ref = jax_loader.load_single_modality(jax_root / modality, split,
                                                  32, modality)
            for root in (jax_root, port_root):
                got = port_loader.load_single_modality(root / modality,
                                                       split, 32, modality)
                _same_dataset(got, ref, root, jax_root)
        for strategy in ("aligned", "pseudo", "random"):
            ref = jax_loader.load_paired(jax_root, split, 32, strategy, 3)
            got = port_loader.load_paired(port_root, split, 32, strategy, 3)
            _same_dataset(got, ref, port_root, jax_root)
    with pytest.raises(ValueError, match="unknown pairing"):
        port_loader.load_paired(port_root, "train", 32, "nearest")


@pytest.mark.parametrize("modality", ["both", "rgb"])
def test_get_dataloaders_matches_jax(modality, trees):
    jax_root, port_root = trees
    ref_ds, ref_batches = jax_loader.get_dataloaders(
        jax_root, batch_size=4, image_size=32, strategy="pseudo", seed=5,
        modality=modality)
    ds, make_batches = port_loader.get_dataloaders(
        port_root, batch_size=4, image_size=32, strategy="pseudo", seed=5,
        modality=modality)
    for split in port_layout.SPLITS:
        _same_dataset(ds[split], ref_ds[split], port_root, jax_root)
        for _ in range(2):                   # two epochs of the stream
            for a, b in zip(make_batches(split), ref_batches(split),
                            strict=True):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="Unknown modality"):
        port_loader.get_dataloaders(port_root, modality="depth")


def _png_with_every_filter(path, pixels, colour):
    """Write ``pixels`` (H, W, C) uint8 as an 8-bit PNG whose rows cycle
    through the five filter types (PIL's writer never uses Average)."""
    import struct
    import zlib
    h, w, c = pixels.shape
    rows, prior = [], np.zeros(w * c, np.int32)
    for y in range(h):
        x = pixels[y].reshape(-1).astype(np.int32)
        a = np.r_[np.zeros(c, np.int32), x[:-c]]
        up = prior
        ul = np.r_[np.zeros(c, np.int32), prior[:-c]]
        ftype = y % 5
        if ftype == 4:
            pa, pb, pc = abs(up - ul), abs(a - ul), abs(a + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, ul))
        else:
            pred = (0 * x, a, up, (a + up) // 2)[ftype]
        rows.append(bytes([ftype]) + ((x - pred) % 256).astype(
            np.uint8).tobytes())
        prior = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                  colour, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,channels", [(0, 1), (2, 3), (4, 2),
                                             (6, 4)],
                         ids=["L", "RGB", "LA", "RGBA"])
def test_png_every_filter_matches_pil(colour, channels, tmp_path):
    """The port's PNG reader undoes all five filters (Paeth with PIL's
    tie order) as PIL reads them."""
    rng = np.random.default_rng(6)
    pixels = rng.integers(0, 256, (11, 13, channels), np.uint8)
    pixels[3:6] = pixels[2]                    # ties for Paeth
    path = tmp_path / "filters.png"
    _png_with_every_filter(path, pixels, colour)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(read_png(path), ref)
