"""The port's data layer (qflux_tpu_torch/data/*.py, utils/hashing.py)
against the JAX package's, on the CPU: the same files and caches, written
under tmp_path from a seed, go through both packages and must give equal
results, exactly: content hashes (md5 and the streamed XXH64 that keys
files of 64 MiB and more), caches written by either package and loaded by
the other, the dataset's samples and file hashes over a folder and over
CSV files, its cached items with conditioning dropout over three visits,
the resolution policy, `collate`, and the DataLoader's batches over two
epochs (shape buckets on and off, 0 and 3 worker threads, drop_last on and
off).  Then what the port refuses: a sample missing from the cache and an
HF Hub dataset name ROADMAP.md queue 1 item 5b.
"""

from __future__ import annotations

import re
import threading
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from qflux_tpu.data import cache as jcache
from qflux_tpu.data import collate as jcollate
from qflux_tpu.data import dataset as jdataset
from qflux_tpu.data import loader as jloader
from qflux_tpu.data import preprocess as jpre
from qflux_tpu.runtime import native as jnative
from qflux_tpu.utils import hashing as jhashing
from qflux_tpu_torch.data import cache as tcache
from qflux_tpu_torch.data import collate as tcollate
from qflux_tpu_torch.data import dataset as tdataset
from qflux_tpu_torch.data import loader as tloader
from qflux_tpu_torch.data import preprocess as tpre
from qflux_tpu_torch.models.flux.transformer import FluxConfig
from qflux_tpu_torch.utils import hashing as thashing

ITEM_5 = "queue 1 item 5b"
TINY = FluxConfig.tiny()
# seven samples in two latent shapes: 16 tokens (4×4) and 24 (6×4 and 4×6)
GRIDS = [(4, 4), (6, 4), (4, 4), (4, 6), (6, 4), (4, 4), (4, 6)]


def _cached_folder(root: Path, grids=GRIDS, seed=0):
    """A folder dataset of len(grids) samples with their tiny FLUX
    embeddings in the port's cache (chip_smoke.write_cached_dataset)."""
    rng = np.random.default_rng(seed)
    items = [chip_smoke.flux_cache_item(rng, TINY, gh, gw, s_txt=8) for gh, gw in grids]
    return chip_smoke.write_cached_dataset(root, items, chip_smoke.FLUX_HASH_KEYS, seed)


def assert_same(a, b, where="batch"):
    """Equal nested values: arrays by dtype, shape and value; dicts, lists
    and scalars by value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


# ---------------------------------------------------------------------------
# hashing

def test_hashes_match_jax(tmp_path):
    """md5 / sha256 of files and strings, combine_hashes, and XXH64 over
    bytes (every tail length, chunks split anywhere) and files against the
    JAX package's (its native library where it builds, its Python
    fallback otherwise)."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 100, 1000):
        want = jnative._xxh64_py(data[:n])
        assert thashing.xxh64_stream([data[:n]]) == want, n
        assert thashing.xxh64_stream([data[:n], b""]) == want, n
    for cuts in ([5, 40, 41, 300], [32, 64], [1] * 40, [999]):
        pieces = [data[a:b] for a, b in zip([0] + cuts, cuts + [1000])]
        assert thashing.xxh64_stream(pieces, seed=7) == jnative._xxh64_py(data, 7)
    path = tmp_path / "blob.bin"
    path.write_bytes(rng.integers(0, 256, 100_003, dtype=np.uint8).tobytes())
    assert thashing.xxh64_file(path) == jnative.xxh64_file(path)
    for fn in ("md5_file", "sha256_file"):
        assert getattr(thashing, fn)(path) == getattr(jhashing, fn)(path)
    assert thashing.md5_string("édit") == jhashing.md5_string("édit")
    assert thashing.combine_hashes("a", "b", "c") == jhashing.combine_hashes("a", "b", "c")


def test_big_files_key_by_xxh64_as_jax(tmp_path, monkeypatch):
    """The cache keys a file at or above BIG_FILE_THRESHOLD by "x" + XXH64
    and a smaller one by md5, as JAX's (threshold lowered to 1 KiB in both
    packages so the test file stays small); get_hash over files, strings
    and lists agrees."""
    for cls in (jcache.EmbeddingCacheManager, tcache.EmbeddingCacheManager):
        monkeypatch.setattr(cls, "BIG_FILE_THRESHOLD", 1024)
    big, small = tmp_path / "big.bin", tmp_path / "small.bin"
    big.write_bytes(bytes(range(256)) * 9)
    small.write_bytes(b"tiny")
    for item in (big, small, str(big), "a prompt", [str(small), "empty"], (big, "x")):
        want = jcache.EmbeddingCacheManager.get_hash(item)
        assert tcache.EmbeddingCacheManager.get_hash(item) == want, item
    assert tcache.EmbeddingCacheManager._file_hash(big).startswith("x")
    assert not tcache.EmbeddingCacheManager._file_hash(small).startswith("x")


# ---------------------------------------------------------------------------
# the cache

def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"image_latents": rng.standard_normal((24, 16)).astype(np.float32),
            "prompt_embeds": rng.standard_normal((8, 64)).astype(np.float32),
            "empty_prompt_embeds": rng.standard_normal((8, 64)).astype(np.float32),
            "prompt_embeds_mask": np.array([1, 1, 1, 0], np.int64),
            "img_shapes_arr": np.array([[1, 6, 4], [1, 6, 4]], np.int32),
            "skipped": None}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_loads_in_the_other_package(tmp_path, writer):
    """A cache written by either package loads in the other: the same files
    and metadata bytes, equal arrays (fp16 on disk, f32 on load; ints kept),
    the empty-prompt substitution, the npz header's shape, and None for a
    missing entry or an invalidated file."""
    hashes = {"image_latents": "ih", "prompt_embeds": "ph", "empty_prompt_embeds": "eh"}
    mk = {"jax": jcache.EmbeddingCacheManager, "port": tcache.EmbeddingCacheManager}
    other = "port" if writer == "jax" else "jax"
    mk[writer](tmp_path / "a").save("MAIN", _arrays(0), hashes)
    mk[other](tmp_path / "b").save("MAIN", _arrays(0), hashes)

    def listing(root):
        return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())

    assert listing(tmp_path / "a") == listing(tmp_path / "b")
    assert ((tmp_path / "a" / "metadata" / "MAIN.json").read_bytes()
            == (tmp_path / "b" / "metadata" / "MAIN.json").read_bytes())
    reader, same_pkg = mk[other](tmp_path / "a"), mk[writer](tmp_path / "a")
    meta = (tmp_path / "a" / "metadata" / "MAIN.json").read_text()
    assert '"version": "2.0-tpu"' in meta
    for empty in (False, True):
        assert_same(reader.load("MAIN", use_empty_prompt=empty),
                    same_pkg.load("MAIN", use_empty_prompt=empty))
    got = reader.load("MAIN", use_empty_prompt=True)
    np.testing.assert_array_equal(got["prompt_embeds"],
                                  _arrays(0)["empty_prompt_embeds"].astype(np.float16)
                                  .astype(np.float32))
    assert reader.array_shape("MAIN", "image_latents") == (24, 16)
    assert reader.array_shape("MAIN", "nope") is None and reader.load("OTHER") is None
    (tmp_path / "a" / "image_latents" / "ih.npz").unlink()
    assert reader.load("MAIN") is None and same_pkg.load("MAIN") is None


@pytest.mark.parametrize("save", [np.savez_compressed, np.savez])
@pytest.mark.parametrize("case", ["fp16", "int64", "fortran", "scalar", "empty", "bool"])
def test_npz_member_reads_as_np_load(tmp_path, save, case):
    """`read_npz_data` (one read, one inflate) gives what np.load gives:
    dtype, shape, memory order and values, compressed or stored."""
    rng = np.random.default_rng(4)
    arr = {"fp16": rng.standard_normal((64, 48)).astype(np.float16),
           "int64": rng.integers(-9, 9, (3, 5, 2)),
           "fortran": np.asfortranarray(rng.standard_normal((6, 7)).astype(np.float16)),
           "scalar": np.float16(2.5) * np.ones((), np.float16),
           "empty": np.zeros((0, 16), np.float16),
           "bool": rng.random((4, 4)) < 0.5}[case]
    path = tmp_path / "a.npz"
    save(path, data=arr)
    got = tcache.read_npz_data(path)
    with np.load(path) as z:
        want = z["data"]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.flags.f_contiguous == want.flags.f_contiguous
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the dataset

def test_folder_dataset_matches_jax(tmp_image_dir):
    """The folder scan (alias dirs, _control_N, _mask, .txt) gives JAX's
    samples in JAX's order, and file_hashes equal JAX's byte for byte."""
    j = jdataset.ImageDataset(dataset_path=str(tmp_image_dir))
    t = tdataset.ImageDataset(dataset_path=str(tmp_image_dir))
    assert t.samples == j.samples and len(t) == 3
    assert t.samples[0]["mask_file"] and len(t.samples[0]["controls"]) == 2
    for s in t.samples:
        assert t.file_hashes(s) == j.file_hashes(s)
    sel = dict(dataset_path=str(tmp_image_dir), selected_control_indexes=[2])
    assert tdataset.ImageDataset(**sel).samples == jdataset.ImageDataset(**sel).samples


def test_csv_dataset_matches_pandas(tmp_image_dir, tmp_path):
    """CSV sources through the stdlib reader give what pandas.read_csv
    gives the JAX package: relative paths resolved, empty control / mask
    cells skipped, an empty or NA prompt cell as "nan", and a prompt column
    of numbers typed as pandas types it (ints, floats once a cell is
    empty)."""
    img = lambda d, i: f"{d}/img_{i:03d}.png"  # noqa: E731
    t_dir, c_dir = tmp_image_dir / "training_images", tmp_image_dir / "control_images"
    mixed = tmp_path / "mixed.csv"
    mixed.write_text(
        "path_target,path_control_0,path_control_1,prompt,path_mask\n"
        f"{img(t_dir, 0)},{img(c_dir, 0)},{c_dir}/img_000_control_1.png,a cat,"
        f"{c_dir}/img_000_mask.png\n"
        f"{img(t_dir, 1)},{img(c_dir, 1)},,,\n"
        f"{img(t_dir, 2)},{img(c_dir, 2)},,\"quoted, with comma\",\n"
        f"{img(t_dir, 1)},{img(c_dir, 1)},,None,\n"
        f"{img(t_dir, 2)},{img(c_dir, 2)},,123,\n")
    relative = tmp_path / "sub" / "rel.csv"
    relative.parent.mkdir()
    relative.write_text("path_target,prompt\n../x.png,7\n../y.png,\n../z.png,8\n")
    ints = tmp_path / "ints.csv"
    ints.write_text("path_target,prompt\nx.png,7\ny.png,08\n")
    for path in (mixed, relative, ints):
        j = jdataset.ImageDataset(csv_path=str(path))
        t = tdataset.ImageDataset(csv_path=str(path))
        assert t.samples == j.samples, path.name
        for s in t.samples:
            assert t.file_hashes(s) == j.file_hashes(s)
    prompts = [s["prompt"] for s in tdataset.ImageDataset(csv_path=str(mixed)).samples]
    assert prompts == ["a cat", "nan", "quoted, with comma", "nan", "123"]
    assert [s["prompt"] for s in tdataset.ImageDataset(csv_path=str(relative)).samples] == [
        "7.0", "nan", "8.0"]


def _jax_flux_cache(ds, seed=0):
    """Every sample of a JAX dataset cached by the JAX manager under the
    hashes JAX's cache pass uses (control latents and the empty prompt
    included), shapes varying by sample."""
    rng = np.random.default_rng(seed)
    for i, sample in enumerate(ds.samples):
        h = ds.file_hashes(sample)
        gh, gw = GRIDS[i]
        arrays = chip_smoke.flux_cache_item(rng, TINY, gh, gw, s_txt=8)
        ds.cache_manager.save(h["main_hash"], arrays,
                              {k: h[v] for k, v in chip_smoke.FLUX_HASH_KEYS.items()})


def test_cached_items_and_dropout_match_jax(tmp_image_dir, tmp_path):
    """A cache written by the JAX package feeds the port's dataset: over
    three visits of every sample at caption and prompt-image dropout 0.5 /
    0.5, the port's items (prompt, file hashes, cached arrays, the empty
    prompt's embeddings swapped in, control latents zeroed) equal JAX's,
    since both draw from numpy's generator keyed (seed, idx, visit)."""
    kw = dict(dataset_path=str(tmp_image_dir), cache_dir=str(tmp_path / "cache"),
              use_cache=True, caption_dropout_rate=0.5, prompt_image_dropout_rate=0.5, seed=3)
    j = jdataset.ImageDataset(**kw)
    _jax_flux_cache(j)
    t = tdataset.ImageDataset(**kw)
    drops = set()
    for visit in range(3):
        for i in range(len(t)):
            a, b = t[i], j[i]
            assert_same(a, b, f"visit {visit} sample {i}")
            empty = t.cache_manager.load(a["file_hashes"]["main_hash"], use_empty_prompt=True)
            drops.add((bool(np.all(a["control_latents"] == 0)),
                       bool(np.array_equal(a["prompt_embeds"], empty["prompt_embeds"]))))
    assert len(t._visit_counts) == 3 and set(t._visit_counts.values()) == {3}
    # kept, caption dropped, and everything dropped all occur
    assert {(False, False), (False, True), (True, True)} <= drops


def test_uncached_sample_and_hf_dataset_raise(tmp_image_dir, tmp_path):
    """A sample the cache does not hold, and every sample with the cache
    off, come back as the JAX dataset's pixel items (read, resampled,
    drop_context and img_shapes, the mask as f32) over three visits with
    conditioning dropout; an HF Hub name needs the network and still
    raises, naming item 5b."""
    kw = {"processor": tpre.ImageProcessor(target_size=[32, 48]), "use_edit_mask": True,
          "caption_dropout_rate": 0.5, "prompt_image_dropout_rate": 0.3, "seed": 3}
    jkw = dict(kw, processor=jpre.ImageProcessor(jpre.ProcessorSection(target_size=[32, 48])))
    for extra in ({"cache_dir": str(tmp_path / "empty"), "use_cache": True}, {}):
        ds = tdataset.ImageDataset(dataset_path=str(tmp_image_dir), **kw, **extra)
        jds = jdataset.ImageDataset(dataset_path=str(tmp_image_dir), **jkw, **extra)
        for _ in range(3):
            for i in range(len(ds)):
                got, want = ds[i], jds[i]
                assert got["cached"] is False and "image_latents" not in got
                assert_same(got, want, f"sample {i}")
    with pytest.raises(NotImplementedError, match=ITEM_5):
        tdataset.ImageDataset(dataset_path="someone/edit-pairs")
    assert jdataset.is_huggingface_repo("someone/edit-pairs")
    assert tdataset.is_huggingface_repo("someone/edit-pairs")


# ---------------------------------------------------------------------------
# the resolution policy

SOURCES = [(100, 100), (640, 480), (480, 640), (1000, 500), (513, 257), (300, 1150),
           (1920, 1080), (777, 333), (2000, 450)]
PROCESSORS = [
    {"multi_resolutions": [[512, 512], [768, 512], [512, 768]]},
    {"multi_resolutions": {"target": [[512, 512], [768, 512], [512, 768]],
                           "controls": [[[512, 512], [768, 512]], [[256, 256]]]}},
    {"multi_resolutions": [262144, [1024, 1024]], "max_aspect_ratio": 2.0},
    {"process_type": "fixed_pixels", "target_pixels": "512*512",
     "controls_pixels": [None, "384*384"]},
    {"process_type": "center_crop", "target_size": [832, 576],
     "controls_size": [[512, 512], None]},
    {"process_type": "resize", "target_size": [500, 333], "divisible_by": 32},
]


@pytest.mark.parametrize("i", range(len(PROCESSORS)))
def test_resolution_policy_matches_jax(i):
    """output_shape (the processed (H, W) from the source size alone),
    candidates_for and select_pixels for the target and three controls over
    a grid of source sizes, the max-aspect-ratio refusal included."""
    kw = PROCESSORS[i]
    j = jpre.ImageProcessor(jpre.ProcessorSection(**kw))
    t = tpre.ImageProcessor(**kw)
    assert vars(t.config) == j.config.model_dump()
    for kind in ("target", "control_0", "control_1", "control_2"):
        assert t.candidates_for(kind) == j.candidates_for(kind)
        for w, h in SOURCES:
            try:
                want = j.output_shape(h, w, kind)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    t.output_shape(h, w, kind)
                continue
            assert t.output_shape(h, w, kind) == want, (kind, w, h)
    sample = {"image": np.zeros((32, 48, 3)), "control": np.zeros((16, 16, 3)),
              "controls": [np.zeros((8, 24, 3))]}
    assert t.bucket_key(sample) == j.bucket_key(sample)


def test_factorization_helpers_match_jax():
    for area in (1, 4096, 65536, 262144, 500000, 1048576, 589824):
        assert tpre.count_hw_pairs(area) == jpre.count_hw_pairs(area)
        assert tpre.best_area_near(area) == jpre.best_area_near(area)
        for w, h in SOURCES[:5]:
            assert tpre.best_hw_given_area(area, w, h) == jpre.best_hw_given_area(area, w, h)
            assert (tpre.best_hw_given_area(area, w, h, min_side=256, max_side=1024)
                    == jpre.best_hw_given_area(area, w, h, min_side=256, max_side=1024))
            assert (tpre.calculate_best_resolution(w, h, area)
                    == jpre.calculate_best_resolution(w, h, area))
    # the pixels follow the geometry (tests/test_torch_pixels.py holds them
    # to JAX's in every process_type)
    img = np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)
    for kw in ({"process_type": "fixed_pixels", "target_pixels": 4096}, {"target_size": [48, 32]}):
        t, j = tpre.ImageProcessor(**kw), jpre.ImageProcessor(jpre.ProcessorSection(**kw))
        np.testing.assert_array_equal(t.process_image(img), j.process_image(img))
        assert t.process_image(img).shape[:2] == t.output_shape(90, 70)


# ---------------------------------------------------------------------------
# collate and the loader

def test_collate_matches_jax():
    """Stacks, zero-padding with valid_masks for the arrays whose shapes
    differ (only those), image-space masks to latent edit masks before
    padding, numbers to one array, the rest to lists."""
    rng = np.random.default_rng(2)

    def sample(h, w, s_txt, planes):
        return {"image_latents": rng.standard_normal((h * w, 4)).astype(np.float32),
                "prompt_embeds": rng.standard_normal((s_txt, 3)).astype(np.float32),
                "img_shapes_arr": np.ones((planes, 3), np.int32) * h,
                "mask": (rng.random((16 * h, 16 * w)) > 0.5).astype(np.float32),
                "prompt": f"p{h}", "file_hashes": {"main_hash": str(h)}, "cached": True,
                "weight": np.float32(h), "n": h, "img_shapes": [(h, w)]}

    for samples in ([sample(2, 2, 5, 2), sample(2, 2, 5, 2)],
                    [sample(2, 2, 5, 2), sample(4, 2, 7, 3), sample(2, 4, 5, 2)]):
        got, want = tcollate.collate(samples), jcollate.collate(samples)
        assert_same(got, want)
    assert sorted(got["valid_masks"]) == ["image_latents", "img_shapes_arr", "prompt_embeds"]


def _loaders(root, **kw):
    data, cache = root
    dkw = dict(dataset_path=str(data), cache_dir=str(cache), use_cache=True,
               caption_dropout_rate=0.5, prompt_image_dropout_rate=0.5, seed=3)
    return (tloader.DataLoader(tdataset.ImageDataset(**dkw), **kw),
            jloader.DataLoader(jdataset.ImageDataset(**dkw), **kw))


@pytest.fixture(scope="module")
def cached_folder(tmp_path_factory):
    return _cached_folder(tmp_path_factory.mktemp("cached"))


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_jax(cached_folder, bucket, workers, drop_last):
    """Over two epochs, the port's DataLoader yields JAX's batches in JAX's
    order, equal to the bit: the shuffle of default_rng(seed + epoch), the
    buckets keyed by the npz header's latent shape, drop_last, padded
    batches' valid masks, and the dropout draws."""
    kw = dict(batch_size=2, shuffle=True, drop_last=drop_last, seed=5, bucket_by_shape=bucket,
              num_workers=workers)
    t, j = _loaders(cached_folder, **kw)
    assert len(t) == len(j)
    for epoch in range(2):
        got, want = list(t), list(j)
        assert len(got) == len(want) > 0, epoch
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"epoch {epoch} batch {i}")
        if bucket:
            assert all("valid_masks" not in b for b in got)
    assert sum(b["image_latents"].shape[0] for b in got) == (6 if drop_last else 7)
    if bucket:
        assert ([r["_bucket"] for r in t.dataset.samples]
                == [r["_bucket"] for r in j.dataset.samples])


class _Failing(tdataset.ImageDataset):
    def __getitem__(self, idx):
        if idx == 3:
            raise OSError("sample 3 is unreadable")
        return super().__getitem__(idx)


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_raises_worker_errors_and_stops_its_thread(cached_folder, workers):
    """An exception in the producer or a worker thread is raised in the
    consumer; a consumer that stops early stops the producer, whose queue
    stays bounded."""
    data, cache = cached_folder
    ds = _Failing(str(data), cache_dir=str(cache), use_cache=True)
    dl = tloader.DataLoader(ds, batch_size=1, shuffle=False, bucket_by_shape=False,
                            num_workers=workers, prefetch=1)
    with pytest.raises(OSError, match="unreadable"):
        list(dl)
    it = iter(tloader.DataLoader(tdataset.ImageDataset(str(data), cache_dir=str(cache),
                                                       use_cache=True),
                                 batch_size=1, shuffle=False, num_workers=workers, prefetch=1))
    next(it)
    it.close()
    assert not [t for t in threading.enumerate() if t.name == "qflux-data-loader"]
