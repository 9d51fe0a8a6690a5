"""The port's data pipeline (``dagr_tpu_torch.data``) against dagr_tpu's,
array for array: the DSEC and NCaltech101 readers on fabricated trees
with plain and blosc event files, every augmentation and the training
preset under one seeded generator, ``collate``, ``Loader`` and the 2x
downsampler."""
import h5py
import numpy as np
import pytest
import torch

from test_data import make_dsec_sequence, make_ncaltech, write_event_h5_blosc

from dagr_tpu.data import augment as jax_augment
from dagr_tpu.data import h5io as jax_h5io
from dagr_tpu.data.downsample import downsample_file as jax_downsample_file
from dagr_tpu.data.dsec import DSEC as JaxDSEC
from dagr_tpu.data.dsec import DSECSequence as JaxDSECSequence
from dagr_tpu.data.loader import Loader as JaxLoader
from dagr_tpu.data.ncaltech101 import NCaltech101 as JaxNCaltech101
from dagr_tpu.data.sample import EventSample as JaxEventSample
from dagr_tpu.data.sample import collate as jax_collate
from dagr_tpu_torch.data import augment, h5io
from dagr_tpu_torch.data.downsample import downsample_file, write_event_h5
from dagr_tpu_torch.data.dsec import DSEC, DSECSequence
from dagr_tpu_torch.data.loader import Loader
from dagr_tpu_torch.data.ncaltech101 import NCaltech101
from dagr_tpu_torch.data.sample import EventSample, collate

SAMPLE_FIELDS = ("x", "y", "t", "p", "bbox", "bbox0", "image", "width",
                 "height", "time_window", "sequence", "t0", "t1")


def assert_samples_equal(got, want):
    for f in SAMPLE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


@pytest.fixture(scope="module")
def dsec_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsec")
    split = make_dsec_sequence(root, "zurich_city_99_x", n_images=5)
    return root, split


@pytest.mark.parametrize("kw", [
    dict(min_bbox_diag=15, min_bbox_height=10),
    dict(only_perfect_tracks=True),
    dict(num_us=25_000),
], ids=["filters", "perfect_tracks", "interframe"])
def test_dsec_reader_matches(dsec_root, kw):
    root, split = dsec_root
    kw = dict(kw)
    num_us = kw.pop("num_us", None)
    sets = [cls(root, "train", transform=pkg.Augmentations.testing(),
                split_yaml=split, **kw)
            for cls, pkg in ((DSEC, augment), (JaxDSEC, jax_augment))]
    if num_us is not None:
        for ds in sets:
            ds.set_num_us(num_us)
    ours, ref = sets
    assert (ours.height, ours.width, ours.classes) == (215, 320, ref.classes)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        assert_samples_equal(ours[i], ref[i])


def test_blosc_event_files_read_alike(tmp_path):
    """Reference-format blosc-zstd files (filter 32001), written by either
    package, read the same through both packages and as the gzip file."""
    rng = np.random.default_rng(3)
    n, t0 = 5000, 1_000_000
    events = dict(
        x=rng.integers(0, 320, n).astype(np.uint16),
        y=rng.integers(0, 240, n).astype(np.uint16),
        t=np.sort(rng.integers(t0, t0 + 150_000, n)).astype(np.int64),
        p=rng.integers(0, 2, n).astype(np.uint8))
    for name, writer in (("gzip", write_event_h5),
                         ("blosc", write_event_h5_blosc)):
        seq = tmp_path / name / "seq"
        (seq / "events" / "left").mkdir(parents=True)
        (seq / "images").mkdir(parents=True)
        (seq / "object_detections" / "left").mkdir(parents=True)
        np.savetxt(seq / "images" / "timestamps.txt", [t0], fmt="%d")
        np.save(seq / "object_detections" / "left" / "tracks.npy",
                np.zeros(0, dtype=[("t", "<i8")]))
        writer(seq / "events" / "left" / "events_2x.h5", events)
    window = (t0 + 10_000, t0 + 90_000)
    want = JaxDSECSequence(tmp_path / "gzip" / "seq").get_events(*window)
    assert len(want["t"]) > 0
    for name in ("gzip", "blosc"):
        for cls in (DSECSequence, JaxDSECSequence):
            got = cls(tmp_path / name / "seq").get_events(*window)
            for k in "xytp":
                np.testing.assert_array_equal(got[k], want[k])
    # the port's blosc writer read by dagr_tpu's reader, and back
    data = rng.integers(0, 1 << 30, 3000).astype(np.int64)
    with h5py.File(tmp_path / "w.h5", "w") as f:
        h5io.write_blosc_dataset(f, "a", data, chunk=700)
        jax_h5io.write_blosc_dataset(f, "b", data, chunk=700)
    with h5py.File(tmp_path / "w.h5", "r") as f:
        for name in "ab":
            for mod in (h5io, jax_h5io):
                d = mod.dset(f, name)
                np.testing.assert_array_equal(d[...], data)
                np.testing.assert_array_equal(d[650:1500], data[650:1500])
                np.testing.assert_array_equal(d[-10:], data[-10:])
                assert d[1234] == data[1234]


@pytest.mark.parametrize("blosc", [False, True], ids=["plain", "blosc"])
def test_ncaltech_reader_matches(tmp_path, blosc):
    make_ncaltech(tmp_path, n_classes=2, n_files=2)
    if blosc:
        # rewrite each file in the reference's blosc format
        for path in sorted((tmp_path / "training").rglob("*.h5")):
            with h5py.File(path, "r") as f:
                arrays = {k: f[f"events/{k}"][()] for k in "xytp"}
            with h5py.File(path, "w") as f:
                for k, v in arrays.items():
                    h5io.write_blosc_dataset(f, f"events/{k}", v, chunk=512)
    ours = NCaltech101(tmp_path, "training", num_events=2000)
    ref = JaxNCaltech101(tmp_path, "training", num_events=2000)
    assert ours.classes == ref.classes and len(ours) == len(ref) == 4
    for i in range(len(ref)):
        assert_samples_equal(ours[i], ref[i])


def every_transform(pkg):
    """Each transform taking its random branch: flip, crop, a zoom out
    (the polarity-accumulator subsample), translate, the final crop."""
    return pkg.Compose([
        pkg.RandomHFlip(p=1.1), pkg.RandomCrop((0.75, 0.75), p=1.1),
        pkg.RandomZoom(zoom=(0.5, 0.9), subsample=True),
        pkg.RandomTranslate([0.1, 0.1]), pkg.Crop([0, 0], [1, 1])])


@pytest.mark.parametrize("preset", ["training", "every_transform"])
def test_augmentations_match_under_one_generator(dsec_root, preset):
    """The same seeded draws in both packages: every sample of the DSEC
    tree (with its frame) through the preset, in order."""
    root, split = dsec_root
    make = (lambda pkg: pkg.Augmentations.training()) \
        if preset == "training" else every_transform
    ours = DSEC(root, "train", transform=make(augment), split_yaml=split,
                seed=7)
    ref = JaxDSEC(root, "train", transform=make(jax_augment),
                  split_yaml=split, seed=7)
    for _ in range(2):
        for i in range(len(ref)):
            assert_samples_equal(ours[i], ref[i])


def test_subsample_and_zoom_on_random_samples():
    rng = np.random.default_rng(0)
    for seed in range(4):
        n = int(rng.integers(1, 3000))
        arrays = dict(
            x=rng.integers(0, 100, n).astype(np.int16),
            y=rng.integers(0, 50, n).astype(np.int16),
            t=np.sort(rng.integers(0, 1_000_000, n)).astype(np.int32),
            p=(2 * rng.integers(0, 2, n) - 1).astype(np.int8),
            bbox=rng.random((3, 5)).astype(np.float32) * 40,
            bbox0=rng.random((2, 5)).astype(np.float32) * 40,
            image=rng.integers(0, 255, (50, 100, 3)).astype(np.uint8))
        got, want = (cls(**{k: v.copy() for k, v in arrays.items()},
                         width=100, height=50)
                     for cls in (EventSample, JaxEventSample))
        tg, tw = every_transform(augment), every_transform(jax_augment)
        tg.init(50, 100)
        tw.init(50, 100)
        got = tg(got, np.random.default_rng(seed))
        want = tw(want, np.random.default_rng(seed))
        assert_samples_equal(got, want)


@pytest.mark.parametrize("n_nodes", [1000, 8000])
def test_collate_matches(dsec_root, n_nodes):
    """Keeps the last n_nodes events; positions, polarity, mask, targets,
    images (the port's [B, 3, H, W]) and the targets at the frame."""
    root, split = dsec_root
    ds = JaxDSEC(root, "train", transform=jax_augment.Augmentations.testing(),
                 split_yaml=split)
    samples = [ds[i] for i in range(3)]
    assert min(s.num_events for s in samples) < 8000 \
        and max(s.num_events for s in samples) > 1000
    ours = [EventSample(**{f: getattr(s, f) for f in SAMPLE_FIELDS})
            for s in samples]
    got = collate(ours, n_nodes, max_gt=7, with_images=True, with_bbox0=True)
    want = jax_collate(samples, n_nodes, max_gt=7, with_images=True,
                       with_bbox0=True)
    assert_batches_equal(got, want)


def assert_batches_equal(got, want):
    (ev, tgt, imgs, *tgt0), (jev, jtgt, jimgs, *jtgt0) = got, want
    for name in ("pos", "feat", "mask"):
        g, w = getattr(ev, name), np.asarray(getattr(jev, name))
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (ev.width, ev.height, ev.time_window) == \
        (jev.width, jev.height, jev.time_window)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    if jimgs is None:
        assert imgs is None
    else:
        np.testing.assert_array_equal(
            imgs.numpy(), np.asarray(jimgs).transpose(0, 3, 1, 2))
    for g, w in zip(tgt0, jtgt0):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(tgt0) == len(jtgt0)


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, n_nodes=2048),
    dict(batch_size=3, n_nodes=1024, shuffle=True, drop_last=False,
         with_images=True, with_bbox0=True, seed=5),
], ids=["default", "shuffle_images_bbox0"])
def test_loader_matches(dsec_root, kw):
    root, split = dsec_root
    ds = DSEC(root, "train", transform=augment.Augmentations.testing(),
              split_yaml=split)
    jds = JaxDSEC(root, "train",
                  transform=jax_augment.Augmentations.testing(),
                  split_yaml=split)
    ours, ref = Loader(ds, **kw), JaxLoader(jds, **kw)
    assert len(ours) == len(ref) > 0
    n = 0
    for _ in range(2):          # a second epoch reshuffles alike
        for got, want in zip(ours, ref):
            assert isinstance(got[1], torch.Tensor)
            assert_batches_equal(got, want)
            n += 1
    assert n == 2 * len(ref)


def test_downsample_file_matches(tmp_path):
    rng = np.random.default_rng(0)
    n = 20_000
    events = dict(
        x=rng.integers(0, 64, n).astype(np.uint16),
        y=rng.integers(0, 48, n).astype(np.uint16),
        t=np.sort(rng.integers(0, 1_000_000, n)).astype(np.int64),
        p=(rng.random(n) < 0.8).astype(np.uint8))
    for name, writer in (("gzip", write_event_h5),
                         ("blosc", write_event_h5_blosc)):
        src = tmp_path / f"{name}.h5"
        writer(src, events)
        outs = []
        for tool in (downsample_file, jax_downsample_file):
            dst = tmp_path / f"{name}_{len(outs)}_2x.h5"
            tool(src, dst, chunk=7000)
            with h5py.File(dst) as f:
                outs.append({k: f[k][()] for k in (
                    "events/x", "events/y", "events/t", "events/p",
                    "ms_to_idx", "t_offset")})
        assert len(outs[1]["events/x"]) > 0
        for k, want in outs[1].items():
            assert outs[0][k].dtype == want.dtype, k
            np.testing.assert_array_equal(outs[0][k], want, err_msg=k)
