"""The port's vision data path (``paddle_tpu_torch.vision.transforms``,
``vision.datasets``, ``vision.image``) against the JAX package's.

* Every functional transform on an HWC uint8 ndarray and on a PIL image
  (RGB and L): the same values, the same
  dtype, PIL in → PIL out.  Exact: both run the same numpy / PIL
  arithmetic.
* Every transform class on the same ``random.seed``: both draw from
  Python's ``random`` in the same calls and order, so the crops, flips,
  angles and jitter are the same.
* Every dataset read from files written into ``tmp_path`` (IDX gzip,
  python-pickle tar archives, the Flowers tgz + ``.mat`` files, the VOC
  tar, class folders of PNG / ``.npy`` files): the same samples, labels
  and lengths; missing files raise ``FileNotFoundError`` with JAX's
  message; the tar-backed datasets pickle for ``DataLoader`` workers and
  a ``DatasetFolder`` + transforms pipeline gives the same batches
  through 2 spawned workers as in the main process.
* The image backend, the loaders and the package's names.
"""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
from PIL import Image

import paddle_tpu.io.dataset as jio_dataset
import paddle_tpu.vision as jvision
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
from paddle_tpu.vision.datasets import folder as jfolder
from paddle_tpu.vision.transforms import functional as JTF
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.io.dataset as tio_dataset
import paddle_tpu_torch.vision as tvision
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT
from paddle_tpu_torch.vision.datasets import folder as tfolder
from paddle_tpu_torch.vision.transforms import functional as TTF


def _img(seed=0, h=12, w=16, c=3):
    shape = (h, w) if c is None else (h, w, c)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _same(a, b):
    """Equal values and types; PIL images compare by mode, size and
    pixels."""
    assert type(a) is type(b) or (isinstance(a, Image.Image)
                                  and isinstance(b, Image.Image)), (
        type(a), type(b))
    if isinstance(a, Image.Image):
        assert a.mode == b.mode and a.size == b.size
        a, b = np.asarray(a), np.asarray(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _inputs(kind):
    if kind == "ndarray":
        return _img(1)
    if kind == "pil":
        return Image.fromarray(_img(1))
    return Image.fromarray(_img(2, c=None))  # "pil_l"


# -- functional transforms -----------------------------------------------------
FUNCTIONAL = {
    "to_tensor_chw": ("to_tensor", (), {}),
    "to_tensor_hwc": ("to_tensor", ("HWC",), {}),
    "resize_short_side": ("resize", (9,), {}),
    "resize_hw_bicubic": ("resize", ((10, 7),), dict(interpolation="bicubic")),
    "resize_nearest": ("resize", ((5, 20),), dict(interpolation="nearest")),
    "pad_int": ("pad", (2,), {}),
    "pad_pair_edge": ("pad", ((1, 3),), dict(padding_mode="edge")),
    "pad_four_reflect": ("pad", ((1, 2, 3, 4),),
                         dict(padding_mode="reflect")),
    "pad_symmetric_fill": ("pad", (2,), dict(padding_mode="symmetric")),
    "pad_constant_fill": ("pad", (3,), dict(fill=7)),
    "crop": ("crop", (1, 2, 5, 6), {}),
    "center_crop_int": ("center_crop", (7,), {}),
    "center_crop_pair": ("center_crop", ((5, 9),), {}),
    "hflip": ("hflip", (), {}),
    "vflip": ("vflip", (), {}),
    "transpose": ("transpose", ((2, 0, 1),), {}),
    "brightness": ("adjust_brightness", (1.4,), {}),
    "contrast": ("adjust_contrast", (0.6,), {}),
    "saturation": ("adjust_saturation", (1.7,), {}),
    "hue": ("adjust_hue", (0.2,), {}),
    "hue_negative": ("adjust_hue", (-0.35,), {}),
    "rotate_nearest": ("rotate", (30,), {}),
    "rotate_bilinear_expand": ("rotate", (-47.5,),
                               dict(interpolation="bilinear", expand=True)),
    "rotate_center_fill": ("rotate", (90,), dict(center=(3, 4), fill=9)),
    "grayscale_1": ("to_grayscale", (), {}),
    "grayscale_3": ("to_grayscale", (3,), {}),
}


@pytest.mark.parametrize("kind", ["ndarray", "pil", "pil_l"])
@pytest.mark.parametrize("case", list(FUNCTIONAL))
def test_functional_transform_as_jax(case, kind):
    fn, args, kw = FUNCTIONAL[case]
    want = getattr(JTF, fn)(_inputs(kind), *args, **kw)
    got = getattr(TTF, fn)(_inputs(kind), *args, **kw)
    _same(want, got)


@pytest.mark.parametrize("kw", [
    dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3]),
    dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3], data_format="HWC"),
    dict(mean=[10.0, 20.0, 30.0], std=[2.0, 3.0, 4.0], to_rgb=True),
    dict(mean=[10.0, 20.0, 30.0], std=[2.0, 3.0, 4.0], data_format="HWC",
         to_rgb=True),
], ids=str)
def test_normalize_as_jax(kw):
    chw = TTF.to_tensor(_img(3))
    x = chw if kw.get("data_format", "CHW") == "CHW" else chw.transpose(
        1, 2, 0)
    _same(JTF.normalize(x, **kw), TTF.normalize(x, **kw))


def test_errors_as_jax():
    for mod in (JTF, TTF):
        with pytest.raises(ValueError, match="hue_factor"):
            mod.adjust_hue(_img(), 0.7)
        with pytest.raises(ValueError, match="num_output_channels"):
            mod.to_grayscale(_img(), 2)
        with pytest.raises(ValueError, match="data_format"):
            mod.to_tensor(_img(), "CWH")


def test_an_ndarray_pipeline_never_imports_pil(monkeypatch):
    """``_is_pil`` reads ``sys.modules``: with PIL unimportable, the
    numpy transforms still run (the card's machine has no PIL)."""
    import sys

    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    pipeline = TT.Compose([TT.RandomCrop(8), TT.RandomHorizontalFlip(),
                           TT.ToTensor(data_format="HWC"),
                           TT.Normalize([0.5] * 3, [0.2] * 3,
                                        data_format="HWC")])
    random.seed(0)
    out = pipeline(_img(4))
    assert out.shape == (8, 8, 3) and out.dtype == np.float32
    assert sys.modules["PIL"] is None


# -- transform classes ---------------------------------------------------------
CLASSES = {
    "ToTensor": lambda T: T.ToTensor(),
    "ToTensor_hwc": lambda T: T.ToTensor(data_format="HWC"),
    "Resize": lambda T: T.Resize((10, 8)),
    "Resize_short": lambda T: T.Resize(9, interpolation="bicubic"),
    "CenterCrop": lambda T: T.CenterCrop(6),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.7),
    "Transpose": lambda T: T.Transpose(),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "ContrastTransform": lambda T: T.ContrastTransform((0.5, 1.5)),
    "SaturationTransform": lambda T: T.SaturationTransform(0.5),
    "HueTransform": lambda T: T.HueTransform(0.3),
    "ColorJitter": lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.2),
    "RandomCrop": lambda T: T.RandomCrop(8),
    "RandomCrop_padded": lambda T: T.RandomCrop((14, 9), padding=2,
                                                padding_mode="reflect"),
    "RandomCrop_pad_if_needed": lambda T: T.RandomCrop(
        20, pad_if_needed=True, fill=3),
    "Pad": lambda T: T.Pad((1, 2), fill=5),
    "RandomRotation": lambda T: T.RandomRotation(40),
    "RandomRotation_expand": lambda T: T.RandomRotation(
        (-10, 80), interpolation="bilinear", expand=True),
    "Grayscale": lambda T: T.Grayscale(3),
    "Compose": lambda T: T.Compose([
        T.RandomCrop(10), T.RandomHorizontalFlip(), T.ColorJitter(0.3, 0.3),
        T.ToTensor(), T.Normalize([0.5, 0.5, 0.5], [0.2, 0.2, 0.2])]),
}


@pytest.mark.parametrize("kind", ["ndarray", "pil"])
@pytest.mark.parametrize("case", list(CLASSES))
def test_transform_class_as_jax_on_the_same_seed(case, kind):
    jt, tt = CLASSES[case](JT), CLASSES[case](TT)
    for seed in range(5):  # several draws: both branches of each coin
        random.seed(seed)
        want = jt(_inputs(kind))
        random.seed(seed)
        got = tt(_inputs(kind))
        _same(want, got)
    assert repr(tt) == repr(jt)


def test_random_resized_crop_as_jax():
    """On PIL images both packages crop and resize the same; on an
    ndarray both raise ``TypeError`` (JAX's ``_apply_image`` reads an
    ndarray's ``size`` as PIL's ``(w, h)``)."""
    jt = JT.RandomResizedCrop(8, scale=(0.3, 1.0))
    tt = TT.RandomResizedCrop(8, scale=(0.3, 1.0))
    for seed in range(5):
        random.seed(seed)
        want = jt(_inputs("pil"))
        random.seed(seed)
        _same(want, tt(_inputs("pil")))
    for t in (jt, tt):
        with pytest.raises(TypeError):
            t(_img())


def test_base_transform_keys_as_jax():
    class Twice(TT.BaseTransform):
        def _apply_image(self, img):
            return img * 2

    sample = (np.ones((2, 2)), "label", np.zeros(3))
    out = Twice(keys=("image", None))(sample)
    assert out[1] == "label" and (out[0] == 2).all() and out[2] is sample[2]
    assert (Twice()(np.ones(2)) == 2).all()  # a bare sample is one image
    random.seed(3)
    want = JT.RandomHorizontalFlip(1.0)((_img(5), "y"))
    random.seed(3)
    got = TT.RandomHorizontalFlip(1.0)((_img(5), "y"))
    _same(want[0], got[0])
    assert got[1] == "y"
    with pytest.raises(NotImplementedError):
        TT.BaseTransform()(_img())


def test_jitter_arguments_as_jax():
    for T in (JT, TT):
        with pytest.raises(ValueError):
            T.BrightnessTransform(-1)
        with pytest.raises(ValueError):
            T.RandomRotation(-5)
        assert T.ContrastTransform(0).value is None
        assert T.HueTransform(0.7).value == (-0.5, 0.5)


# -- the image backend and the loaders -----------------------------------------
def test_image_backend_as_jax(tmp_path):
    p = str(tmp_path / "x.png")
    Image.fromarray(_img(6)).save(p)
    assert tvision.get_image_backend() == jvision.get_image_backend() == "pil"
    try:
        tvision.set_image_backend("cv2")
        assert tvision.get_image_backend() == "cv2"
        np.testing.assert_array_equal(tvision.image_load(p),
                                      jvision.image_load(p, backend="cv2"))
    finally:
        tvision.set_image_backend("pil")
    got = tvision.image_load(p)
    assert isinstance(got, Image.Image)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jvision.image_load(p)))
    with pytest.raises(ValueError, match="backend"):
        tvision.set_image_backend("skimage")
    with pytest.raises(ValueError, match="backend"):
        tvision.image_load(p, backend="skimage")


def test_loaders_as_jax(tmp_path):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(_img(7)).save(p)
    for name in ("pil_loader", "cv2_loader", "default_loader"):
        want, got = getattr(JD, name)(p), getattr(TD, name)(p)
        _same(want, got)
    assert tfolder.has_valid_extension("a/B.JPG")
    assert not tfolder.has_valid_extension("a/b.npy")
    assert tfolder.has_valid_extension("a/b.npy", (".npy",))
    assert tfolder.IMG_EXTENSIONS == jfolder.IMG_EXTENSIONS


# -- datasets ------------------------------------------------------------------
def _write_idx(root, n=12, seed=0, prefix="train"):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (n,)).astype(np.uint8)
    img = os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
    lbl = os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz")
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lbl, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img, lbl


def _same_dataset(jds, tds):
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        _same(tuple(jds[i]), tuple(tds[i]))


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_mnist_as_jax(tmp_path, name):
    img, lbl = _write_idx(str(tmp_path))
    kw = dict(image_path=img, label_path=lbl, mode="train")
    _same_dataset(getattr(JD, name)(**kw), getattr(TD, name)(**kw))
    tf = TT.Compose([TT.Normalize(127.5, 127.5)])
    jf = JT.Compose([JT.Normalize(127.5, 127.5)])
    _same_dataset(getattr(JD, name)(transform=jf, **kw),
                  getattr(TD, name)(transform=tf, **kw))


def test_idx_magic_is_checked_as_jax(tmp_path):
    img, lbl = _write_idx(str(tmp_path))
    for D in (JD, TD):
        with pytest.raises(ValueError, match="magic"):
            D.MNIST(image_path=lbl, label_path=lbl)
        with pytest.raises(ValueError, match="mode"):
            D.MNIST(image_path=img, label_path=lbl, mode="valid")


def _write_cifar(tmp_path, name, label_key, members):
    archive = tmp_path / name
    rng = np.random.RandomState(len(name))
    with tarfile.open(archive, "w:gz") as tar:
        for member in members:
            batch = {b"data": rng.randint(0, 256, (5, 3072)).astype(np.uint8),
                     label_key: rng.randint(0, 100, (5,)).tolist()}
            blob = pickle.dumps(batch)
            info = tarfile.TarInfo(member)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return str(archive)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name,key,members", [
    ("Cifar10", b"labels", ["cifar-10-batches-py/data_batch_2",
                            "cifar-10-batches-py/data_batch_1",
                            "cifar-10-batches-py/test_batch",
                            "cifar-10-batches-py/batches.meta"]),
    ("Cifar100", b"fine_labels", ["cifar-100-python/train",
                                  "cifar-100-python/test",
                                  "cifar-100-python/meta"]),
])
def test_cifar_as_jax(tmp_path, name, key, members, mode):
    f = _write_cifar(tmp_path, getattr(JD, name).NAME, key, members)
    jds = getattr(JD, name)(data_file=f, mode=mode)
    tds = getattr(TD, name)(data_file=f, mode=mode)
    _same_dataset(jds, tds)
    img, label = tds[0]
    assert img.dtype == np.float32 and img.shape == (3, 32, 32)
    assert label.dtype == np.int64


def _blob(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _add(tar, name, blob):
    info = tarfile.TarInfo(name)
    info.size = len(blob)
    tar.addfile(info, io.BytesIO(blob))


@pytest.fixture
def flowers(tmp_path):
    import scipy.io as scio

    data = str(tmp_path / "102flowers.tgz")
    with tarfile.open(data, "w:gz") as t:
        for i in range(1, 7):
            _add(t, "jpg/image_%05d.jpg" % i, _blob(_img(i), "JPEG"))
    labels = str(tmp_path / "imagelabels.mat")
    scio.savemat(labels, {"labels": np.array([[1, 2, 3, 1, 2, 3]])})
    setid = str(tmp_path / "setid.mat")
    scio.savemat(setid, {"trnid": np.array([[1, 2, 3, 4]]),
                         "valid": np.array([[5]]), "tstid": np.array([[6]])})
    return dict(data_file=data, label_file=labels, setid_file=setid)


@pytest.mark.parametrize("backend", [None, "pil"])
@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_flowers_as_jax(flowers, mode, backend):
    kw = dict(flowers, mode=mode, backend=backend)
    _same_dataset(JD.Flowers(**kw), TD.Flowers(**kw))


@pytest.fixture
def voc(tmp_path):
    p = str(tmp_path / "VOCtrainval_11-May-2012.tar")
    names = ["2007_000001", "2007_000002", "2007_000003"]
    base = "VOCdevkit/VOC2012/"
    with tarfile.open(p, "w") as t:
        for split, members in (("trainval", names), ("train", names[:1]),
                               ("val", names[1:])):
            _add(t, f"{base}ImageSets/Segmentation/{split}.txt",
                 "\n".join(members).encode())
        for i, n in enumerate(names):
            _add(t, f"{base}JPEGImages/{n}.jpg", _blob(_img(i), "JPEG"))
            _add(t, f"{base}SegmentationClass/{n}.png",
                 _blob(_img(i + 10, c=None) % 21, "PNG"))
    return p


@pytest.mark.parametrize("backend", [None, "pil"])
@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_voc2012_as_jax(voc, mode, backend):
    kw = dict(data_file=voc, mode=mode, backend=backend)
    _same_dataset(JD.VOC2012(**kw), TD.VOC2012(**kw))


def test_tar_datasets_pickle_for_workers(flowers, voc):
    for ds in (TD.Flowers(**flowers), TD.VOC2012(data_file=voc)):
        first = ds[0]  # opens the archive in this process
        clone = pickle.loads(pickle.dumps(ds))
        assert clone._tar is None
        _same(tuple(first), tuple(clone[0]))


def _class_folders(root, n_classes=3, per_class=4, ext=".png"):
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(os.path.join(d, "nested"))
        for i in range(per_class):
            arr = _img(c * 10 + i, h=10, w=12)
            sub = "nested" if i % 2 else ""
            path = os.path.join(d, sub, f"{i}{ext}")
            if ext == ".npy":
                np.save(path, arr)
            else:
                Image.fromarray(arr).save(path)
    os.makedirs(os.path.join(root, "empty_class"))
    with open(os.path.join(root, "class_0", "notes.txt"), "w") as f:
        f.write("not an image")


def test_dataset_folder_as_jax(tmp_path):
    root = str(tmp_path)
    _class_folders(root)
    jds, tds = JD.DatasetFolder(root), TD.DatasetFolder(root)
    assert tds.classes == jds.classes and tds.class_to_idx == jds.class_to_idx
    assert [os.path.relpath(p, root) for p, _ in tds.samples] == [
        os.path.relpath(p, root) for p, _ in jds.samples]
    assert tds.targets == jds.targets
    _same_dataset(jds, tds)
    assert tfolder.make_dataset(root, tds.class_to_idx) == \
        jfolder.make_dataset(root, jds.class_to_idx)


def test_dataset_folder_npy_with_transforms_as_jax(tmp_path):
    """The card's data path: ``.npy`` class folders read by ``numpy.load``
    through the numpy transforms, on one seed."""
    root = str(tmp_path)
    _class_folders(root, ext=".npy")

    def pipeline(T):
        return T.Compose([T.RandomCrop(8), T.RandomHorizontalFlip(),
                          T.ToTensor(data_format="HWC"),
                          T.Normalize([0.5, 0.4, 0.3], [0.2, 0.2, 0.2],
                                      data_format="HWC")])

    kw = dict(loader=np.load, extensions=(".npy",))
    jds = JD.DatasetFolder(root, transform=pipeline(JT), **kw)
    tds = TD.DatasetFolder(root, transform=pipeline(TT), **kw)
    assert len(tds) == 12
    random.seed(11)
    want = [jds[i] for i in range(len(jds))]
    random.seed(11)
    got = [tds[i] for i in range(len(tds))]
    for w, g in zip(want, got):
        _same(tuple(w), tuple(g))


def test_dataset_folder_through_spawned_workers(tmp_path):
    """A ``DatasetFolder`` with transforms pickles into the port's
    ``DataLoader`` workers: 2 spawned workers give the batches the main
    process gives (a transform without randomness, so the workers' own
    ``random`` states do not matter)."""
    root = str(tmp_path)
    _class_folders(root, ext=".npy")
    ds = TD.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                          transform=TT.Compose([
                              TT.CenterCrop(8), TT.ToTensor(),
                              TT.Normalize(0.5, 0.25)]))
    clone = pickle.loads(pickle.dumps(ds))
    _same(tuple(ds[5]), tuple(clone[5]))
    sync = tio.DataLoader(ds, batch_size=4, return_numpy=True)
    workers = tio.DataLoader(ds, batch_size=4, num_workers=2,
                             return_numpy=True)
    for a, b in zip(sync, workers, strict=True):
        _same(tuple(a), tuple(b))


def test_image_folder_as_jax(tmp_path):
    root = str(tmp_path)
    _class_folders(root)
    jds, tds = JD.ImageFolder(root), TD.ImageFolder(root)
    assert [os.path.relpath(p, root) for p in tds.samples] == [
        os.path.relpath(p, root) for p in jds.samples]
    _same_dataset(jds, tds)
    assert len(tds[0]) == 1


def test_missing_files_raise_the_jax_message(tmp_path, flowers, voc):
    nope = str(tmp_path / "nope")
    cases = [
        ("MNIST", dict(image_path=nope + ".gz", label_path=nope + "2.gz")),
        ("Cifar10", dict(data_file=nope + ".tar.gz")),
        ("Flowers", dict(flowers, data_file=nope + ".tgz")),
        ("VOC2012", dict(data_file=nope + ".tar")),
    ]
    for name, kw in cases:
        with pytest.raises(FileNotFoundError) as want:
            getattr(JD, name)(**kw)
        with pytest.raises(FileNotFoundError) as got:
            getattr(TD, name)(**kw)
        assert str(got.value) == str(want.value)
    os.makedirs(tmp_path / "empty")
    for D in (JD, TD):
        with pytest.raises(RuntimeError, match="no class folders"):
            D.DatasetFolder(str(tmp_path / "empty"))


def test_default_root_and_names_as_jax():
    assert tio_dataset.DEFAULT_DATA_ROOT == jio_dataset.DEFAULT_DATA_ROOT
    assert tvision.__all__ == jvision.__all__
    assert TD.__all__ == JD.__all__
    assert set(JT.__all__ if hasattr(JT, "__all__") else []) <= set(
        TT.__all__)
    for name in [n for n in dir(JT) if not n.startswith("_")]:
        assert hasattr(TT, name), name
    for name in JTF.__all__:
        assert hasattr(TTF, name), name
    import paddle_tpu.vision.ops as jops

    for name in jops.__all__:
        assert hasattr(tvision.ops, name), name
