"""Vision transforms and ``gluon.utils`` against the JAX package on the
CPU. Transforms are bit for bit where they are exact (crops, flips,
casts, ToTensor, Normalize, the jitters, all drawing from numpy's global
RNG); ``Resize`` and ``RandomResizedCrop`` are bilinear with an
antialiasing filter on a downscale in both (``jax.image.resize``,
``F.interpolate(antialias=True)``), equal within 1e-3 absolute on the
0-255 scale (measured: 2.3e-4 at most, on the upscale; the two filters
sum the same triangle weights in another order)."""
import warnings

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

jT, tT = jmx.gluon.data.vision.transforms, mt.gluon.data.vision.transforms


def _img(shape=(12, 10, 3), seed=0):
    return onp.random.RandomState(seed).randint(0, 255, shape).astype("uint8")


def _run(T, make, img, seed=21):
    onp.random.seed(seed)
    t = make(T)
    return [onp.asarray(t(img)) for _ in range(4)]


EXACT = {
    "cast": lambda T: T.Cast("float16"),
    "totensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.1, 0.2, 0.3), (0.5, 0.25, 2.0))]),
    "centercrop": lambda T: T.CenterCrop((6, 5)),
    "randomcrop": lambda T: T.RandomCrop(7, pad=2),
    "flips": lambda T: T.Compose([T.RandomFlipLeftRight(),
                                  T.RandomFlipTopBottom()]),
    "jitters": lambda T: T.Compose([T.RandomBrightness(0.3),
                                    T.RandomContrast(0.2),
                                    T.RandomSaturation(0.4),
                                    T.RandomLighting(0.1)]),
    "fn": lambda T: T.Compose([lambda x: x[::2], T.Cast("int32")]),
}

RESIZED = {
    "down": lambda T: T.Resize((5, 4)),
    "up": lambda T: T.Resize(20),
    "keep_ratio": lambda T: T.Resize(6, keep_ratio=True),
    "resized_crop": lambda T: T.RandomResizedCrop(8),
}


def test_exact_transforms_bit_for_bit():
    img = _img()
    for name, make in EXACT.items():
        got, want = _run(tT, make, img), _run(jT, make, img)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.tobytes() == w.tobytes(), name
    gray = _img((6, 6), 1)
    assert tT.ToTensor()(gray).tobytes() == \
        onp.asarray(jT.ToTensor()(gray)).tobytes()


def test_resize_within_its_tolerance():
    img = _img((17, 23, 3), 2)
    for name, make in RESIZED.items():
        got, want = _run(tT, make, img), _run(jT, make, img)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == onp.float32 and g.shape == w.shape
            err = float(onp.abs(g - w).max())
            assert err <= 1e-3, (name, err)


def test_split_data_and_split_and_load():
    x = onp.arange(2 * 10 * 3, dtype="f").reshape(2, 10, 3)
    for num, axis, even in ((1, 0, True), (2, 1, True), (3, 1, False),
                            (4, 1, False), (5, 1, True)):
        want = jmx.gluon.utils.split_data(jmx.np.array(x), num, axis, even)
        with mt.cpu():
            got = mt.gluon.utils.split_data(mt.np.array(x), num, axis, even)
            loaded = mt.gluon.utils.split_and_load(x, [mt.cpu()] * num,
                                                   axis, even)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, lo, w in zip(got, loaded, want):
            assert g.asnumpy().tobytes() == w.asnumpy().tobytes()
            assert lo.asnumpy().tobytes() == w.asnumpy().tobytes()
            assert lo._data.device.type == "cpu"
    for module in (jmx, mt):
        with pytest.raises(ValueError), mt.cpu():
            module.gluon.utils.split_data(module.np.array(x), 3, 1)
        with pytest.raises(ValueError), mt.cpu():
            module.gluon.utils.split_data(module.np.array(x), 3, 0, False)


def test_clip_global_norm():
    """Return value, scale and the non-finite warning; ``check_isfinite=
    False`` returns the norm as an NDArray and scales on the device.
    Parameter gradients (tensors in the port) are taken too."""
    r = onp.random.RandomState(6)
    vals = [r.randn(4, 3).astype("f") * 3, r.randn(7).astype("f")]
    for max_norm, check in ((1.0, True), (100.0, True), (1.0, False)):
        jarr = [jmx.np.array(v) for v in vals]
        with mt.cpu():
            tarr = [mt.np.array(v) for v in vals]
        jn = jmx.gluon.utils.clip_global_norm(jarr, max_norm, check)
        tn = mt.gluon.utils.clip_global_norm(tarr, max_norm, check)
        assert type(tn).__name__ == type(jn).__name__
        onp.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for t, j in zip(tarr, jarr):
            onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                        atol=1e-7)
    grads = [mt.np.array(v, device=mt.cpu())._data for v in vals]
    mt.gluon.utils.clip_global_norm(grads, 1.0)
    total = sum(float((g ** 2).sum()) for g in grads) ** 0.5
    assert abs(total - 1.0) < 1e-5
    bad = [v.copy() for v in vals]
    bad[1][2] = onp.nan
    msgs = {}
    for name, module in (("jax", jmx), ("port", mt)):
        with mt.cpu():
            arr = [module.np.array(v) for v in bad]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            norm = module.gluon.utils.clip_global_norm(arr, 1.0)
        assert onp.isnan(norm)
        msgs[name] = [str(m.message) for m in w
                      if "nan or inf" in str(m.message)]
        onp.testing.assert_array_equal(arr[0].asnumpy(), bad[0])
    assert msgs["port"] == msgs["jax"] and len(msgs["port"]) == 1
    assert "#1 (7,)/float32 (1 of 2 non-finite)" in msgs["port"][0]


def test_check_sha1_download_hooks_and_shapes(tmp_path):
    f = tmp_path / "weights.bin"
    f.write_bytes(b"mxnet" * 100)
    import hashlib
    sha1 = hashlib.sha1(f.read_bytes()).hexdigest()
    for module in (jmx, mt):
        u = module.gluon.utils
        assert u.check_sha1(str(f), sha1) and not u.check_sha1(str(f), "0")
        url = "https://example.invalid/models/weights.bin"
        assert u.download(url, path=str(f), sha1_hash=sha1) == str(f)
        assert u.download(url, path=str(tmp_path)) == str(f)
        with pytest.raises(OSError):
            u.download(url, path=str(f), sha1_hash="0" * 40)
        with pytest.raises(OSError):
            u.download(url, path=str(tmp_path / "missing.bin"))
        with pytest.raises(OSError):
            u.download(url, path=str(f), overwrite=True)
        hooks = {}
        h1, h2 = u.HookHandle(), u.HookHandle()
        h1.attach(hooks, print)
        h2.attach(hooks, print)
        assert len(hooks) == 2
        with h1:
            pass
        assert list(hooks.values()) == [print]
        h2.detach()
        assert hooks == {}
        assert [u.shape_is_known(s) for s in
                (None, (2, 3), (2, None), (0, 4), (-1, 2))] == \
            [False, True, False, True, False]
