"""The port's fused pixel pipeline (``dgtd_tpu_torch/native``) vs the JAX
package's (``dgtd_tpu/native/pixelops.py``): the same pixels bit for bit on
random uint8 images of odd sizes, 1 and 3 channels, flip on and off; and
eight threads building the library at once each load a whole library.
"""

import ctypes
import threading

import numpy as np
import pytest

from dgtd_tpu.native import pixelops as JP
from dgtd_tpu_torch.data.device_norm import IMAGENET_MEAN, IMAGENET_STD
from dgtd_tpu_torch.native import pixelops as PP

#: (source height, width, channels, output height, width): odd sizes, up
#: and down, 1 and 3 channels
CASES = [(37, 23, 3, 48, 48), (40, 52, 1, 29, 61), (31, 31, 3, 17, 17), (5, 97, 1, 64, 33), (1, 1, 3, 7, 9)]


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_port_pixels_equal_jax_pixels(case, flip):
    assert JP.available(), "the JAX package's pixel library did not build"
    sh, sw, c, dh, dw = case
    img = np.random.RandomState(sh * 131 + sw).randint(0, 256, (sh, sw, c)).astype(np.uint8)
    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if c == 3 else (None, None)
    got = PP.resize_normalize(img, (dh, dw), mean, std, flip)
    assert got.dtype == np.float32 and got.shape == (dh, dw, c)
    np.testing.assert_array_equal(got, JP.resize_normalize(img, (dh, dw), mean, std, flip))
    got8 = PP.resize_u8(img, (dh, dw), flip)
    assert got8.dtype == np.uint8 and got8.shape == (dh, dw, c)
    np.testing.assert_array_equal(got8, JP.resize_u8(img, (dh, dw), flip))
    if c == 1:  # an HW plane is taken as one channel
        np.testing.assert_array_equal(PP.resize_u8(img[..., 0], (dh, dw), flip), got8)


def test_eight_threads_build_at_once(tmp_path, monkeypatch):
    """Into an empty build directory: every thread gets a library it can
    load and call, and no temporary file is left behind."""
    monkeypatch.setattr(PP, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build_and_load():
        try:
            path = PP.build()
            lib = ctypes.CDLL(str(path))
            paths.append((path, lib.resize_bilinear_u8 is not None))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=build_and_load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(paths) == 8 and {p for p, _ in paths} == {PP.lib_path()} and all(ok for _, ok in paths)
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted([PP.lib_path().name, "pixelops.lock"])


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, no pixels: the port raises where the JAX package would
    switch to PIL."""
    monkeypatch.setattr(PP, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        PP.build()
