"""Native C++ image loader tests: build, decode parity vs PIL, prefetch
ordering (the array-program replacement for the reference's cv::imread IO
path, Examples/Stereo/stereo_kitti.cc:85)."""

import numpy as np
import pytest
from PIL import Image

from c_orb_slam_tpu.io.native import Prefetcher, decode_gray, native_available
from c_orb_slam_tpu.io.native import loader as loader_mod


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, fmt in enumerate(["png", "png", "jpeg", "pgm"] * 3):
        arr = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        p = d / f"img_{i:03d}.{fmt}"
        if fmt == "pgm":
            with open(p, "wb") as f:
                f.write(b"P5\n64 48\n255\n" + arr.tobytes())
        else:
            Image.fromarray(arr, "L").save(p, format=fmt.upper())
        paths.append((str(p), arr))
    # one RGB png (tests the luma conversion path)
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    p = d / "img_rgb.png"
    Image.fromarray(rgb, "RGB").save(p)
    paths.append((str(p), rgb))
    return paths


def test_native_builds():
    assert native_available(), "g++/libpng/libjpeg present in image - must build"


def test_decode_matches_pil(image_files):
    assert native_available()
    for path, arr in image_files:
        got = decode_gray(path)
        ref = loader_mod._decode_pil(path)
        assert got.shape == ref.shape, path
        # JPEG is lossy and PIL/libjpeg use different luma rounding: allow
        # small differences; exact for PNG gray / PGM.
        tol = 2.0 if (path.endswith("jpeg") or "rgb" in path) else 0.51
        assert np.abs(got - ref).max() <= tol, (path, np.abs(got - ref).max())


def test_prefetcher_order_and_content(image_files):
    assert native_available()
    paths = [p for p, _ in image_files]
    pf = Prefetcher(paths, n_threads=3, ahead=4)
    seen = []
    for idx, img in pf:
        seen.append(idx)
        ref = loader_mod._decode_pil(paths[idx])
        assert img.shape == ref.shape
    pf.close()
    assert seen == list(range(len(paths))), "frames out of order"


if __name__ == "__main__":
    pytest.main([__file__, "-q", "-x"])
