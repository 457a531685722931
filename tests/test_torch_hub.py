"""The port's predictor API held to the JAX hub, which resizes with cv2.

``_hwc3`` equals JAX's; ``_resize_multiple_of_64`` (torch, cv2's fixed-point
LANCZOS4 and INTER_AREA on uint8) equals the JAX function's cv2.resize,
every code, on shapes that take each of cv2's paths (readings: 0 differing
pixels on these and on 57 random shapes); the float32 INTER_LINEAR resize
back is within 1e-6 of cv2's. ``BasePredictor`` on a tiny published-layout
checkpoint (tests/test_torch_checkpoint.py's) in f32 against JAX's: depth
within the pipeline tests' bar (mean abs deviation <= 1e-4), normal mode's
uint8 within 1 code.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from genpercept_tpu import hub as jax_hub
from genpercept_tpu_torch import hub
from genpercept_tpu_torch.ops.resize import resize_linear_halfpixel
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from test_torch_pipeline import MEAN_TOL

torch.set_num_threads(1)

LINEAR_TOL = 1e-6  # float32 rounding of two lerps of values in [0, 1]


@pytest.mark.parametrize("shape", [(30, 20), (30, 20, 1), (30, 20, 3), (30, 20, 4)])
def test_hwc3_matches_jax(shape):
    x = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(hub._hwc3(x), jax_hub._hwc3(x))


# (h, w, resolution): cv2's path
RESIZE_CASES = [
    (48, 40, 64),     # LANCZOS4 up, both axes
    (300, 500, 512),  # LANCZOS4 up at a non-integer factor
    (13, 17, 64),     # LANCZOS4 up, taps past both borders
    (1024, 768, 384),  # AREA down by 2 x 2 (cv2's vector path)
    (1536, 1536, 512),  # AREA down by 3 x 3
    (1000, 1500, 768),  # AREA down at a non-integer factor
    (519, 640, 256),  # AREA down, 2 across and non-integer down
    (100, 1000, 100),  # AREA with both axes growing (k = 1 rounds up to 128 x 1024)
    (129, 688, 128),  # AREA, one axis shrinking, the other growing
]


@pytest.mark.parametrize("h,w,res", RESIZE_CASES)
def test_resize_multiple_of_64_matches_cv2(h, w, res):
    x = np.random.default_rng(h * w + res).integers(0, 256, (h, w, 3), dtype=np.uint8)
    ref = jax_hub._resize_multiple_of_64(x, res)
    ours = hub._resize_multiple_of_64(x, res)
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and float((diff > 0).mean()) == 0.0, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("src,dst,c", [((64, 64), (48, 40), 1), ((48, 64), (480, 640), 3),
                                       ((576, 768), (480, 640), 1), ((33, 65), (7, 1), 3)])
def test_resize_back_matches_cv2_linear(src, dst, c):
    import cv2

    x = np.random.default_rng(1).uniform(size=src + (c,)).astype(np.float32)
    ref = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR).reshape(dst + (c,))
    ours = resize_linear_halfpixel(torch.from_numpy(x)[None], dst)[0].numpy()
    assert float(np.abs(ours - ref).max()) <= LINEAR_TOL


@pytest.fixture(scope="module")
def image():
    return (np.random.default_rng(2).uniform(size=(48, 40, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["depth", "normal"])
def test_base_predictor_matches_jax(ckpts, image, mode):  # noqa: F811
    path = str(ckpts["plain"][0])
    ref = jax_hub.BasePredictor(path, mode, resolution=64, half_precision=False)
    ours = hub.BasePredictor(path, mode, resolution=64, half_precision=False, device="cpu")
    a, b = ours.infer_rgb(image), ref.infer_rgb(image)
    assert a.shape == b.shape == image.shape[:2] + ((3,) if mode == "normal" else ())
    if mode == "normal":
        assert a.dtype == b.dtype == np.uint8
        assert int(np.abs(a.astype(int) - b).max()) <= 1
    else:
        assert float(np.mean(np.abs(a - b))) <= MEAN_TOL
    # the entry points agree with each other
    np.testing.assert_array_equal(ours.infer_pil(Image.fromarray(image)), a)
    np.testing.assert_array_equal(ours.infer_cv2(np.ascontiguousarray(image[..., ::-1])), a)


def test_base_predictor_is_the_pipeline_resized_back(ckpts, image):  # noqa: F811
    """chip_smoke.py's hub check, here: the prediction is the pipeline's on
    the resized image, resized back."""
    pred = hub.GenPercept_Depth(str(ckpts["plain"][0]), resolution=64, device="cpu")
    x = hub._resize_multiple_of_64(image, 64)
    direct = pred.pipe(x, color_map=None).pred_np
    back = resize_linear_halfpixel(torch.from_numpy(direct)[None, ..., None], image.shape[:2])
    np.testing.assert_array_equal(pred.infer_rgb(image), back[0, ..., 0].numpy())


def test_predictor_defaults_match_jax_and_the_card(ckpts, monkeypatch):  # noqa: F811
    import inspect

    ours = inspect.signature(hub.BasePredictor).parameters
    ref = inspect.signature(jax_hub.BasePredictor).parameters
    assert {k: v.default for k, v in ref.items()} == \
        {k: ours[k].default for k in ref}
    assert ours["device"].default == "cuda"
    for name in ("Depth", "Normal", "Segmentation", "Matting", "Disparity"):
        assert callable(getattr(hub, f"GenPercept_{name}"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        hub.GenPercept_Depth(str(ckpts["plain"][0]))
