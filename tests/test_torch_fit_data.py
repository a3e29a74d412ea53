"""The fitting stage's data on the CPU: the port's baseline JPEG codec
(honerf_torch.utils.jpeg), the catch-sequence generator and the fit
loader (honerf_torch.data.fit_datasets) against the JAX package's.

Measured tolerances of the codec (8-bit levels), on this file's test
image: decoding PIL's quality 95 files, 4:4:4, 4:2:2 and 4:2:0, differs
from PIL's own decode by at most 3 (measured 3, 2, 2), 0.014-0.017 on
average and by more than 1 at 0.2-0.3% of the values (a float IDCT here,
libjpeg's integer one there; the same fancy chroma upsampling); the
limits are max 3, mean 0.05, 1% above 1.  PIL decodes the port's files
to within 2 of the port's decode (limit 3), and those files sit 0.87 on
average from the encoded image (limit 1).
"""

import io
import sys

import numpy as np
import pytest
from PIL import Image

from honerf_torch.data import fit_datasets as TFD
from honerf_torch.data.synthetic import generate_catch_sequence
from honerf_torch.utils import jpeg


def _image(H=75, W=98, seed=0):
    """Shapes, gradients and noise, with a ragged edge (W, H not multiples
    of 16)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    img = np.zeros((H, W, 3), np.int64)
    disk = (yy - H / 2) ** 2 + (xx - W / 3) ** 2 < (H / 3) ** 2
    img[disk] = np.stack([3 * xx, 2 * yy, xx + yy], -1)[disk] % 256
    img[5:20, W - 30:W - 4] = [200, 30, 90]
    img += rng.integers(-4, 5, img.shape) * (img > 0)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, subsampling):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95, subsampling=subsampling)
    return buf.getvalue()


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_decoder_reads_pil_files(subsampling):
    data = _pil_jpeg(_image(), subsampling)
    got = jpeg.decode(data).astype(np.int64)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(np.int64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= 3 and err.mean() <= 0.05 and (err > 1).mean() <= 0.01


def test_pil_reads_encoder_files():
    img = _image()
    data = jpeg.encode(img, quality=95)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(np.int64)
    assert pil.shape == img.shape
    assert np.abs(pil - jpeg.decode(data)).max() <= 3
    assert np.abs(pil - img).mean() <= 1.0
    with pytest.raises(ValueError):
        jpeg.decode(b"not a jpeg")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", progressive=True)
    with pytest.raises(ValueError, match="baseline"):
        jpeg.decode(buf.getvalue())


def test_catch_sequence_loads_like_jax(tmp_path, monkeypatch):
    """The port's sequence read by the JAX loader and by the port's, both
    through PIL here, gives the same arrays; the port's own decoder (no
    cv2, no PIL) the same cameras and images within the codec's
    tolerance."""
    from honerf_tpu.data import fit_datasets as JFD

    root = str(tmp_path / "catch")
    generate_catch_sequence(root, n_frames=1, n_views=8, H=48, W=56)
    assert TFD.list_fit_sequences(root) == JFD.list_fit_sequences(root)
    args = (root, "person1_bean", "seq0", "8", "1")
    want = JFD.load_fit_sequence(*args, image_hw=(48, 56))
    got = TFD.load_fit_sequence(*args, image_hw=(48, 56))
    for k in ("t_pose_21", "bone_length", "obj_verts", "obj_faces"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.hand_model_path, got.obj_model_path) == (want.hand_model_path,
                                                         want.obj_model_path)
    for gf, wf in zip(got.frames, want.frames):
        for k in ("joints_pred", "obj_pose_pred", "joints_gt", "Ro_gt", "To_gt"):
            np.testing.assert_array_equal(getattr(gf, k), getattr(wf, k))
        for gv, wv in zip(gf.views, wf.views):
            for k in ("image", "mask", "cam_R", "cam_T", "focal", "principal", "proj"):
                np.testing.assert_array_equal(getattr(gv, k), getattr(wv, k))
    assert sum(float(v.mask.sum()) for v in got.frames[0].views) > 0

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    own = TFD.load_fit_sequence(*args, image_hw=(48, 56))
    for ov, wv in zip(own.frames[0].views, want.frames[0].views):
        np.testing.assert_array_equal(ov.proj, wv.proj)
        assert np.abs(ov.image - wv.image).max() <= 3 / 255 + 1e-6
        assert (ov.mask != wv.mask).mean() <= 0.01
