"""deephumor_tpu_torch's copy of the meme renderer against the JAX
package's: byte-equal images for the same image and captions, top and
bottom, and the same default font."""

import sys

import numpy as np
import pytest
from PIL import Image

from deephumor_tpu import imaging as jim
from deephumor_tpu_torch import imaging as tim

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

CAPTIONS = [("when you ship it", "and it works"),
            ("", "a much longer bottom caption that has to wrap over lines"),
            ("top only, with punctuation?!", ""),
            ("éàü unicode takes the whole-line path", "x")]


def _images():
    rng = np.random.default_rng(0)
    return [Image.fromarray(rng.integers(0, 256, (300, 400, 3),
                                         dtype=np.uint8)),
            Image.new("RGB", (200, 150), (90, 110, 130)),
            Image.fromarray(rng.integers(0, 256, (480, 360, 3),
                                         dtype=np.uint8))]


def test_same_default_font_file():
    assert open(tim.default_font_path(), "rb").read() == open(
        jim.default_font_path(), "rb").read()


@pytest.mark.parametrize("k", range(len(CAPTIONS)))
def test_memeify_is_byte_equal(k):
    top, bottom = CAPTIONS[k]
    for img in _images():
        want = jim.memeify_image(img, top=top, bottom=bottom)
        got = tim.memeify_image(img, top=top, bottom=bottom)
        assert got.mode == want.mode and got.size == want.size
        assert got.tobytes() == want.tobytes()


def test_helpers_match():
    img = _images()[0]
    text = "a caption long enough to be split into several lines here"
    size = int(img.height / 5.4)
    jf = jim.get_maximal_font(img, text, font_size=size)
    tf = tim.get_maximal_font(img, text, font_size=size)
    assert tf.size == jf.size
    assert tim.split_to_lines(img, text, tf) == jim.split_to_lines(img, text,
                                                                   jf)
    lines = jim.split_to_lines(img, text, jf)
    for pos in ("top", "bottom"):
        for border in ("dilate", "grid"):
            want = jim.caption_image(img.copy(), lines, jf, pos=pos,
                                     border=border)
            got = tim.caption_image(img.copy(), lines, tf, pos=pos,
                                    border=border)
            assert got.tobytes() != img.tobytes()
            assert got.tobytes() == want.tobytes(), (pos, border)


def test_pil_is_imported_at_first_use():
    import subprocess

    code = ("import sys; import deephumor_tpu_torch.imaging, "
            "deephumor_tpu_torch.pipeline; "
            "assert 'PIL' not in sys.modules, 'PIL imported early'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
