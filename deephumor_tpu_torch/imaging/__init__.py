"""Meme caption rendering (counterpart of deephumor_tpu/imaging).

The renderer needs Pillow, which a machine that only serves captions may
lack, so ``caption`` (and with it PIL) is imported at the first use of
one of these names, not with the package.
"""

import importlib

__all__ = ["memeify_image", "get_maximal_font", "split_to_lines",
           "caption_image", "default_font_path"]


def __getattr__(name):
    if name in __all__:
        caption = importlib.import_module(
            "deephumor_tpu_torch.imaging.caption")
        return getattr(caption, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
