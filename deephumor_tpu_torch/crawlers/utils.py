"""Crawler helpers (counterpart of deephumor_tpu/crawlers/utils.py)."""

import os
import shutil

__all__ = ["time_to_str", "load_image"]


def time_to_str(seconds):
    """``MM:SS.ss`` for progress lines."""
    return f"{int(seconds / 60.0):3d}:{(seconds % 60.0):05.2f}"


def load_image(image_url, save_dir=".", session=None):
    """Downloads an image into ``save_dir``, named by the URL's tail;
    returns that name. Needs ``requests``."""
    import requests

    get = (session or requests).get
    # a stalled image host must not hold a worker thread forever (the
    # crawl joins its pool on exit)
    r = get(image_url, stream=True, timeout=30)
    file_name = image_url.split("/")[-1]
    with open(os.path.join(save_dir, file_name), "wb") as out:
        shutil.copyfileobj(r.raw, out)
    return file_name
