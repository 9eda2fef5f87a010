"""HTML parsers of memegenerator.net pages.

Counterpart of deephumor_tpu/crawlers/parsers.py: pure functions of a
page's bytes, so they run on canned HTML without HTTP. The template grid
and the caption tiles are ``div.char-img`` nodes, scores are
comma-grouped integers, and the top and bottom texts sit in
``optimized-instance-text0/1`` divs. Needs ``lxml``.
"""

import re

__all__ = ["parse_templates_page", "parse_template_captions_page"]

# a leading digit is required: a bare comma run would reach int("")
_SCORE_PATTERN = re.compile(r"(-?\d[\d,]*)")


def parse_templates_page(content):
    """The all-time-popular template grid (HTML bytes or str) as a list of
    ``{label, link, src}`` dicts."""
    from lxml import html

    tree = html.fromstring(content)
    templates = []
    for anchor in tree.xpath('//div[@class="char-img"]/a'):
        img = anchor.find("img")
        if img is None:
            continue
        templates.append({"label": img.get("alt"),
                          "link": anchor.get("href"),
                          "src": img.get("src")})
    return templates


def parse_template_captions_page(content):
    """One captions page of a template as ``(label, [(score, top_text,
    bottom_text), ...])``."""
    from lxml import html

    tree = html.fromstring(content)
    labels = tree.xpath("//h1/a/text()")
    label = labels[0] if labels else None

    memes = []
    for div in tree.xpath('//div[@class="char-img"]'):
        score_texts = div.xpath('.//div[contains(@class, "score")]/text()')
        if not score_texts:
            continue
        match = _SCORE_PATTERN.search(score_texts[0])
        if match is None:
            continue
        score = int(match.group(1).replace(",", ""))
        top = div.xpath('a//div[@class="optimized-instance-text0"]/text()')
        bottom = div.xpath('a//div[@class="optimized-instance-text1"]/text()')
        memes.append((score, top[0] if top else "",
                      bottom[0] if bottom else ""))
    return label, memes
