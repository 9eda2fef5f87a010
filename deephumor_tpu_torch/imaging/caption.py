"""Impact-style meme caption renderer (PIL and numpy only).

A copy of deephumor_tpu/imaging/caption.py, so that the port renders
byte-equal memes without importing the JAX package. The contract is the
reference renderer's: uppercase text, the largest font that fits the
image width, greedy word-preserving line wrap, a black border of
``font_size // 18`` px under white fill, top text anchored at the top and
bottom text at ``0.987 * height``. Measurement uses ``getbbox`` (Pillow
>= 10) and reproduces the legacy (width, height-with-offset) numbers.

This module imports PIL; ``deephumor_tpu_torch.imaging`` imports it on
first use, so the rest of the port runs without Pillow.
"""

import functools
import math
import os
import threading

import numpy as np
from PIL import Image, ImageDraw, ImageFont

__all__ = ["memeify_image", "get_maximal_font", "split_to_lines", "caption_image"]

# The packaged fonts are data files of the JAX package's imaging folder,
# named here by their path in the repository and read as files: the port
# does not import that package. The order is the JAX package's, so both
# resolve the same default face. A real impact.ttf dropped into that
# folder (the reference's non-free font, not redistributed) comes first;
# then a system Impact; then "DeepHumor Condensed", the packaged
# condensed DejaVu Sans Bold derivative (license: DEJAVU-LICENSE there);
# then the unmodified DejaVu Sans Bold, which the golden-image tests pin.
_FONT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "deephumor_tpu", "imaging", "fonts")
_FONT_CANDIDATES = (
    os.path.join(_FONT_DIR, "impact.ttf"),
    "/usr/share/fonts/truetype/msttcorefonts/Impact.ttf",
    os.path.join(_FONT_DIR, "condensed.ttf"),
    os.path.join(_FONT_DIR, "default.ttf"),
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
)


def packaged_font_path():
    """The unmodified DejaVu Sans Bold packaged in the repository."""
    return os.path.join(_FONT_DIR, "default.ttf")


def condensed_font_path():
    """The packaged impact-style face (DeepHumor Condensed), the default
    meme font when no real impact.ttf is installed."""
    return os.path.join(_FONT_DIR, "condensed.ttf")


def default_font_path():
    for path in _FONT_CANDIDATES:
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        "No usable meme font found; pass font_path= explicitly"
    )


_FONT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=512)
def _load_font(font_path, size):
    """Cached truetype load — the font-fitting search instantiates dozens
    of sizes per meme, and the same sizes recur across a batch render.
    FreeType face loading isn't thread-safe, hence the lock."""
    with _FONT_LOCK:
        return ImageFont.truetype(font_path, size)


@functools.lru_cache(maxsize=4096)
def _measured_size(font_path, font_size, text):
    fast = _measurer_for(_load_font(font_path, font_size))
    if fast is not None:
        return fast.measure(text)
    left, top, right, bottom = _load_font(font_path, font_size).getbbox(text)
    return right, bottom


def _text_size(text, font):
    """(width, height) of ``text`` in ``font``, legacy-getsize compatible.

    Pillow's legacy ``getsize`` returned ``(width, bottom)`` of the bbox at
    origin; ``getbbox`` gives (x0, y0, x1, y1) so width=x1, height=y1.
    Memoized when the font is a plain path-loaded face: the fit/wrap/draw
    pipeline measures the same (text, font) pair 2-3 times per meme, and
    the font-fit searches re-measure the same probe strings across a
    batch render (FreeType shaping is ~40% of an uncached render).
    Buffer-loaded or customized fonts (no usable ``.path``, variations,
    non-default layout engine) are measured directly — correctness over
    the cache.
    """
    path = getattr(font, "path", None)
    if isinstance(path, str) and _load_font(path, font.size) is font:
        return _measured_size(path, font.size, text)
    left, top, right, bottom = font.getbbox(text)
    return right, bottom


def get_maximal_font(img, text, font_size=64, text_width=0.94, font_path=None):
    """Largest font size (starting at ``font_size``, decreasing) such that
    ``text`` fits in ``text_width`` of the image width.

    Parity: reference caption.py:41-64.
    """
    font_path = font_path or default_font_path()
    font = _load_font(font_path, font_size)
    w, _ = _text_size(text, font)
    while w > img.width * text_width and font_size > 1:
        font_size -= 1
        font = _load_font(font_path, font_size)
        w, _ = _text_size(text, font)
    return font


def _get_initial_font(img, texts, max_chars=20, font_path=None):
    """Initial font: sized for a 'G'*min(longest_text, max_chars) line at
    height/5.4 (reference caption.py:66-89)."""
    max_len = max(map(len, texts))
    max_len = max_len if max_len < max_chars else max_chars
    longest_text = "G" * max_len
    font_size = int(img.height / 5.4)
    return get_maximal_font(img, longest_text, font_size, font_path=font_path)


def _get_final_font(img, text_lines, font_path=None):
    """Refit the font over all wrapped lines (reference caption.py:92-115)."""
    font_path = font_path or default_font_path()
    font_size = int(img.height / 5.4) // max(map(len, text_lines))
    font = _load_font(font_path, font_size)

    flat = [text for lines in text_lines for text in lines]
    widths = [_text_size(t, font)[0] for t in flat]
    longest_text = flat[widths.index(max(widths))]
    return get_maximal_font(img, longest_text, font_size, font_path=font_path)


def split_to_lines(img, text, font):
    """Greedy word-preserving wrap of ``text`` into image-width lines.

    Parity: reference caption.py:118-173 — the estimated line count comes
    from total text width; cut points land on spaces; a line that still
    overflows 95% of the width backs off by one word.
    """
    text = text.upper()
    w, _ = _text_size(text, font)

    line_count = 1
    if w > img.width:
        line_count = w // img.width + 1

    lines = []
    if line_count > 1:
        last_cut = 0
        is_last = False
        for i in range(line_count):
            cut = (len(text) // line_count) * i if last_cut == 0 else last_cut
            if i < line_count - 1:
                next_cut = (len(text) // line_count) * (i + 1)
            else:
                next_cut = len(text)
                is_last = True

            # do not cut words in half; if the text has no further space
            # (one giant word), hard-cut mid-word instead of the reference's
            # unbounded scan (caption.py:155-157 IndexError — documented fix)
            if not (next_cut == len(text) or text[next_cut] == " "):
                space = text.find(" ", next_cut)
                next_cut = space if space != -1 else next_cut

            line = text[cut:next_cut].strip()

            # back off by a word if the line still overflows
            w, _ = _text_size(line, font)
            if not is_last and w > img.width * 0.95:
                prev_space = text.rfind(" ", 0, next_cut)
                if prev_space > cut:
                    next_cut = prev_space

            last_cut = next_cut
            lines.append(text[cut:next_cut].strip())
    else:
        lines.append(text)

    return lines


def _dilate(arr, b):
    """Square max-filter dilation of a uint8 mask, zero-padded by ``b``
    on every side (separable: two shift-max passes)."""
    h, w = arr.shape
    out = np.zeros((h + 2 * b, w + 2 * b), np.uint8)
    out[b:b + h, b:b + w] = arr
    tmp = out.copy()
    for s in range(1, b + 1):
        np.maximum(tmp[:, s:], out[:, :-s], out=tmp[:, s:])
        np.maximum(tmp[:, :-s], out[:, s:], out=tmp[:, :-s])
    dil = tmp.copy()
    for s in range(1, b + 1):
        np.maximum(dil[s:, :], tmp[:-s, :], out=dil[s:, :])
        np.maximum(dil[:-s, :], tmp[s:, :], out=dil[:-s, :])
    return dil


# Glyph-compose fast path: only printable ASCII is eligible — outside
# it, contextual shaping (ligatures, combining marks, complex scripts)
# can make an isolated glyph's raster differ from its in-context one.
# Meme text is drawn uppercased, so real traffic is entirely inside.
_COMPOSE_SAFE = frozenset(chr(c) for c in range(0x20, 0x7F))


class _LineComposer:
    """Rebuilds a line's rasterized mask from per-glyph rasters.

    ``font.getmask2(line)`` re-shapes and re-rasterizes every glyph on
    every call — ~60% of the meme render wall time, dominated by
    FreeType/HarfBuzz per-call overhead rather than pixel work. Captions
    vary per meme but draw from the same glyph set, so this caches:

      - ``advance(c)  = getlength(c)``,
      - ``kern(a, b)  = getlength(a+b) - getlength(a) - getlength(b)``
        (pairwise GPOS kerning — for Latin text HarfBuzz applies exactly
        these pair adjustments, so cumulative pen positions rebuilt from
        them equal the full-line shape's),
      - the glyph raster per (char, 1/64-subpixel x/y phase) — pen
        positions live in 26.6 fixed point, so ``getlength`` values are
        exact multiples of 1/64 and float accumulation is lossless;
        phases quantize to 64 bins and only a handful occur in practice.

    The composed mask's INK is byte-identical to ``getmask2``'s (its
    bounding box differs — PIL pads the line box to the advance width;
    the surrounding empty columns paste as no-ops, so the rendered image
    is pixel-identical; ``tests/test_imaging.py`` asserts this against
    ``ImageDraw.text``).
    """

    def __init__(self, font):
        self.font = font
        # one lock per (path, size) face, shared with the measurement
        # learner (_FastMeasure references it): the pipeline renders on a
        # thread pool, and the learned caches' multi-step updates are not
        # GIL-atomic. Rendering threads are GIL-bound anyway (FreeType
        # holds the GIL), so serializing them costs nothing real.
        self.lock = threading.RLock()
        self._adv = {}
        self._kern = {}
        self._glyphs = {}
        self._pair_ok = {}
        self._words = {}  # (word, px64, py64) -> composed raster or None

    def _advance(self, c):
        a = self._adv.get(c)
        if a is None:
            a = self._adv[c] = self.font.getlength(c)
        return a

    def _kerning(self, a, b):
        k = self._kern.get((a, b))
        if k is None:
            k = self.font.getlength(a + b) - self._advance(a) \
                - self._advance(b)
            self._kern[(a, b)] = k
        return k

    def _glyph(self, ch, px, py):
        key = (ch, round(px * 64), round(py * 64))
        g = self._glyphs.get(key, False)
        if g is False:
            m, (dx, dy) = self.font.getmask2(ch, "L", start=(px, py))
            w, h = m.size
            g = None if w == 0 or h == 0 else (
                np.frombuffer(bytes(m), np.uint8).reshape(h, w), dx, dy)
            self._glyphs[key] = g
        return g

    def _pair_safe(self, a, b):
        """True iff the pair shapes decomposably — i.e. blitting the two
        glyphs at kern-adjusted pen positions reproduces ``getmask2(a+b)``
        ink exactly. A ligature (HarfBuzz substituting one glyph for the
        sequence, e.g. fi/fl) or any other contextual effect fails this
        once, is cached, and sends lines containing the pair down the
        whole-line rasterizer. Validated at phase 0 — substitution is
        phase-independent."""
        ok = self._pair_ok.get((a, b))
        if ok is None:
            pair = a + b
            ref, (rdx, rdy) = self.font.getmask2(pair, "L",
                                                 start=(0.0, 0.0))
            rw, rh = ref.size
            got = self._compose_raw(pair, 0.0, 0.0)
            if got is None:
                ok = rw == 0 or rh == 0 or not bytes(ref).strip(b"\0")
            else:
                arr, gx, gy = got
                cx0 = min(gx, rdx); cy0 = min(gy, rdy)
                cx1 = max(gx + arr.shape[1], rdx + rw)
                cy1 = max(gy + arr.shape[0], rdy + rh)
                a_c = np.zeros((cy1 - cy0, cx1 - cx0), np.uint8)
                a_c[gy - cy0:gy - cy0 + arr.shape[0],
                    gx - cx0:gx - cx0 + arr.shape[1]] = arr
                b_c = np.zeros_like(a_c)
                if rw and rh:
                    b_c[rdy - cy0:rdy - cy0 + rh,
                        rdx - cx0:rdx - cx0 + rw] = np.frombuffer(
                            bytes(ref), np.uint8).reshape(rh, rw)
                ok = np.array_equal(a_c, b_c)
            self._pair_ok[(a, b)] = ok
        return ok

    def compose(self, line, fx, fy):
        """Ink mask of ``line`` at subpixel start ``(fx, fy)``.

        Returns ``(arr, x0, y0)`` — uint8 ink bitmap and its offset from
        the integer anchor (same meaning as ``getmask2``'s offset) — or
        ``None`` for no ink. Returns the string ``"unsafe"`` when the
        line contains a pair that does not shape decomposably (caller
        must use the whole-line rasterizer).
        """
        with self.lock:
            return self._compose_impl(line, fx, fy)

    def _compose_impl(self, line, fx, fy):
        pair_ok = self._pair_ok
        prev = line[0] if line else None
        for b in line[1:]:
            ok = pair_ok.get((prev, b))
            if ok is None:
                ok = self._pair_safe(prev, b)
            if not ok:
                return "unsafe"
            prev = b
        return self._compose_words(line, fx, fy)

    def _compose_words(self, line, fx, fy):
        """Word-memoized composition: meme captions repeat words heavily,
        so each space-free run's composed raster is cached by its 1/64
        entry-pen phase and blitted whole. Pen arithmetic is identical to
        the glyph path (advances + pairwise kerns in exact 26.6 sums).
        Words are blitted disjointly; if two words' rasters would overlap
        (pathological overhang across a space) the whole line falls back
        to glyph-by-glyph composition so blend order stays exact.

        Cache-key soundness: rasters are keyed by the entry pen's 1/64
        phase bin. FreeType rounds a subpixel start to the nearest 1/64
        (verified empirically: ink-level equality across 2100 within-bin
        probes incl. the wrap at phase 64/64, where the returned offset
        absorbs the carried pixel), so within-bin reuse is ink-exact."""
        words = self._words
        if len(words) > 16384:  # bound raster memory, keep the warm half
            for k in list(words)[:8192]:
                del words[k]
        pieces = []
        pen = fx
        prev = None
        i, n = 0, len(line)
        while i < n:
            ch = line[i]
            if ch == " ":
                if prev is not None:
                    pen += self._kerning(prev, ch)
                pen += self._advance(ch)
                prev = ch
                i += 1
                continue
            j = i
            while j < n and line[j] != " ":
                j += 1
            word = line[i:j]
            if prev is not None:
                pen += self._kerning(prev, word[0])
            ipen = math.floor(pen)
            px = pen - ipen
            key = (word, round(px * 64), round(fy * 64))
            got = words.get(key, False)
            if got is False:
                got = self._compose_raw(word, px, fy)
                words[key] = got
            if got is not None:
                arr, x0, y0 = got
                pieces.append((arr, ipen + x0, y0))
            # pen after the word: internal advances + kerns
            pw = 0.0
            wprev = None
            for wc in word:
                if wprev is not None:
                    pw += self._kerning(wprev, wc)
                pw += self._advance(wc)
                wprev = wc
            pen += pw
            prev = word[-1]
            i = j
        if not pieces:
            return None
        x0 = min(p[1] for p in pieces)
        y0 = min(p[2] for p in pieces)
        x1 = max(p[1] + p[0].shape[1] for p in pieces)
        y1 = max(p[2] + p[0].shape[0] for p in pieces)
        out = np.zeros((y1 - y0, x1 - x0), np.uint8)
        written_x1 = None
        for arr, ox, oy in pieces:
            h, w = arr.shape
            c0 = ox - x0
            if written_x1 is not None and c0 < written_x1:
                # overlapping words: redo the whole line glyph-by-glyph
                # (blend order must follow glyphs, not composed words)
                return self._compose_raw(line, fx, fy)
            out[oy - y0:oy - y0 + h, c0:c0 + w] = arr
            written_x1 = c0 + w
        return out, x0, y0

    def _compose_raw(self, line, fx, fy):
        pieces = []
        x0 = y0 = x1 = y1 = None
        pen = fx
        prev = None
        for ch in line:
            if prev is not None:
                pen += self._kerning(prev, ch)
            ipen = math.floor(pen)
            g = self._glyph(ch, pen - ipen, fy)
            if g is not None:
                arr, dx, dy = g
                ox = ipen + dx
                pieces.append((arr, ox, dy))
                h, w = arr.shape
                if x0 is None:
                    x0, y0, x1, y1 = ox, dy, ox + w, dy + h
                else:
                    x0 = min(x0, ox); y0 = min(y0, dy)
                    x1 = max(x1, ox + w); y1 = max(y1, dy + h)
            pen += self._advance(ch)
            prev = ch
        if x0 is None:
            return None
        # Where adjacent glyphs' AA fringes share a pixel, Pillow blends
        # each glyph over the accumulated coverage with its exact
        # integer alpha-over: dst' = src + MULDIV255(dst, 255 - src),
        # MULDIV255(a, b) = (t = a*b + 128; (t + (t >> 8)) >> 8).
        # Blit order = glyph order (the blend is not associative).
        # Most glyphs land right of everything written so far (kerned
        # apart), where the blend degenerates to a copy (dst == 0 ->
        # dst' = src): those blit directly; only the columns overlapping
        # the written extent pay the integer blend.
        out = np.zeros((y1 - y0, x1 - x0), np.uint8)
        written_x1 = None  # right edge (exclusive) of columns written
        for arr, ox, oy in pieces:
            h, w = arr.shape
            r0, c0 = oy - y0, ox - x0
            if written_x1 is None or c0 >= written_x1:
                out[r0:r0 + h, c0:c0 + w] = arr
            else:
                ov = min(written_x1 - c0, w)  # overlapping column count
                sl = out[r0:r0 + h, c0:c0 + ov]
                src = arr[:, :ov].astype(np.uint32)
                t = sl * (255 - src) + 128
                sl[...] = (src + ((t + (t >> 8)) >> 8)).astype(np.uint8)
                if ov < w:
                    out[r0:r0 + h, c0 + ov:c0 + w] = arr[:, ov:]
            written_x1 = max(written_x1 or 0, c0 + w)
        return out, x0, y0


_COMPOSERS = {}
# guards BOTH registries' get/evict/move-to-end sequences (the bare
# ``del`` dance is not thread-safe under the pipeline's render pool);
# RLock because _measurer_for calls _composer_for
_REG_LOCK = threading.RLock()


def _composer_for(font):
    """Composer keyed by (path, size); only fonts owned by the
    ``_load_font`` cache are eligible (same guard as ``_text_size``) —
    buffer-loaded or customized faces rasterize whole lines directly."""
    path = getattr(font, "path", None)
    if not (isinstance(path, str) and _load_font(path, font.size) is font):
        return None
    key = (path, font.size)
    with _REG_LOCK:
        return _composer_locked(key, font)


def _composer_locked(key, font):
    comp = _COMPOSERS.get(key)
    if comp is None:
        # bound raster memory across font sizes; evict the least-recent
        # half rather than everything (a font-fit descent touches every
        # size in its range — clear-all re-paid every glyph raster
        # forever). Evicted sizes also drop their measurer: a measurer
        # pins its composer via self.comp, so leaving it would both keep
        # the rasters alive AND split state from the draw path's fresh
        # composer.
        if len(_COMPOSERS) > 128:
            for k in list(_COMPOSERS)[:64]:
                del _COMPOSERS[k]
                _MEASURERS.pop(k, None)
        comp = _COMPOSERS[key] = _LineComposer(font)
    else:
        # move-to-end: eviction approximates LRU, so a steadily hot size
        # is not dropped with the cold probe sizes of a font-fit descent
        del _COMPOSERS[key]
        _COMPOSERS[key] = comp
    return comp


class _FastMeasure:
    """Decomposed ``getbbox``-compatible (right, bottom) measurement.

    FreeType shaping per ``getbbox`` call is ~40% of a batch render's
    wall time even after memoization, because captions are distinct. But
    Pillow's line bbox decomposes over glyphs: the pen positions are
    exact 26.6 fixed-point sums of cached advances + pairwise kerns
    (identical to the :class:`_LineComposer` invariant, and only used on
    lines whose pairs pass its ``_pair_safe`` raster check), and each
    glyph contributes

        right_i = (pen26_i + xmax26(ch) + 63) >> 6      (26.6 ceil)

    for a per-(char, size) constant ``xmax26`` — any unit-slope rounding
    Pillow might use (ceil / round / floor-then-add) is the same formula
    under a constant shift, so the constant is LEARNED, not assumed:

      - bootstrap: ``getbbox(ch)`` pins it to a 64-wide interval,
      - every fallback measurement narrows: the observed line right edge
        upper-bounds every glyph's interval, and lower-bounds the unique
        argmax candidate's when there is one,
      - a measurement is emitted from the table ONLY when every glyph's
        interval yields one answer at its pen phase; otherwise the real
        ``getbbox`` runs (and teaches the table).

    ``bottom`` is phase-independent (the x pen never moves glyphs
    vertically), so ``max(bottom(ch))`` over the line is exact from the
    single-char bootstraps. The first :data:`_VALIDATE_N` fast results
    are cross-checked against ``getbbox``; any mismatch permanently
    disables the fast path for this (font, size) — same self-trust
    pattern as ``_pair_safe``.
    """

    _VALIDATE_N = 32
    _PIN_AFTER = 16  # undetermined fallbacks before active pinning starts

    # narrow glyphs used as probe prefixes (their own right edges stay
    # safely left of the probed boundary)
    _ANCHORS = ".,:;'!|iIl1"

    def __init__(self, font, composer):
        self.font = font
        self.comp = composer
        self._lock = composer.lock  # shared: both mutate comp's caches
        self._adv26 = {}
        self._kern26 = {}
        self._xiv = {}   # ch -> [lo, hi] inclusive interval for xmax26
        self._bot = {}   # ch -> bottom (pen y = 0)
        self._validate_left = self._VALIDATE_N
        self._fallbacks = 0
        self._enabled = True
        # word -> (adv26, rmax_lo26, rmax_hi26, bottom, version); the
        # version stamps the interval state the aggregate was built from
        self._wagg = {}
        self._version = 0
        # ch -> (interval, anchor_version) at the last pin attempt that
        # could not finish (hinted faces leave some chars unpinnable —
        # phase-0 anchors only); retrying is futile until the char's own
        # interval changes OR an anchor's interval does (prefix
        # availability depends on anchors via the interference check)
        self._pin_stuck = {}
        self._anchor_version = 0

    def _a26(self, c):
        a = self._adv26.get(c)
        if a is None:
            a = self._adv26[c] = round(self.comp._advance(c) * 64)
        return a

    def _k26(self, a, b):
        k = self._kern26.get((a, b))
        if k is None:
            k = self._kern26[(a, b)] = (
                round(self.font.getlength(a + b) * 64)
                - self._a26(a) - self._a26(b))
        return k

    def _bootstrap(self, c):
        _, _, r, b = self.font.getbbox(c)
        # r = ceil-form of xmax26 at pen 0 -> xmax26 in [64(r-1)+1, 64r]
        self._xiv[c] = [64 * (r - 1) + 1, 64 * r]
        self._bot[c] = b
        if c in self._ANCHORS:
            self._anchor_version += 1

    def _prefixes_for_phase(self, c, phase):
        """Anchor prefixes P making ``c``'s pen in ``P + c`` equal
        ``phase`` (mod 64): 1- then 2-anchor combinations, pair-safe."""
        out = []
        safe = self.comp._pair_safe
        for a in self._ANCHORS:
            if not safe(a, c):
                continue
            if a not in self._xiv:
                self._bootstrap(a)
            p = self._a26(a) + self._k26(a, c)
            if p % 64 == phase:
                out.append((a, (0,)))
        for a in self._ANCHORS:
            for b in self._ANCHORS:
                if not (safe(a, b) and safe(b, c)):
                    continue
                if a not in self._xiv:
                    self._bootstrap(a)
                if b not in self._xiv:
                    self._bootstrap(b)
                pb = self._a26(a) + self._k26(a, b)
                p = pb + self._a26(b) + self._k26(b, c)
                if p % 64 == phase:
                    out.append((a + b, (0, pb)))
        return out

    def _pin(self, c):
        """Binary-search ``xmax26(c)`` to an exact value with crafted
        2-3 glyph probes: a narrow anchor prefix places ``c``'s pen so a
        pixel boundary splits the current interval; the real ``getbbox``
        of the probe string then decides the half. Sound because the
        anchors' own right-edge upper bounds are checked to stay at or
        below the probed boundary."""
        lo, hi = self._xiv[c]
        tries = 0
        orig = (lo, hi)
        if self._pin_stuck.get(c) == (orig, self._anchor_version):
            return
        while lo < hi and tries < 24:
            tries += 1
            m = (lo + hi) // 2  # decide xmax <= m vs >= m+1
            progress = False
            for prefix, anchor_pens in self._prefixes_for_phase(
                    c, (-m) % 64):
                pen_c = 0
                prev = None
                for ch in prefix:
                    if prev is not None:
                        pen_c += self._k26(prev, ch)
                    pen_c += self._a26(ch)
                    prev = ch
                pen_c += self._k26(prefix[-1], c)
                b64 = (pen_c + m) // 64
                # anchor interference: every prefix glyph's right-edge
                # upper bound must stay <= b64
                ok = True
                for ch, p in zip(prefix, anchor_pens):
                    if (p + self._xiv[ch][1] + 63) >> 6 > b64:
                        ok = False
                        break
                if not ok:
                    continue
                _, _, r_obs, _ = self.font.getbbox(prefix + c)
                if r_obs <= b64:
                    hi = m
                else:
                    lo = m + 1
                progress = True
                break
            if not progress:
                break
        self._xiv[c] = [lo, hi]
        if (lo, hi) != orig:
            self._version += 1
            if c in self._ANCHORS:
                self._anchor_version += 1
        if lo < hi:
            self._pin_stuck[c] = ((lo, hi), self._anchor_version)

    def _word_agg(self, word):
        """(total 26.6 advance, max-right interval [lo, hi] in 26.6,
        bottom, version) of a space-free run, cached. The interval
        bounds the true per-word max right edge (max is monotone in each
        char's control-box interval), so the line-level ceil decides
        exactness; aggregates are rebuilt when any interval has narrowed
        since (the version stamp)."""
        agg = self._wagg.get(word)
        if agg is not None and agg[4] == self._version:
            return agg
        pen = 0
        rlo = rhi = -(1 << 60)
        bot = -(1 << 60)
        prev = None
        for ch in word:
            if ch not in self._xiv:
                self._bootstrap(ch)
            lo, hi = self._xiv[ch]
            if prev is not None:
                pen += self._k26(prev, ch)
            if pen + lo > rlo:
                rlo = pen + lo
            if pen + hi > rhi:
                rhi = pen + hi
            b = self._bot[ch]
            if b > bot:
                bot = b
            pen += self._a26(ch)
            prev = ch
        if len(self._wagg) > 1 << 17:  # small tuples; keep the warm half
            for k in list(self._wagg)[:1 << 16]:
                del self._wagg[k]
        agg = (pen, rlo, rhi, bot, self._version)
        self._wagg[word] = agg
        return agg

    def _word_path(self, text):
        """Word-memoized measurement: the line max regroups over
        space-free runs (pens are exact 26.6 ints, so per-word maxima
        translate). Returns None when the interval arithmetic does not
        single-value the line's right edge — the char-wise path then
        decides (or falls back to ``getbbox``)."""
        xiv = self._xiv
        pen = 0
        prev = None
        r_lo = r_hi = -(1 << 60)
        bot = -(1 << 60)
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if ch == " ":
                if ch not in xiv:
                    self._bootstrap(ch)
                if prev is not None:
                    pen += self._k26(prev, ch)
                lo, hi = xiv[ch]
                clo = (pen + lo + 63) >> 6
                chi = (pen + hi + 63) >> 6
                if clo > r_lo:
                    r_lo = clo
                if chi > r_hi:
                    r_hi = chi
                b = self._bot[ch]
                if b > bot:
                    bot = b
                pen += self._a26(ch)
                prev = ch
                i += 1
                continue
            j = i
            while j < n and text[j] != " ":
                j += 1
            word = text[i:j]
            if prev is not None:
                pen += self._k26(prev, word[0])
            adv, rlo, rhi, wbot, _ = self._word_agg(word)
            clo = (pen + rlo + 63) >> 6
            chi = (pen + rhi + 63) >> 6
            if clo > r_lo:
                r_lo = clo
            if chi > r_hi:
                r_hi = chi
            if wbot > bot:
                bot = wbot
            pen += adv
            prev = word[-1]
            i = j
        if r_lo != r_hi:
            return None
        return r_lo, bot

    def measure(self, text):
        """(right, bottom) of ``text``, getbbox-exact."""
        if (not self._enabled or not text
                or not _COMPOSE_SAFE.issuperset(text)):
            _, _, r, b = self.font.getbbox(text)
            return r, b
        with self._lock:
            return self._measure_impl(text)

    def _measure_impl(self, text):
        # pair-safety pre-scan, inlined as dict hits (the method call per
        # pair costs more than the lookup once everything is cached)
        pair_ok = self.comp._pair_ok
        safe = self.comp._pair_safe
        prev_c = text[0]
        for c in text[1:]:
            ok = pair_ok.get((prev_c, c))
            if ok is None:
                ok = safe(prev_c, c)
            if not ok:
                _, _, r, b = self.font.getbbox(text)
                return r, b
            prev_c = c
        if self._validate_left <= 0:
            fast = self._word_path(text)
            if fast is not None:
                return fast
        xiv = self._xiv
        a26 = self._adv26
        k26 = self._kern26
        pens = []
        pen = 0
        prev = None
        for ch in text:
            if ch not in xiv:
                self._bootstrap(ch)
            if prev is not None:
                k = k26.get((prev, ch))
                pen += k if k is not None else self._k26(prev, ch)
            pens.append(pen)
            a = a26.get(ch)
            pen += a if a is not None else self._a26(ch)
            prev = ch

        def bounds():
            r_lo = r_hi = -(1 << 60)
            for ch, p in zip(text, pens):
                lo, hi = xiv[ch]
                clo = (p + lo + 63) >> 6
                chi = (p + hi + 63) >> 6
                if clo > r_lo:
                    r_lo = clo
                if chi > r_hi:
                    r_hi = chi
            return r_lo, r_hi

        r_lo, r_hi = bounds()
        if r_lo != r_hi and self._fallbacks >= self._PIN_AFTER:
            # pin the chars whose uncertainty spans the line max
            for ch, p in zip(text, pens):
                lo, hi = xiv[ch]
                if lo != hi and (p + hi + 63) >> 6 > r_lo:
                    self._pin(ch)
            r_lo, r_hi = bounds()
        if r_lo == r_hi:
            if self._validate_left <= 0:
                return r_lo, max(self._bot[c] for c in text)
            # validation window: fast answer must match the real one
            _, _, r_obs, b_obs = self.font.getbbox(text)
            if (r_lo, max(self._bot[c] for c in text)) != (r_obs, b_obs):
                self._enabled = False
            else:
                self._validate_left -= 1
            return r_obs, b_obs
        self._fallbacks += 1
        _, _, r_obs, b_obs = self.font.getbbox(text)
        # narrow passively: every glyph's right edge <= r_obs
        cands = []
        for ch, p in zip(text, pens):
            iv = xiv[ch]
            new_hi = 64 * r_obs - p
            if new_hi < iv[1]:
                iv[1] = new_hi
                self._version += 1
                if ch in self._ANCHORS:
                    self._anchor_version += 1
            if (p + iv[1] + 63) >> 6 >= r_obs:
                cands.append((ch, p))
        if len(cands) == 1:
            # unique argmax: its right edge is exactly r_obs
            ch, p = cands[0]
            iv = xiv[ch]
            new_lo = 64 * (r_obs - 1) + 1 - p
            if new_lo > iv[0]:
                iv[0] = new_lo
                self._version += 1
                if ch in self._ANCHORS:
                    self._anchor_version += 1
        if any(iv[0] > iv[1] for iv in xiv.values()) or not cands:
            # an emptied interval (or an observation no glyph can reach)
            # contradicts the unit-slope model for this face — stop
            # trusting the table
            self._enabled = False
        return r_obs, b_obs


_MEASURERS = {}


def _measurer_for(font):
    """Measurement learner keyed (path, size); shares the composer's
    advance/kern/pair-safety caches (same eligibility guard)."""
    # one lock span across BOTH lookups: releasing between them would
    # let a concurrent eviction delete the composer we just fetched and
    # bind the new measurer to an orphaned composer (split state —
    # exactly what evicting measurers alongside composers prevents).
    # _REG_LOCK is an RLock, so the nested _composer_for acquire is fine.
    with _REG_LOCK:
        comp = _composer_for(font)
        if comp is None:
            return None
        key = (font.path, font.size)
        return _measurer_locked(key, font, comp)


def _measurer_locked(key, font, comp):
    meas = _MEASURERS.get(key)
    if meas is None:
        # a font-fit descent touches every size in its range, so varied
        # image heights easily exceed a small cap — evict the
        # least-recent half instead of dropping ALL learned tables (a
        # clear-all here re-pays every size's warm-up forever)
        if len(_MEASURERS) > 256:
            for k in list(_MEASURERS)[:128]:
                del _MEASURERS[k]
        meas = _MEASURERS[key] = _FastMeasure(font, comp)
    else:
        del _MEASURERS[key]  # move-to-end (LRU-ish eviction order)
        _MEASURERS[key] = meas
    return meas


def _draw_dilate_bordered(img, xy, line, font, border_size):
    """White text over a black border produced by DILATING the fill mask.

    The fill placement is pixel-identical to ``ImageDraw.text`` (same
    int/fract coordinate split, same subpixel ``start`` into the
    rasterizer — covered by a parity test); the border is a square
    max-filter of that mask instead of FreeType's stroker, which is
    ~3x cheaper and differs from ``stroke_width=`` only by corner
    roundness at the border's edge pixels.
    """
    if not line:
        return
    x, y = xy
    comp = None if not _COMPOSE_SAFE.issuperset(line) else \
        _composer_for(font)
    ink = None
    if comp is not None:
        ink = comp.compose(line, math.modf(x)[0], math.modf(y)[0])
        if ink is None:
            return
        if ink == "unsafe":  # ligature/contextual pair — whole-line path
            ink = None
    if ink is not None:
        arr, dx, dy = ink
        fill_mask = Image.fromarray(arr)
    else:
        mask, (dx, dy) = font.getmask2(
            line, "L", start=(math.modf(x)[0], math.modf(y)[0]))
        w, h = mask.size
        if w == 0 or h == 0:
            return
        raw = bytes(mask)
        arr = np.frombuffer(raw, np.uint8).reshape(h, w)
        fill_mask = Image.frombytes("L", (w, h), raw)
    # fills go through ImageDraw.bitmap, not Image.paste: paste takes
    # raw per-band colors only, while bitmap routes ink through the same
    # conversion as ImageDraw.text — so non-RGB modes (e.g. palette
    # templates) accept the tuple inks exactly like the grid/stroke
    # border modes do (blend is the identical coverage composite)
    draw = ImageDraw.Draw(img)
    if border_size > 0:
        dil = _dilate(arr, border_size)
        draw.bitmap((int(x) + dx - border_size, int(y) + dy - border_size),
                    Image.fromarray(dil), fill=(0, 0, 0))
    draw.bitmap((int(x) + dx, int(y) + dy), fill_mask,
                fill=(255, 255, 255))


def caption_image(img, text_lines, font, pos="top", border="dilate"):
    """Draws text lines with black border + white fill.

    Layout parity: reference caption.py:176-215 — border width is
    ``font.size // 18`` px; bottom block anchored at ``0.987 * height``.

    ``border``:
      - "dilate" (default): white fill placed exactly like
        ``ImageDraw.text``, black border by numpy max-filter dilation of
        the fill mask — ~1.7x the throughput of "stroke" on the
        host-bound render path; corner pixels differ from the FreeType
        stroker's round joins,
      - "stroke": Pillow's native text stroke — one draw call per line,
        ~7x faster than "grid",
      - "grid": the reference's offset-redraw grid, pixel-exact with its
        output.
    """
    draw = ImageDraw.Draw(img)
    _, h = _text_size(text_lines[0], font)

    border_size = font.size // 18

    last_y = -h
    if pos == "bottom":
        last_y = img.height * 0.987 - h * (len(text_lines) + 1) - border_size

    for line in text_lines:
        w, h = _text_size(line, font)
        x = img.width / 2 - w / 2
        y = last_y + h

        if border == "grid":
            for xx in range(-border_size, border_size + 1):
                for yy in range(-border_size, border_size + 1):
                    draw.text((x + xx, y + yy), line, (0, 0, 0), font=font)
            draw.text((x, y), line, (255, 255, 255), font=font)
        elif border == "stroke":
            draw.text((x, y), line, (255, 255, 255), font=font,
                      stroke_width=border_size, stroke_fill=(0, 0, 0))
        else:
            _draw_dilate_bordered(img, (x, y), line, font, border_size)

        last_y = y

    return img


def memeify_image(img, top="", bottom="", font_path=None, border="dilate"):
    """Adds top/bottom captions to a copy of ``img``.

    Parity: reference caption.py:9-38 (``border="grid"`` for pixel-exact
    reference borders; the default dilated border is visually equivalent
    and ~12x faster; ``"stroke"`` keeps Pillow's native stroker).
    """
    img = img.copy()
    font_path = font_path or default_font_path()

    font = _get_initial_font(img, texts=[top, bottom], font_path=font_path)
    top_lines = split_to_lines(img, top, font)
    bottom_lines = split_to_lines(img, bottom, font)
    font = _get_final_font(img, [top_lines, bottom_lines], font_path=font_path)

    img = caption_image(img, top_lines, font, "top", border=border)
    img = caption_image(img, bottom_lines, font, "bottom", border=border)
    return img
