"""The memegenerator.net dataset crawler.

Counterpart of deephumor_tpu/crawlers/crawlers.py, with its behaviour: it
crawls the all-time-popular template grid, pulls each template's caption
pages, cleans and filters the texts, optionally drops non-English
templates and near-duplicate captions, keeps the ``num_captions`` best by
score, and appends ``templates.txt`` / ``captions.txt`` in the reference's
TSV format (caption text ``top <sep> bottom``, ``<emp>`` for an empty
half).

- HTTP runs on a ``ThreadPoolExecutor``, and every future is read.
- Page fetches retry with exponential backoff.
- The fetch is injectable (``fetch=``), so the whole crawl runs offline
  on canned HTML.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

from deephumor_tpu_torch.crawlers.parsers import (
    parse_template_captions_page, parse_templates_page)
from deephumor_tpu_torch.crawlers.utils import load_image, time_to_str
from deephumor_tpu_torch.data.utils import check_text, clean_text
from deephumor_tpu_torch.data.vocab import SPECIAL_TOKENS

__all__ = ["MemeGeneratorCrawler", "crawl_templates", "crawl_template_page",
           "default_fetch"]

BASE_URL = "https://memegenerator.net"


def default_fetch(url, num_retries=10, backoff=0.5):
    """GET with retries; the content's bytes, or None. Needs
    ``requests``."""
    import requests

    for attempt in range(num_retries):
        try:
            r = requests.get(url, timeout=30)
            if r.status_code == 200:
                return r.content
        except requests.RequestException:
            pass
        if attempt + 1 < num_retries:  # no backoff after the last attempt
            time.sleep(backoff * (2 ** min(attempt, 4)))
    print(f"Failed to load {url}")
    return None


def crawl_templates(page=1, fetch=default_fetch):
    """One page of the all-time template grid, parsed."""
    content = fetch(f"{BASE_URL}/memes/popular/alltime/page/{page}")
    return [] if content is None else parse_templates_page(content)


def crawl_template_page(template_link, page=1, fetch=default_fetch):
    """One captions page of a template: ``(label, memes, link)``, or
    ``(None, None, link)`` when the page could not be fetched."""
    content = fetch(
        f"{BASE_URL}{template_link}/images/popular/alltime/page/{page}")
    if content is None:
        return None, None, template_link
    label, memes = parse_template_captions_page(content)
    return label, memes, template_link


class MemeGeneratorCrawler:
    """Crawls a memes900k-format dataset.

    Args:
        poolsize: concurrent HTTP fetches.
        min_len, max_len, max_tokens: the caption text filters.
        detect_english: drop templates whose text is not mostly English
            (needs ``langdetect``).
        detect_duplicates: drop captions more than 0.9 Levenshtein-similar
            to a kept one (needs ``Levenshtein``), fetching more pages
            until ``num_captions`` remain.
        fetch: ``fetch(url) -> bytes | None``.
        batch_sleep, grid_sleep: pauses (s) between caption-page batches
            and between grid pages, so that a wide pool does not hammer
            the site.
    """

    TEMPLATES_PER_PAGE = 15
    CAPTIONS_PER_PAGE = 15

    def __init__(self, poolsize=8, min_len=10, max_len=96, max_tokens=31,
                 detect_english=False, detect_duplicates=False,
                 fetch=default_fetch, batch_sleep=0.3, grid_sleep=0.5):
        self.poolsize = poolsize
        self.min_len = min_len
        self.max_len = max_len
        self.max_tokens = max_tokens
        self.detect_english = detect_english
        self.detect_duplicates = detect_duplicates
        self.fetch = fetch
        self.batch_sleep = batch_sleep
        self.grid_sleep = grid_sleep

    def _clean_filter(self, memes):
        """``clean_text`` + ``check_text`` over ``(score, top, bottom)``."""
        kept = []
        for score, top, bottom in memes:
            top, bottom = clean_text(top), clean_text(bottom)
            text = f"{top} {bottom}".lower()
            if check_text(text, self.min_len, self.max_len, self.max_tokens):
                kept.append((score, top, bottom))
        return kept

    def _fetch_caption_pages(self, executor, link, pages):
        """Fetches caption pages concurrently; their filtered captions."""
        if self.batch_sleep:
            time.sleep(self.batch_sleep)
        futures = [executor.submit(crawl_template_page, link, p, self.fetch)
                   for p in pages]
        captions = []
        for fut in futures:
            try:
                _, memes, _ = fut.result()
            except Exception as e:  # noqa: BLE001
                # one malformed page (an empty body, odd score text) must
                # not abort a crawl of hours
                print(f"    caption page failed: {e!r}")
                continue
            if memes:
                captions += self._clean_filter(memes)
        return captions

    def _is_english(self, captions):
        import numpy as np

        from deephumor_tpu_torch.data.utils import english_prob

        text = " ".join(f"{t} {b}".lower() for _, t, b in captions)
        if not text.strip():
            return False, 0.0
        prob = float(np.mean([english_prob(text) for _ in range(5)]))
        return prob >= 0.9, prob

    @staticmethod
    def _dedup(captions, seen):
        """The captions whose text is not more than 0.9-similar to any in
        ``seen`` (which gains each kept text)."""
        from Levenshtein import ratio as sim_ratio

        unique = []
        for score, top, bottom in captions:
            text = f"{top} {bottom}".lower()
            if all(sim_ratio(text, other) <= 0.9 for other in seen):
                unique.append((score, top, bottom))
                seen.append(text)
        return unique

    def collect_template_captions(self, executor, link, num_captions,
                                  max_extra_rounds=20):
        """One template's captions, deduplicated when asked: ``(captions,
        eng)``, ``eng`` None without the English gate, else ``(ok,
        prob)``. The gate reads the first batch of pages, before any
        duplicate top-up, so that a non-English template costs no more
        fetches."""
        num_pages = max(1, num_captions // self.CAPTIONS_PER_PAGE)
        num_pages += 10 - num_pages % 10  # the reference's rounding
        captions = self._fetch_caption_pages(executor, link,
                                             range(1, num_pages + 1))

        eng = None
        if self.detect_english:
            eng = self._is_english(captions)
            if not eng[0]:
                return captions, eng
        if not self.detect_duplicates:
            return captions, eng

        seen = []
        unique = self._dedup(captions, seen)
        page, rounds = num_pages, 0
        while len(unique) < num_captions and rounds < max_extra_rounds:
            more = self._fetch_caption_pages(executor, link,
                                             range(page + 1, page + 10))
            if not more:
                break
            unique += self._dedup(more, seen)
            page += 9
            rounds += 1
        return unique, eng

    def crawl_dataset(self, num_templates=300, num_captions=3000,
                      save_dir="memes"):
        """Crawls until ``num_templates`` templates have ``num_captions``
        captions each; appends to ``templates.txt`` and ``captions.txt``
        and downloads the images into ``images/``. Returns ``(templates,
        captions)`` crawled."""
        images_dir = os.path.join(save_dir, "images")
        os.makedirs(images_dir, exist_ok=True)
        start = time.time()
        total_templates = total_captions = 0
        temp_page = 1
        downloads = []

        def progress():
            pct = 100.0 * total_captions / (num_templates * num_captions)
            return f"{time_to_str(time.time() - start)}, {pct:5.2f}%"

        with open(os.path.join(save_dir, "templates.txt"), "a") as tf, \
                open(os.path.join(save_dir, "captions.txt"), "a") as cf, \
                ThreadPoolExecutor(self.poolsize) as executor:
            while total_templates < num_templates:
                if temp_page > 1 and self.grid_sleep:
                    time.sleep(self.grid_sleep)
                templates = crawl_templates(temp_page, self.fetch)
                if not templates:
                    break
                print(f"{progress()}: Crawling page {temp_page} "
                      f"with {len(templates)} templates")

                for temp in templates:
                    label, link, src = (temp["label"], temp["link"],
                                        temp["src"])
                    captions, eng = self.collect_template_captions(
                        executor, link, num_captions)
                    if eng is not None and not eng[0]:
                        print(f"{progress()}:    NON_ENGLISH {label} - "
                              f"{len(captions)} captions "
                              f"(eng:{eng[1]:.3f})")
                        continue
                    if len(captions) < num_captions:
                        print(f"{progress()}:    NOT_ENOUGH {label} - "
                              f"{len(captions)} captions")
                        continue

                    captions = sorted(captions,
                                      key=lambda x: -x[0])[:num_captions]
                    tf.write(f"{label}\t{link}\t{src}\n")
                    downloads.append((src, executor.submit(
                        load_image, src, images_dir)))

                    emp, sep = SPECIAL_TOKENS["EMPTY"], SPECIAL_TOKENS["SEP"]
                    for score, top, bottom in captions:
                        text = f"{top or emp} {sep} {bottom or emp}"
                        cf.write(f"{label}\t{score}\t{text}\n")

                    total_templates += 1
                    total_captions += len(captions)
                    print(f"{progress()}:    {label} - "
                          f"{len(captions)} captions ({total_captions})")
                    if total_templates == num_templates:
                        break
                temp_page += 1

            for src, fut in downloads:
                try:
                    fut.result()
                except Exception as e:  # noqa: BLE001
                    # the captions are written; a missing image is
                    # reported and can be fetched again
                    print(f"    image {src} failed: {e!r}")

        print(f"{time_to_str(time.time() - start)}: Finished: crawled "
              f"{total_templates} templates and {total_captions} captions")
        return total_templates, total_captions
