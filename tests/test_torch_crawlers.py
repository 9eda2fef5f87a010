"""deephumor_tpu_torch's crawler and data CLI against the JAX package's,
offline: the parsers on the canned HTML of tests/test_crawlers.py,
``crawl_dataset`` byte-identical ``templates.txt`` / ``captions.txt``
with one injected fetch (image downloads stubbed in both packages: no
test reaches the network), malformed pages and failed downloads that do
not abort, and the flags of ``crawl_main`` / ``split_main``."""

import pytest

import deephumor_tpu.cli as jax_cli
import deephumor_tpu.crawlers as jax_crawlers_pkg
import deephumor_tpu.crawlers.crawlers as jax_crawlers
import deephumor_tpu.data.splits as jax_splits
import deephumor_tpu_torch.cli as cli
import deephumor_tpu_torch.crawlers as crawlers_pkg
import deephumor_tpu_torch.crawlers.crawlers as crawlers
import deephumor_tpu_torch.data.splits as splits
from deephumor_tpu.crawlers import parsers as jax_parsers
from deephumor_tpu_torch.crawlers import parsers
from test_crawlers import CAPTIONS_HTML, TEMPLATES_HTML, make_fetch

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

MALFORMED = [
    b"<html><body><div class='char-img'><a href='/x'></a></div></body></html>",
    b"""<html><body><h1><a>T</a></h1><div class="char-img"><a>
        <div class="optimized-instance-text0">top</div></a>
        <div class="score">, points</div></div>
        <div class="char-img"><div class="score">7</div></div></body></html>""",
    b"<html><body><h1>no link</h1><p>nothing</p></body></html>",
]


def varied_fetch():
    """Caption pages whose tiles differ from page to page (each page also
    repeats its predecessor's first tile, so that deduplication drops
    some), over the canned template grid."""
    words = ["cat", "dog", "moon", "pizza", "code", "ship", "bug", "night",
             "coffee", "monday", "again", "never", "always", "why"]

    def tile(page, i):
        pick = [words[(page * 7 + i * 3 + j * 5) % len(words)]
                for j in range(4)]
        return (f'<div class="char-img"><a href="/i/{page}/{i}"><div '
                f'class="optimized-instance-text0">{" ".join(pick)} {page}'
                f'</div><div class="optimized-instance-text1">{i} '
                f'{pick[0]}</div></a><div class="score">{page * 10 + i}'
                f'</div></div>')

    def fetch(url):
        page = int(url.rsplit("/", 1)[-1])
        if "/memes/popular/alltime/" in url:
            return TEMPLATES_HTML if page == 1 else b"<html></html>"
        tiles = [tile(page, i) for i in range(3)]
        if page > 1:
            tiles.append(tile(page - 1, 0))
        return ("<html><body><h1><a>T</a></h1>" + "".join(tiles)
                + "</body></html>").encode()

    return fetch


@pytest.fixture
def downloads(monkeypatch):
    """Stubs both packages' image download; records the URLs."""
    urls = []

    def fake(url, save_dir=".", session=None):
        urls.append(url)
        return url.split("/")[-1]

    monkeypatch.setattr(jax_crawlers, "load_image", fake)
    monkeypatch.setattr(crawlers, "load_image", fake)
    return urls


@pytest.mark.parametrize("page", [TEMPLATES_HTML, CAPTIONS_HTML] + MALFORMED)
def test_parsers_match_jax(page):
    assert (parsers.parse_templates_page(page)
            == jax_parsers.parse_templates_page(page))
    assert (parsers.parse_template_captions_page(page)
            == jax_parsers.parse_template_captions_page(page))
    assert parsers._SCORE_PATTERN.pattern == jax_parsers._SCORE_PATTERN.pattern


def test_package_surface_matches_jax():
    assert crawlers_pkg.__all__ == jax_crawlers_pkg.__all__
    assert crawlers_pkg.time_to_str(61.5) == jax_crawlers_pkg.time_to_str(61.5)


def _crawl(module, root, fetch, **kw):
    crawler = module.MemeGeneratorCrawler(poolsize=3, min_len=5, fetch=fetch,
                                          batch_sleep=0, grid_sleep=0, **kw)
    return crawler.crawl_dataset(num_templates=2, num_captions=4,
                                 save_dir=str(root))


@pytest.mark.parametrize("dedup", [False, True])
def test_crawl_dataset_writes_jax_files(tmp_path, downloads, dedup):
    fetch = varied_fetch() if dedup else make_fetch()
    got = _crawl(crawlers, tmp_path / "ours", fetch, detect_duplicates=dedup)
    want = _crawl(jax_crawlers, tmp_path / "theirs", fetch,
                  detect_duplicates=dedup)
    assert got == (2, 8)
    assert got == want
    for name in ("templates.txt", "captions.txt"):
        data = (tmp_path / "ours" / name).read_bytes()
        assert data == (tmp_path / "theirs" / name).read_bytes()
        assert data
    assert sorted(downloads[:len(downloads) // 2]) == sorted(
        downloads[len(downloads) // 2:])


def test_malformed_pages_and_failed_downloads_do_not_abort(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    base = make_fetch()

    def flaky(url):
        if "/images/popular/alltime/page/2" in url:
            return b""  # an empty body: lxml raises in the parser
        return base(url)

    def broken_download(url, save_dir=".", session=None):
        raise OSError("image host down")

    monkeypatch.setattr(crawlers, "load_image", broken_download)
    monkeypatch.setattr(jax_crawlers, "load_image", broken_download)
    got = _crawl(crawlers, tmp_path / "ours", flaky)
    assert got == _crawl(jax_crawlers, tmp_path / "theirs", flaky)
    assert got[0] == 2 and got[1] == 8
    out = capsys.readouterr().out
    assert "caption page failed" in out and "image host down" in out
    assert ((tmp_path / "ours" / "captions.txt").read_bytes()
            == (tmp_path / "theirs" / "captions.txt").read_bytes())


class _Recorder:
    """Stands in for MemeGeneratorCrawler: records its arguments."""

    calls = []

    def __init__(self, **kwargs):
        self.calls.append(("init", kwargs))

    def crawl_dataset(self, **kwargs):
        self.calls.append(("crawl", kwargs))


@pytest.mark.parametrize("argv", [
    ["-d", "memes"],
    ["--save-dir", "m", "-p", "3", "-t", "7", "-c", "50", "--min-len", "4",
     "--max-len", "80", "--max-tokens", "20", "--detect-english",
     "--detect-duplicates"],
])
def test_crawl_main_parses_jax_flags(argv, monkeypatch):
    recorded = []
    for pkg in (jax_crawlers_pkg, crawlers_pkg):
        _Recorder.calls = []
        monkeypatch.setattr(pkg, "MemeGeneratorCrawler", _Recorder)
    for main in (jax_cli.crawl_main, cli.crawl_main):
        _Recorder.calls = []
        main(argv)
        recorded.append(_Recorder.calls)
    assert recorded[0] == recorded[1] and len(recorded[0]) == 2
    for main in (jax_cli.crawl_main, cli.crawl_main):
        with pytest.raises(SystemExit):
            main(argv + ["--source", "elsewhere"])


@pytest.mark.parametrize("argv", [["-d", "memes"],
                                  ["--data-dir", "x", "--splits", "5", "2",
                                   "1", "--random-state", "9"]])
def test_split_main_parses_jax_flags(argv, monkeypatch):
    recorded = []
    for mod in (jax_splits, splits):
        monkeypatch.setattr(mod, "split_captions",
                            lambda *a, **k: recorded.append((a, k)))
    jax_cli.split_main(argv)
    cli.split_main(argv)
    assert len(recorded) == 2 and recorded[0] == recorded[1]
