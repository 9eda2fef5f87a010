"""Acquisition: the memegenerator.net crawler (counterpart of
deephumor_tpu/crawlers, the reference's ``deephumor.crawlers`` names)."""

from deephumor_tpu_torch.crawlers.crawlers import (MemeGeneratorCrawler,
                                                   crawl_template_page,
                                                   crawl_templates)
from deephumor_tpu_torch.crawlers.parsers import (
    parse_template_captions_page, parse_templates_page)
from deephumor_tpu_torch.crawlers.utils import load_image, time_to_str

__all__ = ["MemeGeneratorCrawler", "crawl_templates", "crawl_template_page",
           "parse_templates_page", "parse_template_captions_page",
           "load_image", "time_to_str"]
