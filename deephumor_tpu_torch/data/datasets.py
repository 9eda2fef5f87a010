"""MemeDataset: the memes900k on-disk format (loading and indexing).

Counterpart of deephumor_tpu/data/datasets.py:

- ``templates.txt``: ``label\\tlink\\turl`` lines; the image file is the
  URL's tail, under ``<root>/images/``;
- ``captions_{split}.txt``: ``label\\tscore\\tcaption`` lines, kept for
  the loaded templates only;
- ``num_classes`` cuts the template list;
- text: lowercase -> tokenize -> UNK for unknown tokens -> EOS appended
  -> ids (the inference path appends no EOS);
- items are ``(label_ids, caption_ids, image)``, the image a float32 NHWC
  numpy array (by default :func:`preprocess_pil`, preloaded once per
  template).

Bulk pre-encoding of a split (the JAX package's ``materialize``) belongs
to training and is not here.
"""

import os

import numpy as np

from deephumor_tpu_torch.data.tokenizers import WordPunctTokenizer
from deephumor_tpu_torch.data.vocab import SPECIAL_TOKENS

__all__ = ["MemeDataset"]


class MemeDataset:
    """Indexable dataset of (label_ids, caption_ids, template_image)."""

    def __init__(self, root, vocab, tokenizer=None, split="train",
                 num_classes=300, image_transform=None, preload_images=True):
        if split not in ("train", "val", "test"):
            raise ValueError(f"incorrect data split: {split}")
        self.root = root
        self.split = split
        self.vocab = vocab
        self.tokenizer = tokenizer or WordPunctTokenizer()
        self.num_classes = num_classes
        if image_transform is None:
            from deephumor_tpu_torch.ops.image_ops import preprocess_pil

            image_transform = preprocess_pil
        self.image_transform = image_transform
        self.preload_images = preload_images
        self._load()

    def _load(self):
        fn_temp = os.path.join(self.root, "templates.txt")
        if not os.path.exists(fn_temp):
            raise FileNotFoundError(f"Templates file {fn_temp} is not found")
        dir_imgs = os.path.join(self.root, "images")
        if not os.path.isdir(dir_imgs):
            raise FileNotFoundError(
                f"Images directory {dir_imgs} is not found")

        self.templates = {}
        self.images = {}
        with open(fn_temp) as f:
            for line in f:
                label, _, url = line.strip().split("\t")
                path = os.path.join(dir_imgs, url.split("/")[-1])
                self.templates[label] = path
                if self.preload_images:
                    self.images[label] = self._load_image(path)
                if len(self.templates) == self.num_classes:
                    break

        fn_capt = os.path.join(self.root, f"captions_{self.split}.txt")
        if not os.path.exists(fn_capt):
            raise FileNotFoundError(f"Captions file {fn_capt} is not found")
        self.captions = []
        with open(fn_capt) as f:
            for line in f:
                label, _, caption = line.strip().split("\t")
                if label in self.templates:
                    self.captions.append((label, caption))

    def _load_image(self, path):
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(self.image_transform(img))

    def _preprocess_text(self, text):
        """lowercase -> tokenize -> UNK -> + EOS -> ids."""
        unk = SPECIAL_TOKENS["UNK"]
        tokens = [tok if tok in self.vocab.stoi else unk
                  for tok in self.tokenizer.tokenize(text.lower())]
        tokens.append(SPECIAL_TOKENS["EOS"])
        return [self.vocab.stoi[tok] for tok in tokens]

    def __getitem__(self, idx):
        label, caption = self.captions[idx]
        image = (self.images[label] if self.preload_images
                 else self._load_image(self.templates[label]))
        return (np.asarray(self._preprocess_text(label), np.int32),
                np.asarray(self._preprocess_text(caption), np.int32),
                image)

    def __len__(self):
        return len(self.captions)
