"""Data layer: vocabulary and tokenizers (``MemeDataset`` is in
``deephumor_tpu_torch.data.datasets``, which imports torch)."""

from deephumor_tpu_torch.data.tokenizers import (CharTokenizer, Tokenizer,
                                                 WordPunctTokenizer)
from deephumor_tpu_torch.data.vocab import (BOS_ID, EMP_ID, EOS_ID, PAD_ID,
                                            SEP_ID, SPECIAL_TOKENS, UNK_ID,
                                            Vocab, build_vocab,
                                            build_vocab_from_file)

__all__ = ["SPECIAL_TOKENS", "PAD_ID", "UNK_ID", "BOS_ID", "EOS_ID",
           "SEP_ID", "EMP_ID", "Vocab", "build_vocab",
           "build_vocab_from_file", "Tokenizer", "WordPunctTokenizer",
           "CharTokenizer"]
