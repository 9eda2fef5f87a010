"""Models of the port (inference)."""

from deephumor_tpu_torch.models.caption_models import (
    MODEL_REGISTRY, CaptioningLSTM, CaptioningLSTMWithLabels,
    CaptioningTransformer, CaptioningTransformerBase)

__all__ = ["CaptioningLSTM", "CaptioningLSTMWithLabels",
           "CaptioningTransformerBase", "CaptioningTransformer",
           "MODEL_REGISTRY"]
